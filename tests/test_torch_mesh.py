"""The port's mesh path vs the JAX package, on the CPU (tolerance 0
throughout: integer programs). The JAX side runs on the 8 virtual CPU
devices of conftest.py; the port's mesh repeats torch.device("cpu"), so its
positions run in turn and their kernels' plain twins stand in for the
kernels (kmer_lookup_sharded runs on a card only: the cuda-marked test).

  - ShardedKmerTable: the stacked planes and the probe bound of the JAX
    build, and bridge.carry_sharded_table's round trip;
  - make_sharded_lookup at 4x2 and 1x8 against the JAX function and the host
    search: present, absent, below-min_count and high-bit queries;
  - KmerTable.get under a mesh against the host search, ahead of the device
    route even for a table that does not fit one device;
  - assemble_csr(win_lo, Bl) against row slices of the whole assembly,
    with a full window at a position's last row;
  - dp_backtrack_csr_blob_sharded and dp_backtrack_sparse_packed against
    the JAX functions on m20 and slice chunks at n_win 2 and 4;
  - the batcher under a mesh: the sparse dense-fallback and shape_misalign;
  - the slice under 4x2 (default and dynamic-K) against its golden, and
    m20 at -t 4 under a mesh, 20/20 against its truth;
  - auto_mesh's kmer-axis rule with the card count patched.
"""

import functools
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextpolish2_tpu.config import PolishConfig
from nextpolish2_tpu.io.fastx import read_fastx
from nextpolish2_tpu.io.yak import load_yak as jax_load_yak
from nextpolish2_tpu.models.oracle import build_alignseqs_native_flat
from nextpolish2_tpu.ops import consensus as jc
from nextpolish2_tpu.ops import kmer_table as jkt
from nextpolish2_tpu.parallel import mesh as jm
from nextpolish2_tpu.parallel import sharded_kmer as jsk
from nextpolish2_tpu.pipeline.windows import (aggregate_csr_host,
                                              aggregate_host,
                                              build_window_batch,
                                              pack_csr_blob, split_csr,
                                              split_sparse)
from nextpolish2_tpu.utils.seqcodes import ASCII2CODE
from nextpolish2_tpu_torch import bridge
from nextpolish2_tpu_torch.config import PolishConfig as TPolishConfig
from nextpolish2_tpu_torch.io import yak as tyak
from nextpolish2_tpu_torch.io.bam import BamReader
from nextpolish2_tpu_torch.ops import consensus as tc
from nextpolish2_tpu_torch.ops import consensus_cuda as tk
from nextpolish2_tpu_torch.ops import kmer_table as tkt
from nextpolish2_tpu_torch.parallel import mesh as tm
from nextpolish2_tpu_torch.parallel import sharded_kmer as tsk
from nextpolish2_tpu_torch.pipeline.orchestrator import PolishStats, polish

# one OpenMP thread per test worker: see test_torch_consensus.py
torch.set_num_threads(1)

BASE = "testdata"


def _cpu_mesh(n_win, n_kmer):
    return tm.make_mesh(n_win, n_kmer, devices=["cpu"] * (n_win * n_kmer))


@pytest.fixture
def active_mesh():
    """Sets the port's active mesh for one test; always cleared after."""
    def set_(n_win, n_kmer):
        mesh = _cpu_mesh(n_win, n_kmer)
        tm.set_active_mesh(mesh)
        return mesh

    yield set_
    tm.set_active_mesh(None)


# ---- the sharded k-mer table ------------------------------------------


@functools.lru_cache(maxsize=None)
def _k21():
    return tyak.load_yak(f"{BASE}/k21.yak"), jax_load_yak(f"{BASE}/k21.yak")


def _queries(table, rng, n=4000):
    """Present keys (counts from 1 up, so min_count 5 cuts some), absent
    ones and hashes with bits 31 and 63 set, shuffled."""
    h = table.full_hashes()
    q = np.concatenate([
        rng.choice(h, n // 2),
        rng.integers(0, 1 << 42, n // 4, dtype=np.uint64),
        rng.integers(0, 1 << 62, n // 4, dtype=np.uint64)
        | np.uint64(1 << 63) | np.uint64(1 << 31)])
    rng.shuffle(q)
    return q


@pytest.mark.parametrize("n_shards", [2, 8])
def test_sharded_table_equals_jax_build(n_shards):
    port, jtab = _k21()
    h = port.full_hashes()
    want = jsk.ShardedKmerTable.build(jtab.full_hashes(),
                                      jtab.counts.astype(np.int64), 21,
                                      n_shards)
    got = tsk.ShardedKmerTable.build(h, port.counts.astype(np.int64), 21,
                                     n_shards)
    assert (got.n_shards, got.shard_size) == (want.n_shards, want.shard_size)
    for g, w in ((got.key_hi, want.key_hi), (got.key_lo, want.key_lo),
                 (got.counts, want.counts)):
        assert g.dtype == np.int32 and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    # the probe bound: the longest chain of the JAX package's packing of
    # each shard at the common size
    shard_of = (h >> np.uint64(tsk.SHARD_BITS_SHIFT)) % np.uint64(n_shards)
    bounds = [jkt.DeviceKmerTable._try_pack(
        h[shard_of == s], port.counts[shard_of == s].astype(np.int64),
        want.shard_size)[4] for s in range(n_shards)]
    assert got.n_probes == max(bounds)
    carried = bridge.carry_sharded_table(want)
    np.testing.assert_array_equal(carried.entries, got.entries)
    assert (carried.ksize, carried.n_shards, carried.shard_size) == \
        (21, n_shards, want.shard_size)
    for s, q in zip(got.query_host_arrays(h[:500]),
                    want.query_host_arrays(h[:500])):
        np.testing.assert_array_equal(s, q)


@pytest.mark.parametrize("n_win,n_kmer", [(4, 2), (1, 8)])
def test_sharded_lookup_equals_jax(n_win, n_kmer):
    port, jtab = _k21()
    want_tab = jsk.ShardedKmerTable.build(jtab.full_hashes(),
                                          jtab.counts.astype(np.int64), 21,
                                          n_kmer)
    tab = tsk.ShardedKmerTable.build(port.full_hashes(),
                                     port.counts.astype(np.int64), 21, n_kmer)
    q = _queries(port, np.random.default_rng(n_kmer))
    jmesh = jm.make_mesh(n_win, n_kmer)
    sh = jax.sharding.NamedSharding(jmesh, jax.sharding.PartitionSpec("kmer"))
    planes = [jax.device_put(jnp.asarray(a), sh)
              for a in (want_tab.key_hi, want_tab.key_lo, want_tab.counts)]
    jq = [jnp.asarray(a) for a in want_tab.query_host_arrays(q)]
    mesh = _cpu_mesh(n_win, n_kmer)
    # the bridge's table (no probe bound kept) and the port's own build
    tables = ((tab, tab.n_probes), (bridge.carry_sharded_table(want_tab),
                                    tkt.MAX_PROBES))
    for min_count in (0, 5):
        want = np.asarray(jsk.make_sharded_lookup(
            jmesh, min_count=min_count)(*planes, *jq))
        host = port.get(q, min_count)
        assert (want > 0).sum() > 400 and np.array_equal(want, host)
        for t, n_probes in tables:
            tm.reset_position_counts()
            before = tk.LAUNCHES["kmer_lookup_sharded_plain"]
            fn = tsk.make_sharded_lookup(mesh, min_count=min_count,
                                         n_probes=n_probes)
            got = fn(*t.put(mesh), *(torch.from_numpy(a)
                                     for a in t.query_host_arrays(q)))
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want)
            assert tk.LAUNCHES["kmer_lookup_sharded_plain"] == before + n_kmer
            assert dict(tm.POSITION_RUNS) == {("kmer", s): 1
                                              for s in range(n_kmer)}
    # present keys below min_count 5 were looked up and cut
    assert ((port.get(q, 0) > 0) & (want == 0)).sum() > 100


def test_kmer_get_under_mesh_equals_host(active_mesh, monkeypatch):
    """The mesh branch of KmerTable.get is taken first, from 256 queries,
    even where the device route is forced and the table would not fit one
    device; below 256 queries the other routes answer."""
    port = tyak.load_yak(f"{BASE}/k21.yak")
    q = _queries(port, np.random.default_rng(3), 1500)
    host = {mc: port.get(q, mc) for mc in (0, 5)}
    port.use_device, port.device = True, "cpu"
    monkeypatch.setenv("NP2_KMER_DEVICE_MIN", "1")
    monkeypatch.setattr(tyak.KmerTable, "device_fits", lambda self: False)
    active_mesh(4, 2)
    before = tyak.SHARDED_LOOKUPS
    for mc in (0, 5):
        np.testing.assert_array_equal(port.get(q, mc), host[mc])
    assert tyak.SHARDED_LOOKUPS == before + 2
    np.testing.assert_array_equal(port.get(q[:255], 5), host[5][:255])
    assert tyak.SHARDED_LOOKUPS == before + 2
    assert port._device_tab is None  # the device route never ran


# ---- chunk programs -----------------------------------------------------


@functools.lru_cache(maxsize=None)
def _windows(fa, bam):
    name, tseq = next(iter(read_fastx(f"{BASE}/{fa}")))
    tid = [n for n, _ in BamReader(f"{BASE}/{bam}").references].index(name)
    cfg = PolishConfig(min_ctg_len=1000)
    res = build_alignseqs_native_flat(f"{BASE}/{bam}", tid, tseq, cfg)
    if res is None:
        pytest.skip("native library unavailable")
    al, flat = res
    ref = ASCII2CODE[np.frombuffer(tseq, dtype=np.uint8)]
    return build_window_batch(al, len(tseq), ref, target=cfg.window_len,
                              stream_cache={"flat_all": flat})


@functools.lru_cache(maxsize=None)
def _chunk(src, K, B, W):
    """A real chunk of the first contig of src ("slice" or "m20") built by
    the JAX package's host pipeline: (blob, P, Pd, Pe, dense tables
    (key, cnt, cov, n_slots, overflow), lead, seed, last_col)."""
    wb = _windows(f"{src}.fa", f"{src}.bam")
    lead_all = np.maximum(wb.window_start - 2, 0)
    last_all = (wb.window_start + wb.window_len - 1
                - lead_all).astype(np.int32)
    ids = np.nonzero(last_all < W)[0][:B]
    n = len(ids)
    lead = np.zeros(B, np.int64)
    lead[:n] = lead_all[ids]
    seed = np.zeros(B, bool)
    seed[:n] = wb.window_start[ids] > 0
    last_col = np.zeros(B, np.int32)
    last_col[:n] = last_all[ids]
    csr = aggregate_csr_host(wb, K, width=W, n_windows=B, win_idx=ids)
    blob = pack_csr_blob(*csr[:8], lead, seed, last_col,
                         nibble_ns=jc.nibble_ns_for(B, W, K))
    dense = aggregate_host(wb, K, width=W, n_windows=B, win_idx=ids)
    return (blob, len(csr[1]), len(csr[3]), len(csr[5]), dense, lead, seed,
            last_col)


def _rows_equal(out_t, out_j, last_col, min_ok):
    """Packed outputs equal on every row the JAX XLA DP did not flag for its
    level cap (the port's DP has none)."""
    out_t = out_t.numpy().view(np.uint16)
    ok = ~jc.decode_backtrack_words(out_j, last_col)[5]
    assert ok.sum() >= min_ok
    assert not tc.decode_backtrack_words(out_t, last_col)[5].any()
    np.testing.assert_array_equal(out_t[ok], out_j[ok])


def _synthetic_csr_chunk(B, W, K, seed=7):
    """Dense slot tables with deep slots, deltas and counts past 0xFF,
    every column of row B/2 - 1 full: its last entry sits at the last slot
    of the first half's rows."""
    rng = np.random.default_rng(seed)
    n_slots = rng.integers(0, K + 1, size=(B, W)).astype(np.int32)
    n_slots[B // 2 - 1] = K
    live = np.arange(K)[None, None, :] < n_slots[:, :, None]
    delta = np.where(rng.random((B, W, K)) < 0.3,
                     rng.integers(1, 0x3FF, size=(B, W, K)), 0)
    key = np.where(live, rng.integers(0, 0x8000, size=(B, W, K))
                   | (delta << 16), -1).astype(np.int32)
    cnt = np.where(live, rng.integers(1, 600, size=(B, W, K)),
                   0).astype(np.int32)
    return key, cnt, n_slots


@pytest.mark.parametrize("n_win", [2, 4])
def test_assemble_csr_rows_equal_slices_of_the_whole(n_win):
    B, W, K = 8, 48, 12
    key, cnt, n_slots = _synthetic_csr_chunk(B, W, K)
    parts = [torch.from_numpy(np.ascontiguousarray(a)).to(torch.int32)
             for a in split_csr(key, cnt, n_slots)]
    assert (parts[5] < len(parts[1])).any() and (parts[4] > 0).any()
    whole = tc.assemble_csr(*parts, B, W, K)
    np.testing.assert_array_equal(whole[0].numpy(), key)
    Bl = B // n_win
    for lo in range(0, B, Bl):
        rows = tc.assemble_csr(*parts, B, W, K, win_lo=lo, Bl=Bl)
        for r, w in zip(rows, whole):
            assert r.shape[0] == Bl
            np.testing.assert_array_equal(r.numpy(), w[lo:lo + Bl].numpy())
    # a real slice chunk, deltas and exceptions across the positions
    blob, P, Pd, Pe, *_ = _chunk("slice", 48, 16, 1280)
    parsed = tc.parse_csr_blob(torch.from_numpy(blob), 16, 1280, 48, P, Pd,
                               Pe)
    whole = tc.assemble_csr(*parsed[:8], 16, 1280, 48)
    Bl = 16 // n_win
    for lo in range(0, 16, Bl):
        rows = tc.assemble_csr(*parsed[:8], 16, 1280, 48, win_lo=lo, Bl=Bl)
        for r, w in zip(rows, whole):
            np.testing.assert_array_equal(r.numpy(), w[lo:lo + Bl].numpy())


@functools.lru_cache(maxsize=None)
def _jax_outputs(src, K, B, W, n_win):
    blob, P, Pd, Pe, dense, lead, seed, last_col = _chunk(src, K, B, W)
    jmesh = jm.make_mesh(n_win, 1, devices=jax.devices()[:n_win])
    blob_out = np.asarray(jc.dp_backtrack_csr_blob_sharded(
        jnp.asarray(blob), jmesh, B=B, W=W, K=K, P=P, Pd=Pd, Pe=Pe,
        max_steps=W + 128, use_pallas=False))
    key, cnt, cov, n_slots, over = dense
    sparse = split_sparse(key, cnt, n_slots, 4)
    sparse_out = np.asarray(jc.dp_backtrack_sparse_packed(
        jnp.asarray(sparse[0]), jnp.asarray(sparse[1].astype(np.uint16)),
        jnp.asarray(cov.astype(np.uint16)), jnp.asarray(over),
        *(jnp.asarray(a) for a in sparse[2:]), jnp.asarray(lead),
        jnp.asarray(seed), jnp.asarray(last_col), K=K, max_steps=W + 128,
        use_pallas=False))
    return blob_out, sparse, sparse_out


@pytest.mark.parametrize("n_win", [2, 4])
@pytest.mark.parametrize("src,K,B,W", [("slice", 48, 16, 1280),
                                       ("m20", 8, 16, 1280)])
def test_sharded_chunk_programs_equal_jax(src, K, B, W, n_win):
    blob, P, Pd, Pe, dense, lead, seed, last_col = _chunk(src, K, B, W)
    blob_out, sparse, sparse_out = _jax_outputs(src, K, B, W, n_win)
    mesh = _cpu_mesh(n_win, 1)
    tm.reset_position_counts()
    got = tc.dp_backtrack_csr_blob_sharded(blob, mesh, B=B, W=W, K=K, P=P,
                                           Pd=Pd, Pe=Pe, max_steps=W + 128)
    assert got.dtype == torch.int16 and got.shape == (B, W + 128 + 8)
    _rows_equal(got, blob_out, last_col, B // 2)
    _key, _cnt, cov, _ns, _over = dense
    eb = sparse[2]
    if K > 8:  # deep columns: exceptions in several positions
        assert len({int(b) // (B // n_win) for b in eb[eb < B]}) > 1
    got = tc.dp_backtrack_sparse_packed(
        sparse[0], sparse[1].astype(np.uint16), cov.astype(np.uint16),
        *sparse[2:], lead, seed, last_col, K=K, max_steps=W + 128,
        mesh=mesh)
    _rows_equal(got, sparse_out, last_col, B // 2)
    assert dict(tm.POSITION_RUNS) == {("win", i): 2 for i in range(n_win)}


# ---- the batcher, the engine and the orchestrator under a mesh ---------


def _batcher_rows(wb, ids, W, K, with_csr):
    """The rows of `ids` through a DeviceBatcher on the CPU (its stats and
    per-window results)."""
    from nextpolish2_tpu_torch.pipeline.batcher import DeviceBatcher
    from nextpolish2_tpu_torch.pipeline.engine import window_anchors
    from nextpolish2_tpu_torch.pipeline.windows import (aggregate_csr_parts,
                                                        aggregate_host as
                                                        t_aggregate_host)

    lead, seed, last = window_anchors(wb)
    b = DeviceBatcher("cpu")
    try:
        futs = []
        for c0 in range(0, len(ids), 32):
            sub = ids[c0:c0 + 32]
            futs.append(b.submit(
                (W, K), len(sub),
                lambda sub=sub: t_aggregate_host(wb, K, width=W,
                                                 n_windows=len(sub),
                                                 win_idx=sub),
                lead[sub], seed[sub], last[sub],
                aggregate_csr=(lambda lo, hi, sub=sub: aggregate_csr_parts(
                    wb, K, width=W, n_windows=hi - lo, win_idx=sub[lo:hi]))
                if with_csr else None))
        rows = [w for f in futs for w in f.result(timeout=300)]
    finally:
        b.shutdown()
    return b.stats, rows


def _port_windows(src):
    from nextpolish2_tpu_torch.models.oracle import \
        build_alignseqs_native_flat as t_ingest
    from nextpolish2_tpu_torch.pipeline.engine import window_anchors
    from nextpolish2_tpu_torch.pipeline.windows import \
        build_window_batch as t_build

    name, tseq = next(iter(read_fastx(f"{BASE}/{src}.fa")))
    tid = [n for n, _ in BamReader(f"{BASE}/{src}.bam").references].index(name)
    res = t_ingest(f"{BASE}/{src}.bam", tid, tseq, TPolishConfig())
    if res is None:
        pytest.skip("native library unavailable")
    wb = t_build(res[0], len(tseq),
                 ASCII2CODE[np.frombuffer(tseq, dtype=np.uint8)],
                 target=1024, stream_cache={"flat_all": res[1]})
    span = window_anchors(wb)[2] + 1
    return wb, np.nonzero(span <= 1280)[0]


def test_batcher_under_mesh_sparse_fallback_and_misalign(active_mesh):
    """Batches without a CSR closure take the sparse format sharded over
    the mesh; under a 'win' axis of 3, which divides no batch, every batch
    goes dense on one device (shape_misalign). Every row equals the
    one-device CSR run's."""
    wb, ids = _port_windows("m20")
    ids = ids[:40]
    _, want = _batcher_rows(wb, ids, 1280, 8, True)
    for (n_win, n_kmer), with_csr, reason in (((4, 2), False,
                                               "no_csr_closure"),
                                              ((3, 1), True,
                                               "shape_misalign")):
        active_mesh(n_win, n_kmer)
        tm.reset_position_counts()
        stats, rows = _batcher_rows(wb, ids, 1280, 8, with_csr)
        assert stats.batches > 0 and stats.csr_batches == 0
        assert stats.dense_reasons == {reason: stats.batches}
        runs = {k: v for k, v in tm.POSITION_RUNS.items() if k[0] == "win"}
        if reason == "shape_misalign":
            assert runs == {}
        else:
            assert runs == {("win", i): stats.batches for i in range(n_win)}
        for a, b in zip(rows, want):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)


def _polish(fa, bam, yaks, truth, **kw):
    stats = PolishStats()
    sink = io.BytesIO()
    polish(f"{BASE}/{fa}", f"{BASE}/{bam}", [f"{BASE}/{y}" for y in yaks],
           TPolishConfig(min_ctg_len=1000, threads=kw.pop("threads", 1)),
           out=sink, stats=stats, device="cpu", **kw)
    got = [ln for ln in sink.getvalue().splitlines()
           if not ln.startswith(b">")]
    want = [s for _, s in read_fastx(f"{BASE}/{truth}")]
    assert len(got) == len(want)
    return sum(g == w for g, w in zip(got, want)), stats


@pytest.mark.parametrize("dp_variant", [None, "dynk"])
def test_slice_under_4x2_mesh_equals_golden(active_mesh, dp_variant):
    active_mesh(4, 2)
    tm.reset_position_counts()
    tk.reset_counts()
    before = tyak.SHARDED_LOOKUPS
    same, _ = _polish("slice.fa", "slice.bam", ["k21.yak", "k31.yak"],
                      "slice.golden.fa", dp_variant=dp_variant)
    assert same == 1
    assert tyak.SHARDED_LOOKUPS > before
    runs = dict(tm.POSITION_RUNS)
    assert all(runs.get(("win", i), 0) > 0 for i in range(4))
    assert all(runs.get(("kmer", s), 0) > 0 for s in range(2))
    dp = "consensus_dp_dynk_plain" if dp_variant else "consensus_dp_plain"
    assert tk.LAUNCHES[dp] == runs[("win", 0)] * 4


def test_m20_t4_under_mesh_equals_truth(active_mesh):
    active_mesh(2, 2)
    tm.reset_position_counts()
    same, stats = _polish("m20.fa", "m20.bam", ["m20.k21.yak"],
                          "m20.truth.fa", threads=4)
    assert same == 20
    assert stats.batches > 0 and stats.csr_batches == stats.batches
    assert tm.POSITION_RUNS[("win", 0)] == tm.POSITION_RUNS[("win", 1)] > 0


def test_auto_mesh_kmer_axis_heuristic(monkeypatch):
    """auto_mesh turns the kmer axis on exactly when the replicated tables
    exceed the per-card budget (the JAX package's rule, test_mesh.py),
    over the cards torch.cuda.device_count() reports; one card: no mesh."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    monkeypatch.setenv("NP2_KMER_DEVICE_BUDGET_GB", "0.001")  # 1 MB
    m = tm.auto_mesh(yak_bytes=8 << 20)
    assert tm.axis_size(m, "kmer") == 8 and tm.axis_size(m, "win") == 1
    m = tm.auto_mesh(yak_bytes=3 << 19)
    assert tm.axis_size(m, "kmer") == 2 and tm.axis_size(m, "win") == 4
    assert [str(d) for d in tm.axis_devices(m, "win")] == \
        ["cuda:0", "cuda:2", "cuda:4", "cuda:6"]
    monkeypatch.setenv("NP2_KMER_DEVICE_BUDGET_GB", "8")
    m = tm.auto_mesh(yak_bytes=8 << 20)
    assert tm.axis_size(m, "kmer") == 1 and tm.axis_size(m, "win") == 8
    assert tm.axis_size(tm.auto_mesh(), "kmer") == 1
    # no budget set: half of card 0's free memory
    monkeypatch.delenv("NP2_KMER_DEVICE_BUDGET_GB")
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda dev=None: (4 << 20, 80 << 30))
    m = tm.auto_mesh(yak_bytes=3 << 20)    # 3.75 MB against 2 MB a card
    assert tm.axis_size(m, "kmer") == 2
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert tm.auto_mesh(yak_bytes=1 << 40) is None


def test_mesh_helpers():
    mesh = _cpu_mesh(4, 2)
    assert mesh.shape == {"win": 4, "kmer": 2}
    assert tm.win_rows(mesh, 16) == [(0, 4), (4, 8), (8, 12), (12, 16)]
    with pytest.raises(ValueError, match="does not split"):
        tm.win_rows(mesh, 18)
    with pytest.raises(AssertionError):
        tm.make_mesh(3, 2, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="unknown mesh axis"):
        tm.axis_devices(mesh, "batch")
    assert tm.axis_size(None, "win") == 1 and tm.axis_size(mesh, "x") == 1


@pytest.mark.cuda
def test_sharded_lookup_kernel_matches_twin_on_card():
    """On a CUDA card: kmer_lookup_sharded against its plain twin on every
    shard of the k21 table at 2 and 4 shards, bit for bit, and a 4x2 mesh
    of the one card through KmerTable.get against the host search."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    dev = torch.device("cuda")
    port, _ = _k21()
    q = _queries(port, np.random.default_rng(9))
    for n_shards in (2, 4):
        tab = tsk.ShardedKmerTable.build(port.full_hashes(),
                                         port.counts.astype(np.int64), 21,
                                         n_shards)
        mesh = tm.make_mesh(1, n_shards, devices=[dev] * n_shards)
        planes = tab.put(mesh)
        qd = [torch.from_numpy(a).to(dev) for a in tab.query_host_arrays(q)]
        for s in range(n_shards):
            for min_count in (0, 5):
                got = tkt.kmer_lookup_sharded(planes[0][s], planes[1][s],
                                              planes[2][s], *qd, s, min_count,
                                              tab.n_probes)
                want = tkt.kmer_lookup_sharded_plain(
                    planes[0][s], planes[1][s], planes[2][s], *qd, s,
                    min_count, tab.n_probes)
                torch.cuda.synchronize()
                assert torch.equal(got, want)
    host = port.get(q, 5)
    tm.set_active_mesh(tm.make_mesh(4, 2, devices=[dev] * 8))
    try:
        np.testing.assert_array_equal(port.get(q, 5), host)
    finally:
        tm.set_active_mesh(None)
