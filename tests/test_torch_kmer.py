"""The port's device k-mer path vs the JAX package and the host search, bit
for bit, on the CPU (tolerance 0 throughout: integer programs):

  - DeviceKmerTable: the numpy build (a copy of the JAX one) and the torch
    build (how KmerTable.device_table packs a table on its device) give the
    JAX build's planes and probe bound on the bundled yak tables;
  - kmer_lookup's plain twin (which stops at the first empty slot) against
    the JAX lookup (which probes the whole bound) and KmerTable.get's host
    search: present, absent, below-min_count and high-bit queries, and a
    table packed at load 0.78 so that chains run 31 probes long;
  - kmer_min_scores' plain twin against the JAX device_min_kscores_jit and
    the host chain of batch_min_kscores: alleles with Ns, empty alleles,
    alleles shorter than k, and padding;
  - the routing: KmerTable.get and batch_min_kscores through the device
    table on device="cpu", and the slice polished that way; a table over
    the kernels' slots or the card's free memory stays on the host.
The kernels themselves run on a CUDA card only (cuda-marked tests).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextpolish2_tpu.io.yak import load_yak as jax_load_yak
from nextpolish2_tpu.models.oracle_lq import \
    batch_min_kscores as jax_batch_min_kscores
from nextpolish2_tpu.ops import kmer_score as jks
from nextpolish2_tpu.ops import kmer_table as jkt
from nextpolish2_tpu_torch.io.yak import load_yak, rolling_kmers, yak_hash64
from nextpolish2_tpu_torch.models.oracle_lq import batch_min_kscores
from nextpolish2_tpu_torch.ops import consensus_cuda as cc
from nextpolish2_tpu_torch.ops import kmer_score as tks
from nextpolish2_tpu_torch.ops import kmer_table as tkt
from nextpolish2_tpu_torch.utils.seqcodes import seq_to_codes

# one OpenMP thread per test worker: see test_torch_consensus.py
torch.set_num_threads(1)

BASE = "testdata"
YAKS = ("k21.yak", "k31.yak")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _tables(name):
    """(port KmerTable, JAX KmerTable) of one bundled yak file."""
    return load_yak(f"{BASE}/{name}"), jax_load_yak(f"{BASE}/{name}")


def _planes(tab):
    return tuple(_t(np.asarray(p)) for p in (tab.key_hi, tab.key_lo,
                                             tab.counts))


@pytest.mark.parametrize("packing", ["numpy", "torch"])
@pytest.mark.parametrize("name", YAKS)
def test_device_table_build_equals_jax(name, packing):
    port, jax_tab = _tables(name)
    h = port.full_hashes()
    assert np.array_equal(h, jax_tab.full_hashes())
    want = jkt.DeviceKmerTable.build(jax_tab.full_hashes(),
                                     jax_tab.counts.astype(np.int64),
                                     jax_tab.ksize)
    if packing == "numpy":
        got = tkt.DeviceKmerTable.build(h, port.counts.astype(np.int64),
                                        port.ksize)
    else:
        got = tkt.DeviceKmerTable.build_torch(h, port.counts, port.ksize,
                                              "cpu")
    assert (got.size, got.n_probes, got.kmask) == \
        (want.size, want.n_probes, want.kmask)
    for g, w in zip(_planes(got), _planes(want)):
        assert g.dtype == torch.int32
        assert torch.equal(g, w)


@pytest.mark.parametrize("packing", ["numpy", "torch"])
@pytest.mark.parametrize("name", YAKS)
def test_slot_entries_equal_jax_planes(name, packing):
    """The table is one int32 [S, 4] tensor of slot entries {key_hi, key_lo,
    count, 0}: slot by slot the JAX build's three planes and a zero, with
    key_hi, key_lo and counts as views of its columns (what the kernels'
    16-byte probe reads); device_bytes counts 16 B of entry and a byte of
    occupancy a slot, besides BUILD_BYTES_PER_KEY a key."""
    port, jax_tab = _tables(name)
    h = port.full_hashes()
    want = jkt.DeviceKmerTable.build(jax_tab.full_hashes(),
                                     jax_tab.counts.astype(np.int64),
                                     jax_tab.ksize)
    if packing == "numpy":
        got = tkt.DeviceKmerTable.build(h, port.counts.astype(np.int64),
                                        port.ksize)
        entries = torch.from_numpy(got.entries)
    else:
        got = tkt.DeviceKmerTable.build_torch(h, port.counts, port.ksize,
                                              "cpu")
        entries = got.entries
    assert entries.dtype == torch.int32 and entries.is_contiguous()
    assert tuple(entries.shape) == (want.size, 4)
    for col, plane in enumerate((want.key_hi, want.key_lo, want.counts)):
        assert torch.equal(entries[:, col], _t(plane))
    assert not entries[:, 3].any()
    for col, view in enumerate((got.key_hi, got.key_lo, got.counts)):
        view = torch.as_tensor(view)
        assert view.data_ptr() == entries.data_ptr() + 4 * col
        assert view.stride() == (4,)
    if packing == "torch":
        assert tkt.entries_ptr("test", got.key_hi, got.key_lo, got.counts) \
            == entries.data_ptr()
        with pytest.raises(ValueError, match="slot-entry"):
            tkt.entries_ptr("test", got.key_hi.contiguous(), got.key_lo,
                            got.counts)
    n = len(h)
    slots, need = tkt.DeviceKmerTable.device_bytes(n)
    assert slots == want.size
    assert need == entries.nbytes + slots + tkt.BUILD_BYTES_PER_KEY * n


def _queries(port, rng, n=3000):
    """Present hashes, absent ones of the table's width, high-bit hashes
    (bit 63 and bit 31 set, so both planes are negative) and the empty
    sentinel itself."""
    h = port.full_hashes()
    present = rng.choice(h, size=min(n, len(h)), replace=False)
    width = (1 << (2 * port.ksize)) - 1
    absent = np.setdiff1d(rng.integers(0, width, size=n, dtype=np.uint64), h)
    high = rng.integers(0, 1 << 62, size=n // 4, dtype=np.uint64) \
        | np.uint64(1 << 63) | np.uint64(1 << 31)
    sentinel = np.array([0xFFFFFFFFFFFFFFFE], dtype=np.uint64)
    return np.concatenate([present, absent, high, sentinel])


def _jax_lookup(tab, q, min_count, n_probes=None):
    qh, ql, qs = tab.query_host_arrays(q)
    return np.asarray(jkt.lookup_jit(
        jnp.asarray(tab.key_hi), jnp.asarray(tab.key_lo),
        jnp.asarray(tab.counts), jnp.asarray(qh), jnp.asarray(ql),
        jnp.asarray(qs), min_count,
        n_probes=tab.n_probes if n_probes is None else n_probes))


@pytest.mark.parametrize("min_count", [0, 5, 40])
@pytest.mark.parametrize("name", YAKS)
def test_kmer_lookup_twin_equals_jax_and_host(name, min_count):
    port, _ = _tables(name)
    rng = np.random.default_rng(70 + min_count)
    q = _queries(port, rng)
    tab = tkt.DeviceKmerTable.build(port.full_hashes(),
                                    port.counts.astype(np.int64), port.ksize)
    jtab = jkt.DeviceKmerTable(ksize=tab.ksize, size=tab.size,
                               key_hi=tab.key_hi, key_lo=tab.key_lo,
                               counts=tab.counts, kmask=tab.kmask,
                               n_probes=tab.n_probes)
    got = tkt.kmer_lookup(*_planes(tab), *map(_t, tab.query_host_arrays(q)),
                          min_count, tab.n_probes).numpy()
    np.testing.assert_array_equal(got, _jax_lookup(jtab, q, min_count))
    np.testing.assert_array_equal(got, port.get(q, min_count))
    # the cases the test claims: hits, misses, and hits cut by min_count
    counts = port.get(q, 0)
    assert (got > 0).sum() > 100 and (counts == 0).sum() > 1000
    if min_count:
        assert ((counts > 0) & (counts < min_count)).sum() > 10


def test_kmer_lookup_long_chains():
    """A table packed at load 0.78 (chains up to 31 probes long): stopping
    at the first empty slot gives the JAX lookup's counts, which probe the
    table's whole bound and the full MAX_PROBES."""
    from nextpolish2_tpu.io.yak import yak_hash64 as jax_yak_hash64

    rng = np.random.default_rng(71)
    mask = (1 << 42) - 1
    hashes = np.unique(jax_yak_hash64(
        rng.integers(0, mask, size=4000, dtype=np.uint64), mask))[:3200]
    counts = rng.integers(1, 200, size=len(hashes)).astype(np.int64)
    tab = tkt.DeviceKmerTable.build(hashes, counts, 21, load_factor=1.0)
    jtab = jkt.DeviceKmerTable.build(hashes, counts, 21, load_factor=1.0)
    assert tab.size == 4096 and tab.n_probes >= 24   # load 0.78
    absent = np.setdiff1d(rng.integers(0, mask, size=20000,
                                       dtype=np.uint64), hashes)
    q = np.concatenate([hashes, absent])
    planes = _planes(tab)
    qs = tuple(map(_t, tab.query_host_arrays(q)))
    _, probes = tkt.probe_plain(*planes, *qs, tab.n_probes)
    assert int(probes.max()) == tab.n_probes  # some key sits at its bound
    assert float(probes[len(hashes):].float().mean()) < tab.n_probes / 2
    for n_probes in (tab.n_probes, tkt.MAX_PROBES):
        got = tkt.kmer_lookup(*planes, *qs, 0, n_probes).numpy()
        np.testing.assert_array_equal(got, _jax_lookup(jtab, q, 0, n_probes))
        np.testing.assert_array_equal(got[: len(hashes)], counts)


def _alleles(port, rng, n=400):
    """Random alleles of 0..130 bases: with internal Ns and N runs, empty
    ones, ones shorter than k, half of them drawn from k-mers the table
    holds (windows of its full hashes are not invertible, so the present
    ones come from the slice's own sequence)."""
    from nextpolish2_tpu_torch.io.fastx import read_fastx

    ref = next(iter(read_fastx(f"{BASE}/slice.fa")))[1]
    seqs = []
    for i in range(n):
        m = int(rng.integers(0, 131)) if i % 9 else int(rng.integers(0, 3))
        if i % 2:
            at = int(rng.integers(0, len(ref) - m))
            s = bytearray(ref[at : at + m])
        else:
            s = bytearray(rng.choice(list(b"ACGT"), size=m).astype(np.uint8))
        if i % 7 == 0 and m > 30:
            s[m // 2] = ord("N")
        if i % 11 == 0 and m > 40:
            s[10:14] = b"NNNN"
        seqs.append(bytes(s))
    return seqs


@pytest.mark.parametrize("min_count", [0, 5, 40])
@pytest.mark.parametrize("name", YAKS)
def test_kmer_min_scores_twin_equals_jax_and_host(name, min_count):
    port, jax_tab = _tables(name)
    rng = np.random.default_rng(80 + min_count)
    seqs = _alleles(port, rng)
    tab = tkt.DeviceKmerTable.build(port.full_hashes(),
                                    port.counts.astype(np.int64), port.ksize)
    codes, starts = tks.score_inputs(seqs)
    assert len(codes) > sum(len(s) + 1 for s in seqs)   # padded codes
    assert len(starts) > len(seqs) and starts[-1] == len(codes)
    got = tks.kmer_min_scores(*_planes(tab), _t(codes), _t(starts),
                              port.ksize, min_count, tab.n_probes).numpy()
    want = np.asarray(jks.device_min_kscores_jit(
        jnp.asarray(tab.key_hi), jnp.asarray(tab.key_lo),
        jnp.asarray(tab.counts), jnp.asarray(codes), jnp.asarray(starts),
        ksize=port.ksize, table_size=tab.size, min_count=min_count,
        n_seqs=len(starts), n_probes=tab.n_probes))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[len(seqs):], 0)   # padding alleles
    host = batch_min_kscores(seqs, port, min_count)
    np.testing.assert_array_equal(got[: len(seqs)], host)
    np.testing.assert_array_equal(
        host, jax_batch_min_kscores(seqs, jax_tab, min_count))
    # the cases the test claims
    lens = np.array([len(s) for s in seqs])
    assert (lens == 0).any() and ((lens > 0) & (lens < port.ksize)).any()
    assert (host > 0).sum() > 20 and (host == 0).sum() > 20


def test_yak_end_position_hashes_match_host_rolling():
    """The twin's rolling canonical k-mer and hash, per end position, equal
    the host's rolling_kmers + yak_hash64 for k = 21 and 31 (bit 61 set in
    the k = 31 hashes)."""
    rng = np.random.default_rng(90)
    s = bytearray(rng.choice(list(b"ACGT"), size=5000).astype(np.uint8))
    s[100] = ord("N")
    s[2000:2005] = b"NNNNN"
    codes = seq_to_codes(bytes(s))
    for k in (21, 31):
        kmers, valid = rolling_kmers(codes, k)
        want = yak_hash64(kmers, (1 << (2 * k)) - 1)
        v, h = tks.end_position_hashes(_t(codes.astype(np.uint8)), k)
        np.testing.assert_array_equal(v.numpy(), valid)
        np.testing.assert_array_equal(h.numpy()[valid].view(np.uint64),
                                      want[valid])
        if k == 31:
            assert (want[valid] >> np.uint64(61)).any()


def test_device_routes_on_cpu_equal_host(monkeypatch):
    """use_device on device="cpu" with both thresholds at 1: KmerTable.get
    and batch_min_kscores go through the device table (the twins run, not
    the host search) and give the host's answers; device_min_kscores returns
    None where the JAX one does."""
    port, _ = _tables("k21.yak")
    rng = np.random.default_rng(91)
    q = _queries(port, rng, n=500)
    seqs = _alleles(port, rng, n=120)
    host_get = port.get(q, 3)
    host_score = batch_min_kscores(seqs, port, 3)
    monkeypatch.setenv("NP2_KMER_DEVICE_MIN", "1")
    monkeypatch.setenv("NP2_KMER_SCORE_DEVICE_MIN", "1")
    port.use_device = True
    port.device = "cpu"
    before = dict(cc.LAUNCHES)
    np.testing.assert_array_equal(port.get(q, 3), host_get)
    np.testing.assert_array_equal(batch_min_kscores(seqs, port, 3),
                                  host_score)
    ran = {k: cc.LAUNCHES[k] - before.get(k, 0)
           for k in ("kmer_lookup_plain", "kmer_min_scores_plain")}
    assert ran == {"kmer_lookup_plain": 1, "kmer_min_scores_plain": 1}
    assert port.device_table()[1].device.type == "cpu"
    assert tks.device_min_kscores(port, [], 3) is None
    k31 = load_yak(f"{BASE}/k31.yak")
    k31.ksize = 32
    assert tks.device_min_kscores(k31, seqs, 3) is None


def test_kmer_thresholds_route_by_size(monkeypatch):
    """Below NP2_KMER_DEVICE_MIN / NP2_KMER_SCORE_DEVICE_MIN the host route
    runs even with use_device set; at the threshold the device one."""
    port, _ = _tables("k21.yak")
    port.use_device = True
    port.device = "cpu"
    q = port.full_hashes()[:100]
    seqs = [b"ACGT" * 10] * 5   # 200 bases
    monkeypatch.setenv("NP2_KMER_DEVICE_MIN", "101")
    monkeypatch.setenv("NP2_KMER_SCORE_DEVICE_MIN", "201")
    before = dict(cc.LAUNCHES)
    port.get(q)
    batch_min_kscores(seqs, port, 0)
    assert cc.LAUNCHES["kmer_lookup_plain"] == \
        before.get("kmer_lookup_plain", 0)
    assert cc.LAUNCHES["kmer_min_scores_plain"] == \
        before.get("kmer_min_scores_plain", 0)
    monkeypatch.setenv("NP2_KMER_DEVICE_MIN", "100")
    monkeypatch.setenv("NP2_KMER_SCORE_DEVICE_MIN", "200")
    port.get(q)
    batch_min_kscores(seqs, port, 0)
    assert cc.LAUNCHES["kmer_lookup_plain"] == \
        before.get("kmer_lookup_plain", 0) + 1
    assert cc.LAUNCHES["kmer_min_scores_plain"] == \
        before.get("kmer_min_scores_plain", 0) + 1


@pytest.mark.parametrize("limit", ["slots", "memory"])
def test_table_over_the_device_limit_takes_host_route(monkeypatch, limit):
    """use_device set and both thresholds at 1, but the table does not fit
    on its device: more slots than the kernels address, or a build peak
    over half the card's free memory. Both routes stay on the host, exact,
    and nothing is packed."""
    port, _ = _tables("k21.yak")
    rng = np.random.default_rng(93)
    q = _queries(port, rng, n=500)
    seqs = _alleles(port, rng, n=120)
    host_get = port.get(q, 3)
    host_score = batch_min_kscores(seqs, port, 3)
    monkeypatch.setenv("NP2_KMER_DEVICE_MIN", "1")
    monkeypatch.setenv("NP2_KMER_SCORE_DEVICE_MIN", "1")
    port.use_device = True
    if limit == "slots":
        port.device = "cpu"
        monkeypatch.setattr(tkt, "MAX_SLOTS", 1 << 19)  # the table needs 2^20
    else:
        port.device = "cuda"
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "mem_get_info",
                            lambda dev: (2 * 105_431_359, 80 << 30))
        monkeypatch.setattr(torch.cuda, "memory_reserved", lambda dev: 0)
        monkeypatch.setattr(torch.cuda, "memory_allocated", lambda dev: 0)
        assert tkt.DeviceKmerTable.device_bytes(len(port.keys))[1] \
            == 105_431_360
    before = dict(cc.LAUNCHES)
    np.testing.assert_array_equal(port.get(q, 3), host_get)
    np.testing.assert_array_equal(batch_min_kscores(seqs, port, 3),
                                  host_score)
    assert port._device_fits is False and port._device_tab is None
    for k in ("kmer_lookup", "kmer_lookup_plain", "kmer_min_scores",
              "kmer_min_scores_plain"):
        assert cc.LAUNCHES.get(k, 0) == before.get(k, 0), k


def test_slice_polished_through_device_kmer_routes(monkeypatch):
    """The slice with both tables on the device route (device="cpu"), both
    thresholds at 1: byte-identical to slice.golden.fa, and the scorer and
    the lookup ran on the way."""
    from nextpolish2_tpu_torch.config import PolishConfig
    from nextpolish2_tpu_torch.io.bam import BamReader
    from nextpolish2_tpu_torch.io.fastx import read_fastx
    from nextpolish2_tpu_torch.models.oracle import consensus_to_bytes
    from nextpolish2_tpu_torch.pipeline.engine import polish_contig_cuda
    from nextpolish2_tpu_torch.utils import timing

    name, tseq = next(iter(read_fastx(f"{BASE}/slice.fa")))
    tid = [n for n, _ in BamReader(f"{BASE}/slice.bam").references].index(name)
    tables = [load_yak(f"{BASE}/{y}") for y in YAKS]
    for t in tables:
        t.use_device = True
        t.device = "cpu"
    monkeypatch.setenv("NP2_KMER_DEVICE_MIN", "1")
    monkeypatch.setenv("NP2_KMER_SCORE_DEVICE_MIN", "1")
    before = dict(cc.LAUNCHES)
    timing.reset()
    timing.enable(True)
    try:
        cb = polish_contig_cuda(tseq, [], tables,
                                PolishConfig(min_ctg_len=1000), device="cpu",
                                native=(f"{BASE}/slice.bam", tid),
                                fallback=False)
    finally:
        timing.enable(False)
    snap = timing.snapshot()
    timing.reset()
    golden = next(iter(read_fastx(f"{BASE}/slice.golden.fa")))[1]
    assert consensus_to_bytes(cb) == golden
    assert snap.get("kscore_device", 0) > 0, snap
    for k in ("kmer_lookup_plain", "kmer_min_scores_plain"):
        assert cc.LAUNCHES[k] > before.get(k, 0), k


@pytest.mark.cuda
def test_kmer_kernels_match_plain_twins_on_card():
    """On a CUDA card: kmer_lookup and kmer_min_scores against their plain
    twins, bit for bit, on the bundled tables (present, absent, below
    min_count, high-bit queries; alleles with Ns, empty, shorter than k,
    padding)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    for name in YAKS:
        port, _ = _tables(name)
        rng = np.random.default_rng(95)
        port.device = dev
        tab, hi, lo, ct = port.device_table()
        q = [_t(a).to(dev) for a in tab.query_host_arrays(_queries(port, rng))]
        codes, starts = tks.score_inputs(_alleles(port, rng))
        codes, starts = _t(codes).to(dev), _t(starts).to(dev)
        for min_count in (0, 5, 40):
            for n_probes in (tab.n_probes, tkt.MAX_PROBES):
                got = tkt.kmer_lookup(hi, lo, ct, *q, min_count, n_probes)
                want = tkt.kmer_lookup_plain(hi, lo, ct, *q, min_count,
                                             n_probes)
                torch.cuda.synchronize()
                assert torch.equal(got, want)
                got = tks.kmer_min_scores(hi, lo, ct, codes, starts,
                                          port.ksize, min_count, n_probes)
                want = tks.kmer_min_scores_plain(hi, lo, ct, codes, starts,
                                                 port.ksize, min_count,
                                                 n_probes)
                torch.cuda.synchronize()
                assert torch.equal(got, want)


def test_device_table_raises_without_cuda(monkeypatch):
    """A table with use_device and no device asks for the card, and raises
    where there is none (no fall back to the CPU)."""
    port, _ = _tables("k21.yak")
    port.use_device = True
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port.device_table()
    monkeypatch.setenv("NP2_KMER_DEVICE_MIN", "1")
    with pytest.raises(RuntimeError, match="CUDA"):
        port.get(port.full_hashes()[:10])
