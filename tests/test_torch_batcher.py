"""The port's cross-contig batcher (pipeline/batcher.py) on the CPU: batched
polish against the unbatched engine and against the JAX package's
polish_contig_tpu, the small-tier tail flush, error propagation, CSR-direct
batches, the dense fallback with its reasons, and polish(threads=N) against
threads=1. Batch COMPOSITION depends on timing; the only counts asserted are
the ones tests/test_batcher.py asserts, under the same long grace.
"""

import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from nextpolish2_tpu.config import PolishConfig
from nextpolish2_tpu.models.oracle import consensus_to_bytes as j_to_bytes
from nextpolish2_tpu.pipeline.engine import polish_contig_tpu
from nextpolish2_tpu_torch.config import PolishConfig as TPolishConfig
from nextpolish2_tpu_torch.io.bam import BamRecord as TBamRecord
from nextpolish2_tpu_torch.io.bam import BamWriter
from nextpolish2_tpu_torch.io.yak import count_kmers, write_yak
from nextpolish2_tpu_torch.models.oracle import consensus_to_bytes
from nextpolish2_tpu_torch.ops import consensus_cuda as tk
from nextpolish2_tpu_torch.pipeline import engine as te
from nextpolish2_tpu_torch.pipeline.batcher import (LANE_SMALL, DeviceBatcher,
                                                    _Request,
                                                    get_active_batcher,
                                                    set_active_batcher)
from nextpolish2_tpu_torch.pipeline.engine import polish_contig_cuda
from nextpolish2_tpu_torch.pipeline.orchestrator import PolishStats, polish
from nextpolish2_tpu_torch.utils.torchcfg import bucket

from test_batcher import make_case, rand_seq
from test_torch_engine import _carry, _port_records

# one OpenMP thread per test worker: see test_torch_consensus.py
torch.set_num_threads(1)

CPU = torch.device("cpu")


def _cfg():
    return PolishConfig(min_ctg_len=0, min_read_len=100, min_map_len=50,
                        min_map_fra=0.5, window_len=512)


def _port_cases(rng, tmp_path, n):
    """n synthetic contigs of the JAX batcher tests: (the JAX package's
    inputs, the same inputs carried into the port)."""
    cfg = _cfg()
    cases = [make_case(rng, tmp_path, i) for i in range(n)]
    ported = []
    for t, reads, table in cases:
        tcfg, (ttable,) = _carry(cfg, [table])
        ported.append((t, _port_records(reads), ttable, tcfg))
    return cfg, cases, ported


def _polish_batched(ported, batcher):
    assert get_active_batcher() is None
    set_active_batcher(batcher)
    try:
        with ThreadPoolExecutor(max_workers=len(ported)) as ex:
            return list(ex.map(
                lambda c: consensus_to_bytes(polish_contig_cuda(
                    c[0], c[1], [c[2]], c[3], device="cpu", fallback=False)),
                ported))
    finally:
        set_active_batcher(None)
        batcher.shutdown()


def test_batched_polish_matches_unbatched_and_jax(tmp_path):
    """4 contigs polished concurrently through one DeviceBatcher: the bytes
    of the port's per-contig engine and of the JAX package's
    polish_contig_tpu, in shared device batches."""
    cfg, cases, ported = _port_cases(np.random.default_rng(77), tmp_path, 4)
    base = [consensus_to_bytes(polish_contig_cuda(
        t, rd, [tb], tcfg, device="cpu", fallback=False))
        for t, rd, tb, tcfg in ported]
    jax_out = [j_to_bytes(polish_contig_tpu(t, rd, [tb], cfg, fallback=False))
               for t, rd, tb in cases]
    assert base == jax_out
    b = DeviceBatcher(CPU, idle_flush_s=1.0)  # long grace: all contigs pack
    outs = _polish_batched(ported, b)
    assert outs == base
    # ~8 windows/contig over >=1 DP iterations: cross-contig packing must
    # beat one dispatch per contig per iteration
    assert b.stats.batches < 4, f"no packing: {b.stats.batches} batches"
    assert b.stats.lanes_real <= b.stats.lanes_dispatched
    assert not b._worker.is_alive()


def _empty_agg(n, width, K):
    def agg():
        return (np.full((n, width, K), -1, dtype=np.int32),
                np.zeros((n, width, K), dtype=np.int32),
                np.zeros((n, width), dtype=np.int32),
                np.zeros((n, width), dtype=np.int32),
                np.zeros(n, dtype=bool))
    return agg


def test_small_tail_uses_small_tier():
    """A <=16-lane flush dispatches at the small-B tier (bounded padding)."""
    width, K, n = bucket(512 + 256, 128), 16, 3
    b = DeviceBatcher(CPU, idle_flush_s=0.01)
    try:
        fut = b.submit(width, n, _empty_agg(n, width, K),
                       np.zeros(n, dtype=np.int64), np.zeros(n, dtype=bool),
                       np.zeros(n, dtype=np.int32))
        out = fut.result(timeout=120)
    finally:
        b.shutdown()
    assert len(out) == n
    for cols_r, packed_r, qv_r, best, trunc, lvl, ovf in out:
        assert not trunc and not lvl and not ovf
    assert b.stats.lanes_dispatched == LANE_SMALL
    assert b.stats.batches == 1


def test_batcher_error_propagates():
    """An aggregation closure that raises must fail the submitting future,
    and later submissions must be refused."""
    def bad_agg():
        raise ValueError("boom")

    b = DeviceBatcher(CPU, idle_flush_s=0.01)
    try:
        fut = b.submit(768, 2, bad_agg, np.zeros(2, dtype=np.int64),
                       np.zeros(2, dtype=bool), np.zeros(2, dtype=np.int32))
        with pytest.raises(ValueError, match="boom"):
            fut.result(timeout=60)
        b._worker.join(timeout=60)
        assert not b._worker.is_alive()
        with pytest.raises(RuntimeError, match="worker died"):
            b.submit(768, 2, bad_agg, np.zeros(2, dtype=np.int64),
                     np.zeros(2, dtype=bool), np.zeros(2, dtype=np.int32))
    finally:
        b.shutdown()


@pytest.mark.parametrize("dp_variant", ["v2", "base", "dynk"])
def test_batched_polish_uses_csr_direct(tmp_path, dp_variant):
    """With the native library available, every cross-contig batch is
    aggregated CSR-direct (no dense [B, W, K] host tables) and rides the
    blob, under the blob route's formulation, byte-identical."""
    from nextpolish2_tpu_torch.io.native import available

    if not available():
        pytest.skip("native library unavailable")
    _cfg_, _cases, ported = _port_cases(np.random.default_rng(79), tmp_path, 3)
    base = [consensus_to_bytes(polish_contig_cuda(
        t, rd, [tb], tcfg, device="cpu", fallback=False))
        for t, rd, tb, tcfg in ported]
    variants = te.resolve_dp_variants(dp_variant)
    before = dict(tk.LAUNCHES)
    b = DeviceBatcher(CPU, variants, idle_flush_s=1.0)
    outs = _polish_batched(ported, b)
    assert outs == base
    assert b.stats.batches > 0
    assert b.stats.csr_batches == b.stats.batches, \
        f"{b.stats.csr_batches}/{b.stats.batches} batches were CSR-direct"
    assert b.stats.dense_reasons == {}
    ran = {k: tk.LAUNCHES[k] - before.get(k, 0) for k in tk.LAUNCHES}
    twin = {"v2": "consensus_dp_plain", "base": "consensus_dp_base_plain"}[
        variants.blob]
    assert ran[twin] == b.stats.batches
    assert ran.get("consensus_dp_dynk_plain", 0) == 0


def test_dense_fallback_reason_accounting():
    """A request without a CSR closure is aggregated dense and the batcher
    records WHY."""
    b = DeviceBatcher(CPU, idle_flush_s=1.0)
    try:
        width, K, n = 256, 8, 4
        agg = _empty_agg(n, width, K)

        def request(aggregate_csr):
            return _Request(n=n, aggregate=agg, lead=np.zeros(n, np.int64),
                            seed=np.zeros(n, bool),
                            last=np.full(n, width - 1, np.int32),
                            aggregate_csr=aggregate_csr)

        kind, *_ = b._aggregate((width, K), [(request(None), 0, n)])
        assert kind == "dense"
        assert b.stats.dense_reasons == {"no_csr_closure": 1}
        # the native pass bailed
        kind, *_ = b._aggregate((width, K),
                                [(request(lambda lo, hi: None), 0, n)])
        assert kind == "dense"
        assert b.stats.dense_reasons == {"no_csr_closure": 1, "csr_bailed": 1}
    finally:
        b.shutdown()


def _slice_requests():
    """The slice's windows as the engine would hand them to a batcher, one
    (tier, ids, dense closure, CSR closure, anchors) per K tier."""
    from nextpolish2_tpu_torch.io.fastx import read_fastx
    from nextpolish2_tpu_torch.models.oracle import build_alignseqs_native_flat
    from nextpolish2_tpu_torch.pipeline.windows import (aggregate_csr_parts,
                                                        aggregate_host,
                                                        build_window_batch)
    from nextpolish2_tpu_torch.utils.seqcodes import ASCII2CODE

    tseq = next(iter(read_fastx("testdata/slice.fa")))[1]
    cfg = TPolishConfig(min_ctg_len=1000)
    res = build_alignseqs_native_flat("testdata/slice.bam", 0, tseq, cfg)
    if res is None:
        pytest.skip("native library unavailable")
    wb = build_window_batch(res[0], len(tseq),
                            ASCII2CODE[np.frombuffer(tseq, dtype=np.uint8)],
                            target=cfg.window_len,
                            stream_cache={"flat_all": res[1]})
    lead, seed, last = te.window_anchors(wb)
    ktier = te.window_ktiers(wb, len(tseq), cfg.max_kmers_per_col)
    width = 1280
    reqs = []
    for kt in sorted(set(ktier.tolist())):
        ids = np.nonzero((ktier == kt) & (last < width))[0]
        reqs.append((
            (width, int(kt)), ids,
            lambda ids=ids, kt=kt: aggregate_host(
                wb, kt, width=width, n_windows=len(ids), win_idx=ids),
            lambda lo, hi, ids=ids, kt=kt: aggregate_csr_parts(
                wb, kt, width=width, n_windows=hi - lo, win_idx=ids[lo:hi]),
            (lead[ids], seed[ids], last[ids])))
    return reqs


@pytest.mark.parametrize("dp_variant", ["v2", "dynk"])
def test_dense_fallback_batch_equals_csr_batch(dp_variant):
    """Real windows submitted WITHOUT a CSR closure take the dense format
    (split into the blob under v2, shipped whole to the dynamic-K twin under
    dynk) and give the rows of the CSR-direct batch."""
    reqs = _slice_requests()[:1]  # the K=8 tier
    rows = {}
    for with_csr in (True, False):
        before = dict(tk.LAUNCHES)
        b = DeviceBatcher(CPU, te.resolve_dp_variants(dp_variant),
                          idle_flush_s=0.01)
        try:
            futs = [b.submit(tier, len(ids), agg, *anchors,
                             aggregate_csr=agg_csr if with_csr else None)
                    for tier, ids, agg, agg_csr, anchors in reqs]
            rows[with_csr] = [f.result(timeout=300) for f in futs]
        finally:
            b.shutdown()
        ran = {k: tk.LAUNCHES[k] - before.get(k, 0) for k in tk.LAUNCHES}
        if with_csr:
            assert b.stats.csr_batches == b.stats.batches > 0
            assert ran["consensus_dp_plain"] == b.stats.batches
        else:
            assert b.stats.csr_batches == 0
            assert b.stats.dense_reasons == {
                "no_csr_closure": b.stats.batches}
            twin = ("consensus_dp_dynk_plain" if dp_variant == "dynk"
                    else "consensus_dp_plain")
            assert ran[twin] == b.stats.batches
    for fa, fb in zip(rows[True], rows[False]):
        assert len(fa) == len(fb) > 0
        for wa, wb_ in zip(fa, fb):
            for xa, xb in zip(wa, wb_):
                np.testing.assert_array_equal(xa, xb)


def _four_contig_inputs(tmp_path, rng):
    """A 4-contig assembly with one planted error each, its reads as a BAM,
    and a k21 table, written with the port's own writers."""
    truths = [rand_seq(rng, n) for n in (3000, 2600, 3400, 2800)]
    asms = []
    for t in truths:
        a = bytearray(t)
        a[len(t) // 2] = ord("A") if t[len(t) // 2] != ord("A") else ord("C")
        asms.append(bytes(a))
    fa = tmp_path / "asm.fa"
    with open(fa, "wb") as f:
        for i, a in enumerate(asms):
            f.write(b">c%d\n" % i + a + b"\n")
    bam = tmp_path / "r.bam"
    with BamWriter(str(bam), [(f"c{i}", len(a))
                              for i, a in enumerate(asms)]) as w:
        for tid, t in enumerate(truths):
            for s in range(0, len(t) - 800, 300):
                w.write(TBamRecord(qname=f"r{tid}_{s}".encode(), flag=0,
                                   tid=tid, pos=s, mapq=60,
                                   cigar=[(0, 800)], seq=t[s : s + 800]))
    h, c = count_kmers(truths * 6, 21)
    yak = tmp_path / "t.yak"
    write_yak(str(yak), 21, h, c)
    return str(fa), str(bam), str(yak), truths


def test_polish_threads_equals_single_thread(tmp_path):
    """polish(threads=4) through the batcher: the bytes and the order of
    threads=1, with the planted errors fixed."""
    fa, bam, yak, truths = _four_contig_inputs(tmp_path,
                                               np.random.default_rng(83))
    kw = dict(min_ctg_len=0, min_read_len=100, min_map_len=50, window_len=512)
    one = polish(fa, bam, [yak], TPolishConfig(**kw), engine="cuda",
                 device="cpu")
    stats = PolishStats()
    four = polish(fa, bam, [yak], TPolishConfig(threads=4, **kw),
                  engine="cuda", device="cpu", stats=stats)
    assert [p.name for p in four] == [f"c{i}" for i in range(4)]
    assert [(p.name, p.seq) for p in four] == [(p.name, p.seq) for p in one]
    assert [p.seq for p in four] == truths
    assert stats.contigs == 4 and stats.polished == 4
    assert stats.batches > 0 and 0 < stats.batch_fill <= 1
    assert get_active_batcher() is None


def test_cli_threads_with_variant_from_environment(tmp_path, monkeypatch):
    """`cli -t 4` with NP2_DP_BASE=1: the file that -t 1 writes under the
    default variant, contigs in input order, through the base twin only."""
    import dataclasses
    import io

    from nextpolish2_tpu_torch import cli

    fa, bam, yak, _truths = _four_contig_inputs(tmp_path,
                                                np.random.default_rng(84))
    out = tmp_path / "t4.fa"
    argv = [bam, fa, yak, "-L", "0", "-l", "100", "-a", "50", "--window-len",
            "512", "--device", "cpu", "-t", "4", "-o", str(out)]
    cfg = cli.args_to_config(cli.build_parser().parse_args(argv))
    want = io.BytesIO()
    polish(fa, bam, [yak], dataclasses.replace(cfg, threads=1), engine="cuda",
           device="cpu", out=want)
    monkeypatch.setenv("NP2_DP_BASE", "1")
    before = dict(tk.LAUNCHES)
    assert cli.main(argv) == 0
    assert out.read_bytes() == want.getvalue()
    assert out.read_bytes().count(b">") == 4
    ran = {k for k in tk.LAUNCHES if tk.LAUNCHES[k] > before.get(k, 0)}
    assert ran == {"consensus_dp_base_plain", "backtrack_plain"}
    assert get_active_batcher() is None


def test_chunk_runner_upload_layout_and_cpu_handles():
    """The one-buffer upload takes int32 arrays before uint8 ones (so every
    int32 view is aligned) and nothing else; on the CPU a submitted chunk
    runs inline and result() hands back its packed output as it is."""
    runner = te.ChunkRunner(CPU)
    i32 = np.zeros(4, dtype=np.int32)
    with pytest.raises(ValueError, match="int32 arrays, then uint8"):
        runner._upload([np.zeros(3, dtype=np.uint8), i32])
    with pytest.raises(ValueError, match="int32 arrays, then uint8"):
        runner._upload([i32, np.zeros(4, dtype=np.int64)])

    rng = np.random.default_rng(85)
    B, W, K = 3, 40, 4
    key = np.full((B, W, K), -1, dtype=np.int32)
    cnt = np.zeros((B, W, K), dtype=np.int32)
    cov = rng.integers(1, 9, size=(B, W)).astype(np.int32)
    ns = np.zeros((B, W), dtype=np.int32)
    lead = np.zeros(B, dtype=np.int64)
    seed = np.zeros(B, dtype=bool)
    last = np.full(B, W - 1, dtype=np.int32)
    handle = runner.submit_dense(key, cnt, cov, ns, lead, seed, last,
                                 max_steps=W + 128, dp_variant="dynk")
    assert isinstance(handle, torch.Tensor)
    out = te.ChunkRunner.result(handle)
    assert out.shape == (B, W + 128 + 8) and out.dtype == np.int16
    assert np.shares_memory(out, handle.numpy())


def test_counters_survive_concurrent_updates():
    """LAUNCHES and engine.STATS are shared by the contig threads and the
    batcher's worker: no update may be lost."""
    n_threads, n_each = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    before = (tk.LAUNCHES["stress"], te.STATS["stress"])
    try:
        def work():
            for _ in range(n_each):
                tk._count("stress", (1, 2, 3))
                te._stat("stress")

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    total = n_threads * n_each
    try:
        assert tk.LAUNCHES["stress"] - before[0] == total
        assert tk.SHAPE_LAUNCHES[("stress", 1, 2, 3)] >= total
        assert te.STATS["stress"] - before[1] == total
    finally:
        del tk.LAUNCHES["stress"], te.STATS["stress"]
        del tk.SHAPE_LAUNCHES[("stress", 1, 2, 3)]
