"""Every per-layer metric reader on a recorded sample: stage totals and
counters as a traced run leaves them, and a small Chrome trace with the
window's two marker kernels."""

import json
from types import SimpleNamespace

import pytest

from polishbench import roofline, spec, trace
from polishbench.probes import StageIntervals

# stage thread-seconds of one traced pass (shape of a real run)
STAGES = {"ingest_alignseqs": 3.7, "ingest_begin3": 3.1, "ingest_fetch3": 0.4,
          "plan_windows": 4.9, "stream_sort": 2.0, "find_anchors": 1.1,
          "plan_ktiers": 0.3, "aggregate_pileup": 0.9, "device_submit": 0.1,
          "device_dp_backtrack": 0.15, "lq_detect": 12.0,
          "extract_alleles": 20.0, "extract_native": 15.0, "phasing": 10.9,
          "load_yak_tables": 5.0, "kmer_scoring": 2.0, "kscore_single": 1.0,
          "splice_recheck": 1.25}
BASES = 7_310_000


def _trace_file(tmp_path):
    ev = []

    def x(name, cat, ts, dur):
        ev.append({"ph": "X", "cat": cat, "name": name, "ts": ts,
                   "dur": dur})

    x("spin_kernel(long)", "kernel", 1000.0, 5.0)
    x("void dp_v2_kernel<8>(int const*)", "kernel", 2000.0, 400.0)
    x("backtrack_kernel(int const*)", "kernel", 2400.0, 100.0)
    x("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 2450.0, 100.0)
    x("kmer_score_kernel(int4 const*)", "kernel", 5000.0, 50.0)
    x("spin_kernel(long)", "kernel", 11000.0, 5.0)
    ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
               "ts": 1999.0, "dur": 3.0})
    p = tmp_path / "trace.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    return str(p)


@pytest.fixture
def ctx(tmp_path):
    red = trace.reduce_window(trace.device_events(_trace_file(tmp_path)),
                              host_start=100.0)
    chunk_s = sum((e - s) * 1e-6 for name, cat, s, e in red["ops"]
                  if cat == "kernel" and roofline.is_chunk_kernel(name))
    kmer_s = sum((e - s) * 1e-6 for name, cat, s, e in red["ops"]
                 if cat == "kernel" and roofline.is_kmer_kernel(name))
    stats = [SimpleNamespace(in_bases=BASES), SimpleNamespace(in_bases=BASES)]
    return {"bases": 2 * BASES, "stages": dict(STAGES), "stats": stats,
            "trace": red, "chunk_kernel_s": chunk_s, "kmer_kernel_s": kmer_s,
            "bytes": {"chunk_in": 3_000_000, "chunk_out": 1_000_000,
                      "kmer": 120_000}}


def test_trace_window_and_offset(ctx):
    red = ctx["trace"]
    assert red["window_s"] == pytest.approx((11000.0 - 1005.0) * 1e-6)
    # dp 2000-2400, bt 2400-2500 with the copy 2450-2550, score 5000-5050
    assert red["busy_s"] == pytest.approx(600e-6)
    assert red["offset"] == pytest.approx(100.0 - 1000.0e-6)
    assert ctx["chunk_kernel_s"] == pytest.approx(500e-6)
    ops = dict(trace.top_ops(red["ops"]))
    assert ops["void dp_v2_kernel<8>(int const*)"] == pytest.approx(400e-6)
    assert not any("spin_kernel" in n for n in ops)


def test_idle_gaps_named_by_host_stage(ctx):
    off = ctx["trace"]["offset"]
    ivs = [("plan_windows", 1, off + 1005e-6, off + 2000e-6),
           ("lq_detect", 2, off + 2550e-6, off + 10000e-6),
           ("phasing", 2, off + 3000e-6, off + 3100e-6)]
    gaps = dict(trace.idle_gaps(ctx["trace"], ivs))
    assert gaps["plan_windows"] == pytest.approx(995e-6)
    assert gaps["lq_detect"] == pytest.approx((5000 - 2550 + 11000 - 5050)
                                              * 1e-6)


READS = {
    "ingest.thread_s_per_Mbp": 3.7 / 14.62,
    "windows.thread_s_per_Mbp": (4.9 + 0.3 + 0.9) / 14.62,
    "engine.device_wait_s_per_Mbp": 0.25 / 14.62,
    "lq.thread_s_per_Mbp": (12.0 + 20.0 + 10.9) / 14.62,
    "kmer.thread_s_per_Mbp": (5.0 + 2.0 + 1.25) / 14.62,
    "kernels.chunk_roofline": 100.0 * 4e6 / roofline.PEAK_HBM_BYTES_PER_S
    / 500e-6,
    "kernels.kmer_roofline": 100.0 * 120_000
    / roofline.PEAK_HBM_BYTES_PER_S / 50e-6,
    "device.idle_share": 100.0 * (1 - 600e-6 / ((11000.0 - 1005.0) * 1e-6)),
}


@pytest.mark.parametrize("name", sorted(READS))
def test_reader_on_recorded_sample(ctx, name):
    mod = spec.load_metric_reader(name)
    assert mod.read(ctx) == pytest.approx(READS[name])


@pytest.mark.parametrize("name", sorted(READS))
def test_reader_finds_nothing_returns_none(name):
    empty = {"bases": 0, "stages": {}, "stats": [],
             "trace": {"window_s": 0.0, "busy_s": 0.0},
             "chunk_kernel_s": 0.0, "kmer_kernel_s": 0.0, "bytes": {}}
    assert spec.load_metric_reader(name).read(empty) is None


def test_every_reader_is_covered():
    import os

    files = {f[:-3] for f in os.listdir(os.path.join(spec.BENCH_DIR,
                                                     "metrics"))
             if f.endswith(".py")}
    assert files == set(READS)


def test_stage_recorder_keeps_totals_and_intervals():
    rec = StageIntervals()
    rec["a"] += 1.5
    rec["a"] += 0.5
    rec["b"] += 0.25
    assert dict(rec) == {"a": 2.0, "b": 0.25}
    assert [(n, round(e - s, 6)) for n, _, s, e in rec.intervals] == \
        [("a", 1.5), ("a", 0.5), ("b", 0.25)]


def test_roofline_counts_problem_bytes():
    import numpy as np
    import torch

    assert roofline.chunk_bytes_in([np.zeros(10, np.int32),
                                    np.zeros(3, np.uint8)]) == 43
    assert roofline.chunk_bytes_out(torch.zeros(5, dtype=torch.int16)) == 10
    assert roofline.is_chunk_kernel("void dp_reduce_kernel<48, true>(int)")
    assert roofline.is_chunk_kernel("backtrack_kernel(int const*)")
    assert not roofline.is_chunk_kernel("kmer_lookup_kernel(int4 const*)")
    assert roofline.is_kmer_kernel("kmer_lookup_kernel(int4 const*)")
    assert roofline.is_kmer_kernel("void kmer_score_kernel<16>(int4 const*)")
    assert not roofline.is_kmer_kernel("backtrack_kernel(int const*)")
    assert roofline.kmer_lookup_bytes(10) == 120
    assert roofline.kmer_score_bytes([b"ACGT", b"A"]) == 5 + 16
    assert not roofline.is_chunk_kernel("void at::native::scan()")
    assert roofline.share_percent(0, 1.0) is None
    assert roofline.share_percent(100, 0.0) is None
