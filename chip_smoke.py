#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (nextpolish2_tpu_torch) on one NVIDIA
card: the quickest proof that the port builds, agrees with itself and runs
its main path on the GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases (no failure is caught; any mismatch exits non-zero before the result
line):
  1. the card's name and power limit; build the CUDA kernels (nvcc, one
     process per source, in parallel) and the native host library from the
     checkout's sources;
  2. each kernel (the three DP formulations v2, base and dynamic-K, all on
     the slot-parallel mapping, and the backtrack) against its plain PyTorch
     twin on the card, bit for bit, on real chunks built by the port's host
     pipeline at the four production shapes (K/B/W 8/512/1280, 8/128/1280,
     8/128/2560, 48/128/2560), each filled with the E. coli and slice
     windows that make the main path choose that shape, with CUDA-event
     timings and bounds counted from the chunk's data; the three DP kernels
     must also agree with each other. Then all four kernels against their
     twins on the seeded edge-case tables of
     nextpolish2_tpu_torch/utils/dp_cases.py (dynamic-K under an exact and
     under a mangled n_slots): odd K, B and W, spans of 0 and W, full
     columns, deep insertion chains, invalid slots that match a target
     before or behind them, walks cut at 0, 1 and 7 steps;
  2b. the two k-mer kernels on E. coli's k21 table, packed on the card (its
     16-byte slot entries equal to the numpy build's): kmer_lookup on
     2^12..2^22 queries (half present, half absent; min_count 5 and 7, which
     cuts the counts of 6, all but repeats) and kmer_min_scores on allele
     batches of 2^12..2^24 bases cut from E. coli with Ns and substitutions,
     each bit for bit against its twin, and up to 2^18 against the host
     search, with the call's time (wrapper included) and the kernel-only
     time (CUDA events around the C entry point alone, its arguments
     prepared), the device operations of a call and their device time
     (torch.profiler), bounds and the searchsorted yardstick; the device
     build's peak memory against the estimate KmerTable.device_fits routes
     by (DeviceKmerTable.device_bytes: 17 B a slot, 192 B a key); then both
     KmerTable routes end to end (upload, kernel and download at every
     size; the host search or chain up to 2^18) and their crossovers, with
     and without the table's device build;
  3. the main path: testdata/ecoli.* (one 4.6 Mb contig, k21 table,
     min_ctg_len=1000, -t 1) through orchestrator.polish(engine="cuda");
     output must equal testdata/ecoli.truth.fa, every kernel must launch and
     no plain twin may; neither k-mer kernel runs (every batch of the
     bundled data is below the routing thresholds) and no contig is
     segmented, here and in phases 4-7;
  4. testdata/slice.* with k21+k31 against slice.golden.fa;
  5. E. coli again with dp_variant="dynk" (dense tables shipped whole, the
     dynamic-K kernel) and the slice with dp_variant="base" (blob route):
     same bytes, and the launch counts prove which kernel ran;
  6. testdata/m20.* (20 contigs) at threads=8 through the cross-contig
     batcher and at threads=1: 20/20 contigs equal to m20.truth.fa;
  7. batcher runs forced onto the dense fallback (requests without a CSR
     closure), under the default variant and under dynamic-K: the rows of
     the CSR-direct run;
  8. the segmented engine with both k-mer routes forced onto the card
     (NP2_SEG_FORCE=1, both thresholds at 1): the slice in 5 kb segments
     (both k-mer kernels must launch), equal to its golden;
  9. m20 at threads=8 with every contig segmented (16 kb segments) through
     the batcher: 20/20 equal to m20.truth.fa;
  10. E. coli whole-contig and segmented, each polished in a child process
     (`chip_smoke.py --rss-child MODE`) that reports its peak RSS (VmRSS
     sampled every 10 ms): the segmented one in 1 Mb segments with both
     k-mer routes forced onto the card (kmer_lookup must launch; E. coli
     has no allele longer than k, so the scorer has no batch there), equal
     to ecoli.truth.fa, its launch counts set to 0 before and read after
     in the child like every other path's;
  11. the sharded lookup kernel_lookup_sharded (which replaces the JAX
     package's make_sharded_lookup) on E. coli's table in 2 shards at 2^12,
     2^20 and 2^22 queries: each shard's launch bit for bit against its
     twin, and the shards' sum against kmer_lookup on the unsharded table;
     shard 0's call, kernel-only and device time, bound (20 B a query and a
     32 B sector a probe of the queries it owns) and searchsorted
     yardstick;
  12. the mesh path on a 4x2 mesh of the one card repeated (its positions
     run in turn): the slice under the default variant, "base" and "dynk",
     E. coli, and m20 at -t 8 through the batcher, each equal to its golden
     or truth, every 'win' position having run its rows, and every get()
     batch of 256 queries or more taken by the sharded table (kmer positions
     and kernel checked); then batcher runs forced onto the sparse format
     under the mesh (no CSR closure: ops.consensus.
     dp_backtrack_sparse_packed) and onto one device by a 3x1 mesh that
     divides no batch (shape_misalign), each equal to the unsharded rows;
  13. two CLI processes sharing the card (NP2_COORDINATOR on a free
     loopback port, each under its own timeout) polish m20 into two shards
     that process 0 merges: equal to m20.truth.fa, no sentinel left;
  14. the slice through the CLI with --profile-dir: equal to its golden,
     and the trace names the DP and backtrack kernels;
  15. QV through the device k-mer table: tools.qv on the card for
     ecoli.fa and ecoli.truth.fa against ecoli.k21.yak and m20.fa against
     m20.k21.yak, each a path (a contig of NP2_KMER_DEVICE_MIN k-mers or
     more is one kmer_lookup launch, E. coli's ~4.6 M queries, no smaller
     contig launches), each QvResult equal to the host route's (forced by
     NP2_KMER_DEVICE_MIN above any batch); then kmer_lookup at E. coli's
     real queries against its twin and the host search, with its times and
     bound, as the kernel row of the QV launches' shape;
  16. one E. coli chunk at K=8, B=128, W=1280: aggregate_windows on the
     card equal to the host aggregation of the same windows (all five
     fields), and dp_backtrack_csr on the card (a path: the v2 DP and the
     backtrack launch) equal to dp_backtrack_csr_blob on the same chunk;
  17. the data-prep chain: tools.make_big_fixture makes a ~2 Mb one-contig
     fixture, which the CLI polishes on the card to its truth, with
     tools.qv before and after (the polished QV at least the assembly's);
     tools.make_fixture makes 2 contigs of ~30 kb whose reads go through
     tools.align and tools.kmer_count again, and the CLI's cuda and oracle
     engines polish that to the same bytes.
Every path is driven with the launch counts set to 0 just before it and read
just after. Then one JSON line of per-kernel numbers (launches per path of
phases 3-6, 8-10, 12 and 14-17, and their sum; the batcher checks' counts,
those of the whole-contig child and of the QV host routes stay in their own
lines), the seconds at the end of each phase, the card line, and the result
line.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "testdata")

# H100 SXM published peaks (NVIDIA data sheet): HBM bandwidth, and the
# non-tensor-core 32-bit rate, used here for int32 compare/select steps
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
NEG_INF = -(1 << 30)
DP_SHAPES = [(8, 512, 1280), (8, 128, 1280), (8, 128, 2560),
             (48, 128, 2560)]   # (K, B, W)
KERNELS = ("consensus_dp_v2", "consensus_dp_base", "consensus_dp_dynk",
           "backtrack_packed")
KMER_KERNELS = ("kmer_lookup", "kmer_min_scores")
SHARDED = "kmer_lookup_sharded"
ALL_KERNELS = KERNELS + KMER_KERNELS + (SHARDED,)
TWINS = ("consensus_dp_plain", "consensus_dp_base_plain",
         "consensus_dp_dynk_plain", "backtrack_plain", "kmer_lookup_plain",
         "kmer_min_scores_plain", "kmer_lookup_sharded_plain")
LOOKUP_SIZES = [1 << e for e in range(12, 23, 2)]   # queries
SHARDED_SIZES = [1 << 12, 1 << 20, 1 << 22]          # queries
MESH = (4, 2)     # win x kmer positions of the mesh phases, on one card
SCORE_SIZES = [1 << e for e in range(12, 25, 2)]    # bases of an allele batch
# the host routes run to this size only: past the crossovers (2^16-2^18
# with the device build counted), where they take seconds
HOST_MAX = 1 << 18
NARROW_W = 1280   # the narrow width tier at the default window_len of 1024
TIMED_LAUNCHES = 20
PLAIN_RUNS = 3
T_START = time.time()
TIMELINE: dict = {}     # phase -> seconds since the start at its end


def lap(phase: str) -> None:
    TIMELINE[phase] = round(time.time() - T_START, 1)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    raise SystemExit(1)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def median_ms(fn, n: int, warm: bool = True) -> float:
    """Median of n CUDA-event timings of fn, after one untimed call unless
    the caller has just made one (warm=False)."""
    import torch

    if warm:
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def contig_windows(fa: str, bam: str) -> dict:
    """The port's host pipeline up to the window plan on the first contig
    of `fa`: its window batch, window_anchors, span and K tier per
    window."""
    import numpy as np

    from nextpolish2_tpu_torch.config import PolishConfig
    from nextpolish2_tpu_torch.io.bam import BamReader
    from nextpolish2_tpu_torch.io.fastx import read_fastx
    from nextpolish2_tpu_torch.models.oracle import build_alignseqs_native_flat
    from nextpolish2_tpu_torch.pipeline.engine import (window_anchors,
                                                       window_ktiers)
    from nextpolish2_tpu_torch.pipeline.windows import build_window_batch
    from nextpolish2_tpu_torch.utils.seqcodes import ASCII2CODE

    bam = os.path.join(DATA, bam)
    name, tseq = next(iter(read_fastx(os.path.join(DATA, fa))))
    tid = [n for n, _ in BamReader(bam).references].index(name)
    cfg = PolishConfig(min_ctg_len=1000)
    res = build_alignseqs_native_flat(bam, tid, tseq, cfg)
    if res is None:
        fail("native ingest unavailable")
    al, flat = res
    wb = build_window_batch(al, len(tseq),
                            ASCII2CODE[np.frombuffer(tseq, dtype=np.uint8)],
                            target=cfg.window_len,
                            stream_cache={"flat_all": flat})
    anchors = window_anchors(wb)
    return {"source": f"{fa}:{name}", "wb": wb, "anchors": anchors,
            "span": anchors[2] + 1,
            "ktier": window_ktiers(wb, len(tseq), cfg.max_kmers_per_col)}


def pick_lanes(sources: list, K: int, B: int, W: int) -> list:
    """Real windows for one (K, B, W) chunk: the windows that make the main
    path choose this shape -- windows of K tier K when K is the fat tier,
    windows wider than the narrow tier when W is the wide tier, narrow K=8
    windows otherwise -- repeated in turn to fill B lanes. Returns
    (source, sorted ids) pieces."""
    import numpy as np

    from nextpolish2_tpu_torch.pipeline.engine import K_SMALL

    flat = []
    for si, src in enumerate(sources):
        span, ktier = src["span"], src["ktier"]
        need = (span <= W) & (ktier <= K)
        if K > K_SMALL or W > NARROW_W:
            need &= ((ktier == K) & (K > K_SMALL)) | \
                ((span > NARROW_W) & (W > NARROW_W))
        flat += [(si, int(i)) for i in np.nonzero(need)[0]]
    if not flat:
        fail(f"no window in {[s['source'] for s in sources]} needs "
             f"K={K} W={W}")
    lanes = [flat[j % len(flat)] for j in range(B)]
    return [(sources[si], np.sort([i for s, i in lanes if s == si]))
            for si in sorted({s for s, _ in lanes})]


def chunk_tables(pieces: list, K: int, W: int, dev):
    """A real chunk of width W and K slots: each (source, ids) piece goes
    through the main path's blob packing (engine.chunk_blob), upload, parse
    and assembly (consensus.blob_tables); the lanes are concatenated.
    Returns the DP and backtrack inputs on `dev`, and the host
    aggregation's overflow flag per lane (such a window is re-run by the
    host fallback and its device rows are discarded)."""
    import torch

    from nextpolish2_tpu_torch.ops.consensus import blob_tables
    from nextpolish2_tpu_torch.pipeline.engine import chunk_blob

    parts = []
    for src, ids in pieces:
        blob, P, Pd, Pe, over, _ = chunk_blob(src["wb"], ids, W, K, len(ids),
                                              src["anchors"])
        parts.append(blob_tables(blob, B=len(ids), W=W, K=K, P=P, Pd=Pd,
                                 Pe=Pe, device=dev)
                     + (torch.from_numpy(over).to(dev),))
    return tuple(torch.cat(t) for t in zip(*parts))


def measure_shape(sources: list, K: int, B: int, W: int, dev,
                  plain_runs: int = PLAIN_RUNS) -> list:
    """Kernels vs plain twins at one shape: bit-exactness, times (the twins'
    median of plain_runs), bounds."""
    import torch

    from nextpolish2_tpu_torch.ops import consensus_cuda as cc

    pieces = pick_lanes(sources, K, B, W)
    key, cnt, cov, lead, seed, last_col, over = chunk_tables(pieces, K, W,
                                                             dev)
    span = last_col + 1
    live = (key >= 0).sum(-1)
    n_slots = live.to(torch.int32)
    live_max = int(live.max())
    if K > 8 and live_max <= 8:
        fail(f"K={K} chunk has no column with more than 8 live slots")
    if W > NARROW_W and int(span.max()) <= NARROW_W:
        fail(f"W={W} chunk has no window wider than {NARROW_W}")
    ms_steps = W + 128
    shape = f"K={K} B={B} W={W}"
    dps = {
        "consensus_dp_v2": (
            lambda: cc.consensus_dp_v2(key, cnt, cov, lead, seed, span),
            lambda: cc.consensus_dp_plain(key, cnt, cov, lead, seed, span)),
        "consensus_dp_base": (
            lambda: cc.consensus_dp_base(key, cnt, cov, lead, seed),
            lambda: cc.consensus_dp_base_plain(key, cnt, cov, lead, seed)),
        "consensus_dp_dynk": (
            lambda: cc.consensus_dp_dynk(key, cnt, cov, n_slots, lead, seed),
            lambda: cc.consensus_dp_dynk_plain(key, cnt, cov, n_slots, lead,
                                               seed)),
    }
    out, err, ms, plain_ms = {}, {}, {}, {}
    for name, (kern, twin) in dps.items():
        sk, bk = kern()
        sp, bp = twin()
        torch.cuda.synchronize()
        err[name] = max(int((sk.long() - sp.long()).abs().max()),
                        int((bk.long() - bp.long()).abs().max()))
        if err[name] != 0 or not (torch.equal(sk, sp) and torch.equal(bk, bp)):
            fail(f"{name} != its plain twin at {shape}")
        out[name] = (sk, bk)
    # the three formulations: scores everywhere, besti on valid slots. On
    # a window that lost slots to the K cap (flagged for the host fallback)
    # a chain may hang off a slot without predecessor and sink below
    # NEG_INF-1, where the running pick and the _pick reduction part by
    # design: there they must agree on every reachable score
    sk, bk = out["consensus_dp_v2"]
    valid = key >= 0
    parted = {}
    for name in ("consensus_dp_base", "consensus_dp_dynk"):
        so, bo = out[name]
        same = (so == sk) & ((bo == bk) | ~valid)
        reach = (so > NEG_INF) | (sk > NEG_INF)
        if not bool(same[~over].all()) or bool((~same & reach).any()):
            fail(f"{name} != consensus_dp_v2 at {shape}")
        parted[name] = int((~same).sum())
    if not torch.equal(*(out[n][0] for n in ("consensus_dp_base",
                                             "consensus_dp_dynk"))):
        fail(f"consensus_dp_base != consensus_dp_dynk scores at {shape}")

    def bt_kern(lc=last_col):
        return cc.backtrack_packed(key, cnt, cov, sk, bk, lc, seed, ms_steps)

    def bt_twin(lc=last_col):
        return cc.backtrack_plain(key, cnt, cov, sk, bk, lc, seed, ms_steps)

    ok, op = bt_kern(), bt_twin()
    torch.cuda.synchronize()
    err["backtrack_packed"] = int((ok.long() - op.long()).abs().max())
    if err["backtrack_packed"] != 0:
        fail(f"backtrack_packed != plain at {shape}")
    # the packed output is the same from each formulation's scores
    for name in ("consensus_dp_base", "consensus_dp_dynk"):
        so, bo = out[name]
        if not torch.equal(ok, cc.backtrack_packed(key, cnt, cov, so, bo,
                                                   last_col, seed, ms_steps)):
            fail(f"packed output under {name} != under v2 at {shape}")
    # a window wider than the chunk (host-fallback bound) starts clamped
    wide = last_col.clone()
    wide[0] = W + 50
    if not torch.equal(bt_kern(wide), bt_twin(wide)):
        fail(f"backtrack_packed != plain with last_col past W={W}")

    for name, (kern, twin) in {**dps, "backtrack_packed":
                               (bt_kern, bt_twin)}.items():
        ms[name] = median_ms(kern, TIMED_LAUNCHES)
        # every twin ran once above, for the checks
        plain_ms[name] = median_ms(twin, plain_runs, warm=False)

    # DP bounds, from this chunk's data: what each function has to touch.
    # Bytes: on every column it scans (v2: below each window's span; base
    # and dynamic-K: all W columns) v2 and base read the key of all K slots
    # (validity is in the key) and the cnt of the live ones, dynamic-K
    # reads n_slots and then key and cnt of the first min(n_slots, K) slots
    # only; plus cov per scanned column, scores and besti written once for
    # every column, and the per-window scalars. Operations: ~20 int32 ops to
    # decode each live slot, and ~4 (match test and pick) for each pair of
    # live slots in adjacent columns
    below = torch.arange(W, device=dev)[None, :] < span.clamp(0, W)[:, None]
    cols = int(below.sum())
    live = live.long()
    live_all = int(live.sum())
    live_below = int((live * below).sum())
    given = int(n_slots.clamp(0, K).long().sum())
    pairs_all = int((live[:, 1:] * live[:, :-1]).sum())
    live_b = live * below
    pairs_below = int((live_b[:, 1:] * live_b[:, :-1]).sum())
    out_bytes = B * W * K * 5
    work = {
        "consensus_dp_v2": (
            cols * (K * 4 + 4) + live_below * 4 + out_bytes + B * 9,
            20 * live_below + 4 * pairs_below),
        "consensus_dp_base": (
            B * W * (K * 4 + 4) + live_all * 4 + out_bytes + B * 5,
            20 * live_all + 4 * pairs_all),
        "consensus_dp_dynk": (
            B * W * 8 + given * 8 + out_bytes + B * 5,
            20 * given + 4 * pairs_all),
    }
    # backtrack bound: the states the walks visit (key, cnt, cov, besti),
    # the start column's scores, and the packed output; ~30 int ops a step
    alive_steps = ok[:, ms_steps + 2].long() & 0xFFFF
    visited = int(alive_steps.sum()) + B
    # the dependent chain each kernel cannot shorten: the columns the widest
    # window scans (v2: its clamped span; base and dynamic-K: all W), the
    # steps of the longest walk
    span_max = int(span.clamp(0, W).max())
    chain = {"consensus_dp_v2": span_max, "consensus_dp_base": W,
             "consensus_dp_dynk": W,
             "backtrack_packed": int(alive_steps.max())}
    work["backtrack_packed"] = (
        visited * 13 + B * K * 4 + B * 9 + B * (ms_steps + 8) * 2,
        30 * visited)
    csrc = "nextpolish2_tpu_torch/csrc/"
    pallas = "nextpolish2_tpu/ops/consensus_pallas.py:"
    where = {
        "consensus_dp_v2": (csrc + "consensus_dp.cu", pallas + "152"),
        "consensus_dp_base": (csrc + "consensus_dp_base.cu", pallas + "69"),
        "consensus_dp_dynk": (csrc + "consensus_dp_dynk.cu", pallas + "294"),
        "backtrack_packed": (csrc + "backtrack.cu",
                             "nextpolish2_tpu/ops/consensus.py:320"),
    }
    rows = []
    for name in KERNELS:
        nbytes, nops = work[name]
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = nops / PEAK_OPS_PER_S * 1e3
        rows.append({
            "name": name, "shape": {"K": K, "B": B, "W": W},
            "route": "cuda", "source": where[name][0],
            "replaces": where[name][1],
            "launches": 0, "max_abs_err": err[name], "ms": ms[name],
            "plain_ms": plain_ms[name],
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "chain_steps": chain[name],
            "ns_per_chain_step": (ms[name] * 1e6 / chain[name]
                                  if chain[name] else None)})
    print(json.dumps({"phase": "kernels_vs_plain", "K": K, "B": B, "W": W,
                      "lanes": {s["source"]: [len(ids), len(set(ids.tolist()))]
                                for s, ids in pieces},
                      "span_max": int(span.max()), "cols": cols,
                      "live_slots_max": live_max,
                      "live_slots_mean": float(live.float().mean()),
                      "overflow_lanes": int(over.sum()),
                      "unreachable_slots_where_formulations_part": parted,
                      "rows": rows}), flush=True)
    return rows


def edge_case_check(dev) -> None:
    """All four kernels against their twins on every seeded edge-case table,
    bit for bit (dp_cases.check_kernels raises on a difference)."""
    from nextpolish2_tpu_torch.utils import dp_cases

    t0 = time.time()
    held = [dp_cases.check_kernels(case, dev)
            for case in dp_cases.edge_cases()]
    print(json.dumps({"phase": "kernel_edge_cases", "max_abs_err": 0,
                      "seconds": time.time() - t0, "cases": held}),
          flush=True)


@contextlib.contextmanager
def env_set(**values):
    """Set environment variables for the duration of a block."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update({k: str(v) for k, v in values.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def host_route(table):
    """KmerTable.get and batch_min_kscores on the host for a block."""
    table.use_device = False
    try:
        yield
    finally:
        table.use_device = True


def wall_ms(fn, n: int) -> float:
    """Median host-clock ms of n calls of fn (host arrays in, host out)."""
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def kmer_setup(dev) -> dict:
    """E. coli's k21 table as the routes use it: the host table, its numpy
    build (the JAX package's cascade, copied) and the device build that
    KmerTable.device_table makes, which must give the same planes; and the
    sorted composite keys on the card for the library yardstick. The device
    build's peak memory must stay within the estimate that
    KmerTable.device_fits routes by."""
    import numpy as np
    import torch

    from nextpolish2_tpu_torch.io.yak import load_yak
    from nextpolish2_tpu_torch.ops.kmer_table import (BUILD_BYTES_PER_SLOT,
                                                      DeviceKmerTable)

    table = load_yak(os.path.join(DATA, "ecoli.k21.yak"))
    hashes = table.full_hashes()
    t0 = time.time()
    ref = DeviceKmerTable.build(hashes, table.counts.astype(np.int64),
                                table.ksize)
    numpy_s = time.time() - t0
    table.use_device = True
    table.device = dev
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    t0 = time.time()
    tab, hi, lo, ct = table.device_table()
    torch.cuda.synchronize()
    device_s = time.time() - t0
    peak = torch.cuda.max_memory_allocated(dev) - base
    slots, estimate = DeviceKmerTable.device_bytes(len(hashes))
    if peak > estimate or slots != tab.size:
        fail(f"device build peaked at {peak} B on {tab.size} slots; "
             f"device_bytes estimates {estimate} B on {slots}")
    if not torch.equal(tab.entries.cpu(), torch.from_numpy(ref.entries)):
        fail("device-built slot entries != the numpy build's")
    for got, want, name in ((hi, ref.key_hi, "key_hi"),
                            (lo, ref.key_lo, "key_lo"),
                            (ct, ref.counts, "counts")):
        if not torch.equal(got.cpu(), torch.from_numpy(want)):
            fail(f"device-built {name} plane != the numpy build's")
    if (tab.size, tab.n_probes) != (ref.size, ref.n_probes):
        fail("device build's size or probe bound != the numpy build's")
    # composite keys (bin << 54 | key) are sorted as unsigned 64-bit; the
    # top bit flipped, they sort the same as signed int64
    flip = np.uint64(1 << 63)
    comp = torch.from_numpy((table.composite ^ flip).view(np.int64)).to(dev)
    info = {"keys": len(hashes), "slots": tab.size, "n_probes": tab.n_probes,
            "numpy_build_s": numpy_s, "device_build_s": device_s,
            "device_build_peak_bytes": peak,
            "device_build_peak_bytes_per_key":
                (peak - BUILD_BYTES_PER_SLOT * tab.size) / len(hashes),
            "device_bytes_estimate": estimate}
    print(json.dumps({"phase": "kmer_table", "table": "ecoli.k21.yak",
                      **info}), flush=True)
    return {"table": table, "tab": tab, "planes": (hi, lo, ct),
            "hashes": hashes, "composite": comp, "flip": flip,
            "comp_counts": torch.from_numpy(
                table.counts.astype(np.int32)).to(dev),
            "build_ms": device_s * 1e3, "info": info}


def entry_ms(name: str, call: tuple) -> float:
    """Median CUDA-event ms of a kernel's C entry point alone, its
    arguments prepared by the wrapper's checks once (`call`: the C function,
    its arguments, the output); no wrapper, no count."""
    fn, args, _ = call
    rc = fn(*args)
    if rc != 0:
        fail(f"{name}: C entry point returned CUDA error {rc}")
    return median_ms(lambda: fn(*args), TIMED_LAUNCHES, warm=False)


def device_trace(fn, n: int = TIMED_LAUNCHES) -> dict:
    """n calls of fn under torch.profiler: the device operations (kernels,
    memsets, copies) by name with their count a call, and the device time
    a call, the sum over names of each one's mean duration (the trace's own
    stamps, so no host gap between launches counts; the mean keeps events
    the trace drops out of it). "not measured" where the trace holds no
    device activity or the profiler cannot start on this card (a
    diagnostic: the kernel checks are elsewhere). A failure of fn itself
    propagates."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    try:
        prof.start()
    except RuntimeError as e:
        return {"device_ops_per_call": f"not measured: {e}",
                "device_ms": None}
    try:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    finally:
        prof.stop()
    ops: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ops.setdefault(e.name, []).append(e.time_range.elapsed_us())
    if not ops:
        return {"device_ops_per_call": "not measured: no device activity "
                "in the trace", "device_ms": None}
    return {"device_ops_per_call": {k: len(v) / n for k, v in ops.items()},
            "device_ms": sum(statistics.mean(v) for v in ops.values()) / 1e3}


def kmer_row(name: str, n: int, err: int, ms: float, plain_ms: float,
             nbytes: float, nops: float, library_ms, **extra) -> dict:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = nops / PEAK_OPS_PER_S * 1e3
    src = {"kmer_lookup": ("kmer_lookup.cu",
                           "nextpolish2_tpu/ops/kmer_table.py:120"),
           SHARDED: ("kmer_lookup.cu",
                     "nextpolish2_tpu/parallel/sharded_kmer.py:84"),
           "kmer_min_scores": ("kmer_score.cu",
                               "nextpolish2_tpu/ops/kmer_score.py:93")}[name]
    return {"name": name, "shape": {"N": n}, "route": "cuda",
            "source": "nextpolish2_tpu_torch/csrc/" + src[0],
            "replaces": src[1], "launches": 0, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms, **extra}


def measure_lookup(km: dict, Q: int, dev, rng) -> tuple:
    """kmer_lookup against its twin and the host search on Q queries (half
    present, half absent; min_count 5 keeps E. coli's counts of 6, 7 cuts
    all but those of repeats), with its time, bound and library yardstick;
    and the two routes of KmerTable.get end to end. Returns (kernel row,
    route row)."""
    import numpy as np
    import torch

    from nextpolish2_tpu_torch.ops.kmer_table import (kmer_lookup,
                                                      kmer_lookup_plain)

    table, tab, (hi, lo, ct) = km["table"], km["tab"], km["planes"]
    q = np.concatenate([rng.choice(km["hashes"], Q // 2),
                        rng.integers(0, 1 << 42, Q - Q // 2,
                                     dtype=np.uint64)])
    rng.shuffle(q)
    qd = [torch.from_numpy(a).to(dev) for a in tab.query_host_arrays(q)]
    host, host_ms = {}, None
    if Q <= HOST_MAX:
        with host_route(table):
            t0 = time.perf_counter()
            host[5] = table.get(q, 5)
            host_ms = (time.perf_counter() - t0) * 1e3
            host[7] = table.get(q, 7)
    res = {}
    for mc in (5, 7):
        got = kmer_lookup(hi, lo, ct, *qd, mc, tab.n_probes)
        want = kmer_lookup_plain(hi, lo, ct, *qd, mc, tab.n_probes)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"kmer_lookup != its twin at Q={Q}, min_count={mc}")
        res[mc] = got.cpu().numpy()
        if mc in host and not np.array_equal(res[mc], host[mc]):
            fail(f"kmer_lookup != the host search at Q={Q}, min_count={mc}")
    hits = int((res[5] > 0).sum())
    cut = int((res[7] < res[5]).sum())
    if not Q // 2 <= hits < Q or cut < hits // 2:
        fail(f"kmer_lookup queries at Q={Q} miss their mix ({hits} hits, "
             f"{cut} cut by min_count 7)")
    if Q < HOST_MAX:
        with host_route(table):
            host_ms = wall_ms(lambda: table.get(q, 5), 3)
    row = lookup_row(km, q, qd, res[5], dev)
    route = {"n": Q, "host_ms": host_ms,
             "device_ms": wall_ms(lambda: table.get_device(q, 5), 5)}
    return row, route


def lookup_row(km: dict, q, qd: list, counts5, dev, **extra) -> dict:
    """kmer_lookup's row on the queries q (uint64 hashes; qd their planes
    on the card) at min_count 5, whose kernel counts are counts5: call,
    kernel-only and device time, the twin's time, the bound from the probes
    these queries need (16 B a query, a 32 B sector a probe), and the
    searchsorted yardstick, which must give counts5."""
    import numpy as np
    import torch

    from nextpolish2_tpu_torch.ops.kmer_table import (kmer_lookup,
                                                      kmer_lookup_call,
                                                      kmer_lookup_plain,
                                                      probe_plain)

    table, tab, (hi, lo, ct) = km["table"], km["tab"], km["planes"]
    Q = len(q)
    qc = torch.from_numpy(((((q & np.uint64(table.pmask)) << np.uint64(54))
                            | (q >> np.uint64(10))) ^ km["flip"])
                          .view(np.int64)).to(dev)
    comp, cnts = km["composite"], km["comp_counts"]

    def library():
        idx = torch.searchsorted(comp, qc).clamp_(max=comp.shape[0] - 1)
        return torch.where(comp[idx] == qc, cnts[idx], 0)

    lib = library()
    if not torch.equal(torch.where(lib >= 5, lib, 0).cpu(),
                       torch.from_numpy(np.asarray(counts5))):
        fail(f"searchsorted yardstick != kmer_lookup at Q={Q}")
    probes = int(probe_plain(hi, lo, ct, *qd, tab.n_probes)[1].sum())
    return kmer_row(
        "kmer_lookup", Q, 0,
        median_ms(lambda: kmer_lookup(hi, lo, ct, *qd, 5, tab.n_probes),
                  TIMED_LAUNCHES),
        median_ms(lambda: kmer_lookup_plain(hi, lo, ct, *qd, 5,
                                            tab.n_probes), PLAIN_RUNS),
        Q * 16 + 32 * probes, 10 * Q + 8 * probes,
        median_ms(library, TIMED_LAUNCHES), probes=probes,
        kernel_ms=entry_ms("kmer_lookup", kmer_lookup_call(
            hi, lo, ct, *qd, 5, tab.n_probes)),
        **device_trace(lambda: kmer_lookup(hi, lo, ct, *qd, 5,
                                           tab.n_probes)), **extra)


def score_batch(seq: bytes, n_bases: int, rng) -> list:
    """Alleles of 22-199 bases cut from E. coli, joined length <= n_bases:
    5% with an N inside, 10% with a substituted base (a k-mer the table
    lacks, so the allele scores 0)."""
    seqs, total = [], 0
    while True:
        m = int(rng.integers(22, 200))
        if total + m + 1 > n_bases:
            return seqs
        at = int(rng.integers(0, len(seq) - m))
        a = bytearray(seq[at : at + m])
        r = rng.random()
        if r < 0.05:
            a[m // 2] = ord("N")
        elif r < 0.15:
            a[m // 3] = b"CGTA"[b"ACGT".index(a[m // 3])]
        seqs.append(bytes(a))
        total += m + 1


def measure_score(km: dict, seq: bytes, n_bases: int, dev, rng,
                  measured: set) -> tuple:
    """kmer_min_scores against its twin and the host chain on an allele
    batch of about n_bases; its time and bound at the kernel's padded
    length (once per length); and the two routes of batch_min_kscores end
    to end. Returns (kernel row or None, route row)."""
    import numpy as np
    import torch

    from nextpolish2_tpu_torch.models.oracle_lq import batch_min_kscores
    from nextpolish2_tpu_torch.ops.kmer_score import (device_min_kscores,
                                                      end_position_hashes,
                                                      kmer_min_scores,
                                                      kmer_min_scores_call,
                                                      kmer_min_scores_plain,
                                                      score_inputs)
    from nextpolish2_tpu_torch.ops.kmer_table import _low32, probe_plain

    table, tab, (hi, lo, ct) = km["table"], km["tab"], km["planes"]
    seqs = score_batch(seq, n_bases, rng)
    codes, starts = score_inputs(seqs)
    cd, sd = torch.from_numpy(codes).to(dev), torch.from_numpy(starts).to(dev)
    k = table.ksize
    # min_count 7 cuts nearly every count of E. coli's table (6, but for
    # repeats); the host chain runs for it below HOST_MAX bases
    hosts, host_ms = {}, None
    if n_bases <= HOST_MAX:
        with host_route(table):
            t0 = time.perf_counter()
            hosts[5] = batch_min_kscores(seqs, table, 5)
            host_ms = (time.perf_counter() - t0) * 1e3
            if n_bases < HOST_MAX:
                hosts[7] = batch_min_kscores(seqs, table, 7)
    for mc in (5, 7):
        got = kmer_min_scores(hi, lo, ct, cd, sd, k, mc, tab.n_probes)
        want = kmer_min_scores_plain(hi, lo, ct, cd, sd, k, mc, tab.n_probes)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"kmer_min_scores != its twin at {n_bases} bases, "
                 f"min_count={mc}")
        if mc == 5:
            scores = got.cpu().numpy()[: len(seqs)]
        if mc in hosts and not np.array_equal(got.cpu().numpy()[: len(seqs)],
                                              hosts[mc]):
            fail(f"kmer_min_scores != the host chain at {n_bases} bases, "
                 f"min_count={mc}")
    n_zero = int((scores == 0).sum())
    if not 0 < n_zero < len(seqs):
        fail(f"allele batch of {n_bases} bases misses its mix "
             f"({n_zero} of {len(seqs)} score 0)")
    if n_bases < HOST_MAX:
        with host_route(table):
            host_ms = wall_ms(lambda: batch_min_kscores(seqs, table, 5), 3)
    L, S = len(codes), len(starts)
    row = None
    if L not in measured:
        measured.add(L)
        valid, h = end_position_hashes(cd, k)
        slot = ((h >> 10) ^ (h << 7)) & (tab.size - 1)
        probes = int(probe_plain(hi, lo, ct, (h >> 32).to(torch.int32),
                                 _low32(h), slot, tab.n_probes)[1][valid]
                     .sum())
        row = kmer_row(
            "kmer_min_scores", L, 0,
            median_ms(lambda: kmer_min_scores(hi, lo, ct, cd, sd, k, 5,
                                              tab.n_probes), TIMED_LAUNCHES),
            median_ms(lambda: kmer_min_scores_plain(hi, lo, ct, cd, sd, k, 5,
                                                    tab.n_probes),
                      PLAIN_RUNS),
            L + 8 * S + 32 * probes,
            L * 38 + 3 * (L // 32) * S.bit_length() + 8 * probes, None,
            alleles=len(seqs), probes=probes,
            kernel_ms=entry_ms("kmer_min_scores", kmer_min_scores_call(
                hi, lo, ct, cd, sd, k, 5, tab.n_probes)),
            **device_trace(lambda: kmer_min_scores(hi, lo, ct, cd, sd, k, 5,
                                                   tab.n_probes)))
    route = {"n": n_bases, "alleles": len(seqs), "kernel_length": L,
             "host_ms": host_ms,
             "device_ms": wall_ms(lambda: device_min_kscores(table, seqs, 5),
                                  3)}
    return row, route


def crossover(routes: list, extra_ms: float = 0.0):
    """The smallest measured size from which the device route, plus
    extra_ms, beats the host route at every larger size (None if none)."""
    best = None
    for r in sorted(routes, key=lambda r: -r["n"]):
        if r["host_ms"] is None:
            continue
        if r["device_ms"] + extra_ms < r["host_ms"]:
            best = r["n"]
        else:
            break
    return best


def kmer_phase(dev) -> dict:
    """Phase 2b: both k-mer kernels against their twins and the host
    searches at every size, bit for bit; their times and bounds; the
    crossover of each route (upload and download included) with and
    without the device build of the table. Returns {(name, N): row}."""
    import numpy as np
    import torch

    from nextpolish2_tpu_torch.io.fastx import read_fastx
    from nextpolish2_tpu_torch.io.yak import KMER_DEVICE_MIN
    from nextpolish2_tpu_torch.models.oracle_lq import KMER_SCORE_DEVICE_MIN

    t0 = time.time()
    km = kmer_setup(dev)
    rng = np.random.default_rng(11)
    rows, routes = {}, {"lookup": [], "score": []}
    for Q in LOOKUP_SIZES:
        row, route = measure_lookup(km, Q, dev, rng)
        rows[("kmer_lookup", Q)] = row
        routes["lookup"].append(route)
    seq = next(iter(read_fastx(os.path.join(DATA, "ecoli.fa"))))[1]
    measured: set = set()
    for n in SCORE_SIZES:
        row, route = measure_score(km, seq, n, dev, rng, measured)
        if row is not None:
            rows[("kmer_min_scores", row["shape"]["N"])] = row
        routes["score"].append(route)
    build_ms = km["build_ms"]
    print(json.dumps({
        "phase": "kmer_kernels_vs_plain", "seconds": time.time() - t0,
        "table": km["info"], "rows": list(rows.values())}), flush=True)
    print(json.dumps({
        "phase": "kmer_route_crossover", "routes": routes,
        "table_device_build_ms": build_ms,
        "crossover": {
            "lookup_queries": crossover(routes["lookup"]),
            "lookup_queries_with_build": crossover(routes["lookup"],
                                                   build_ms),
            "score_bases": crossover(routes["score"]),
            "score_bases_with_build": crossover(routes["score"], build_ms)},
        "defaults": {"NP2_KMER_DEVICE_MIN": KMER_DEVICE_MIN,
                     "NP2_KMER_SCORE_DEVICE_MIN": KMER_SCORE_DEVICE_MIN}}),
        flush=True)
    return {"km": km, "rows": rows, "seq": seq}


def vmrss_gb() -> float:
    """This process's resident set now (VmRSS of /proc/self/status)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS"):
                return int(line.split()[1]) / (1 << 20)
    raise RuntimeError("no VmRSS in /proc/self/status")


# the two E. coli children of phase 10: the phase name, the environment
# the parent gives each, the kernels that must and must not launch there,
# and whether the contig is segmented
RSS_CHILDREN = {
    "whole_contig": ("ecoli_whole_contig_child", {"NP2_NO_SEG": "1"},
                     ("consensus_dp_v2", "backtrack_packed"),
                     ("consensus_dp_base", "consensus_dp_dynk")
                     + KMER_KERNELS, False),
    "segmented": ("ecoli_segmented_device_kmer",
                  {"NP2_SEG_FORCE": "1", "NP2_SEG_LEN": str(1 << 20),
                   "NP2_KMER_DEVICE_MIN": "1",
                   "NP2_KMER_SCORE_DEVICE_MIN": "1"},
                  ("consensus_dp_v2", "backtrack_packed", "kmer_lookup"),
                  ("consensus_dp_base", "consensus_dp_dynk"), True),
}


def rss_child(mode: str) -> int:
    """Child of phase 10: E. coli through polish() on the card as one path
    of Paths.run (counts set to 0 before, read and checked after, equal to
    the truth) under the environment the parent set; its last line holds
    the path's launches by shape, and the peak RSS: the largest VmRSS
    sampled every 10 ms. (ru_maxrss does not serve: after a fork and an
    exec it starts from the parent's high-water mark, and the chip host's
    /proc has no VmHWM.)"""
    sys.path.insert(0, HERE)
    phase, _env, must, must_not, segmented = RSS_CHILDREN[mode]
    peak = [vmrss_gb()]
    done = threading.Event()

    def sample():
        while not done.wait(0.01):
            peak[0] = max(peak[0], vmrss_gb())

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    paths = Paths()
    res = paths.run(phase, must, must_not,
                    lambda: polish_check("ecoli.fa", "ecoli.bam",
                                         ["ecoli.k21.yak"], "ecoli.truth.fa",
                                         "cuda"), segmented=segmented)
    done.set()
    sampler.join()
    peak[0] = max(peak[0], vmrss_gb())
    print(json.dumps({"peak_rss_gb": peak[0], "wall_s": res["wall_s"],
                      "segments": res["segments"],
                      "by_shape": [[*key, n] for key, n
                                   in paths.by_path[phase].items()]}))
    return 0


def memory_phase(paths: "Paths") -> dict:
    """Phase 10: E. coli whole-contig and segmented, each in a child process
    (rss_child): their peak RSS (no threshold: reported), and the segmented
    child's launches as the path ecoli_segmented_device_kmer of `paths`."""
    out = {}
    for mode, (phase, extra, _m, _n, segmented) in RSS_CHILDREN.items():
        env = {k: v for k, v in os.environ.items()
               if k not in ("NP2_NO_SEG", "NP2_SEG_FORCE", "NP2_SEG_LEN",
                            "NP2_KMER_DEVICE_MIN",
                            "NP2_KMER_SCORE_DEVICE_MIN")}
        env.update(extra)
        p = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--rss-child", mode], env=env,
                           capture_output=True, text=True, timeout=300)
        if p.returncode != 0:
            fail(f"memory child ({mode}) exited {p.returncode}:\n"
                 f"{p.stderr[-4000:]}")
        lines = p.stdout.strip().splitlines()
        print("\n".join(lines[:-1]), flush=True)   # the child's path lines
        out[mode] = json.loads(lines[-1])
        by_shape = {tuple(k[:-1]): k[-1] for k in out[mode].pop("by_shape")}
        paths.shapes.update(by_shape)
        if segmented:
            paths.by_path[phase] = by_shape
    print(json.dumps({"phase": "memory_ecoli", **out}), flush=True)
    return out


def polish_check(fa: str, bam: str, yaks: list, truth: str, device,
                 threads: int = 1, dp_variant=None) -> dict:
    """polish() on testdata files; every contig must equal `truth`."""
    from nextpolish2_tpu_torch.config import PolishConfig
    from nextpolish2_tpu_torch.io.fastx import read_fastx
    from nextpolish2_tpu_torch.pipeline.orchestrator import PolishStats, polish

    stats = PolishStats()
    sink = io.BytesIO()
    t0 = time.time()
    polish(os.path.join(DATA, fa), os.path.join(DATA, bam),
           [os.path.join(DATA, y) for y in yaks],
           PolishConfig(min_ctg_len=1000, threads=threads), engine="cuda",
           out=sink, stats=stats, device=device, dp_variant=dp_variant)
    wall = time.time() - t0
    sink.seek(0)
    lines = sink.read().splitlines()
    got_names = [ln[1:].split()[0] for ln in lines if ln.startswith(b">")]
    got = [ln for ln in lines if not ln.startswith(b">")]
    want = [seq for _name, seq in read_fastx(os.path.join(DATA, truth))]
    names = [name for name, _seq in read_fastx(os.path.join(DATA, fa))]
    if len(got) != len(want):
        fail(f"{fa}: {len(got)} contigs out, {len(want)} in {truth}")
    if [n.decode() for n in got_names] != names:
        fail(f"{fa}: contigs were not written in input order")
    for i, (g, w) in enumerate(zip(got, want)):
        if g != w:
            fail(f"{fa}: contig {i} differs from {truth}")
    return {"wall_s": wall, "threads": threads, "dp_variant": dp_variant,
            "contigs": stats.contigs, "identical": f"{len(got)}/{len(want)}",
            "bases_in": stats.in_bases, "bases_out": stats.out_bases,
            "identical_to": truth, "batches": stats.batches,
            "batch_fill": stats.batch_fill, "csr_batches": stats.csr_batches,
            "dense_reasons": stats.dense_reasons}


def shape_label(key: tuple) -> str:
    """(name, K, B, W) -> name@KxBxW; (name, N) -> name@N."""
    if len(key) == 4:
        return "{}@K{}xB{}xW{}".format(*key)
    return "{}@N{}".format(*key)


class Paths:
    """Drives one path at a time with the launch counts at 0 before it,
    reads them after it, checks which kernels ran, and keeps each path's
    per-shape counts: those of the polish() paths go into the kernels line
    (keep=True); a batcher check's stay in its own phase line."""

    def __init__(self):
        self.by_path: dict = {}     # phase -> {(name, K, B, W): launches}
        self.shapes: set = set()    # every (name, K, B, W) any path launched

    def run(self, phase: str, must_launch: tuple, must_not: tuple, fn,
            keep: bool = True, segmented: bool = False):
        from nextpolish2_tpu_torch.ops import consensus_cuda as cc
        from nextpolish2_tpu_torch.pipeline import engine
        from nextpolish2_tpu_torch.utils import timing

        cc.reset_counts()
        engine.STATS.clear()
        timing.reset()
        timing.enable()
        res = fn()
        timing.enable(False)
        launches = dict(cc.LAUNCHES)
        by_shape = dict(cc.SHAPE_LAUNCHES)
        for name in must_launch:
            if launches.get(name, 0) == 0:
                fail(f"{phase}: {name} was not launched")
        for name in must_not + TWINS:
            if launches.get(name, 0) != 0:
                fail(f"{phase}: {name} ran ({launches[name]} times)")
        if (engine.STATS["segmented_contigs"] > 0) != segmented:
            fail(f"{phase}: {engine.STATS['segmented_contigs']} contigs "
                 f"took the segmented engine")
        self.shapes.update(by_shape)
        if keep:
            self.by_path[phase] = by_shape
        res = dict(res or {})
        res.update({"windows": engine.STATS["windows"],
                    "chunks": engine.STATS["chunks"],
                    "segmented_contigs": engine.STATS["segmented_contigs"],
                    "segments": engine.STATS["segments"],
                    "host_fallback_windows":
                        engine.STATS["host_fallback_windows"],
                    "oracle_fallback_contigs":
                        engine.STATS["oracle_fallback_contigs"],
                    "launches": launches})
        print(json.dumps({"phase": phase, **res,
                          "by_shape": {shape_label(key): c for key, c
                                       in sorted(by_shape.items())}}),
              flush=True)
        stages = timing.snapshot()
        print(json.dumps({"phase": phase + "_stages_s",
                          **{k: stages[k] for k in
                             sorted(stages, key=lambda k: -stages[k])}}),
              flush=True)
        timing.reset()
        return res


def dense_fallback_check(src: dict, dev, dp_variant: str, n: int) -> dict:
    """The first n narrow K=8 windows of `src` through a DeviceBatcher twice,
    with and without their CSR closure: the second run must take the dense
    format (reason no_csr_closure) and give the first run's rows."""
    import numpy as np

    from nextpolish2_tpu_torch.pipeline.engine import K_SMALL

    ids_all = np.nonzero((src["span"] <= NARROW_W)
                         & (src["ktier"] == K_SMALL))[0][:n]
    rows, stats = {}, {}
    for with_csr in (True, False):
        stats[with_csr], rows[with_csr] = batcher_rows(src, dev, ids_all,
                                                       with_csr, dp_variant)
    st = stats[False]
    if st.batches == 0 or st.csr_batches != 0 or \
            st.dense_reasons != {"no_csr_closure": st.batches}:
        fail(f"dense fallback not taken: {st.batches} batches, "
             f"{st.csr_batches} CSR, {st.dense_reasons}")
    if stats[True].csr_batches != stats[True].batches:
        fail("CSR-direct run fell back to dense")
    if len(rows[True]) != len(ids_all) or len(rows[False]) != len(ids_all):
        fail("batcher returned the wrong number of windows")
    for wa, wb_ in zip(rows[True], rows[False]):
        for xa, xb in zip(wa, wb_):
            if not np.array_equal(xa, xb):
                fail(f"dense-fallback rows differ from the CSR rows "
                     f"({dp_variant})")
    return {"dp_variant": dp_variant, "n_windows": len(ids_all),
            "dense_batches": st.batches, "dense_fill": st.fill,
            "dense_reasons": st.dense_reasons,
            "csr_batches": stats[True].batches}


def lookup_queries(km: dict, Q: int, rng):
    """Q queries of the phase 2b mix: half present, half absent."""
    import numpy as np

    q = np.concatenate([rng.choice(km["hashes"], Q // 2),
                        rng.integers(0, 1 << 42, Q - Q // 2,
                                     dtype=np.uint64)])
    rng.shuffle(q)
    return q


def sharded_setup(km: dict, dev) -> dict:
    """E. coli's table in MESH[1] shards (the numpy build KmerTable.
    get_sharded makes), on a 1 x MESH[1] mesh of `dev`, with each shard's
    sorted composite keys on the card for the yardstick."""
    import numpy as np
    import torch

    from nextpolish2_tpu_torch.parallel.mesh import make_mesh
    from nextpolish2_tpu_torch.parallel.sharded_kmer import (
        SHARD_BITS_SHIFT, ShardedKmerTable)

    table, h = km["table"], km["hashes"]
    n = MESH[1]
    t0 = time.time()
    tab = ShardedKmerTable.build(h, table.counts.astype(np.int64),
                                 table.ksize, n)
    build_s = time.time() - t0
    planes = tab.put(make_mesh(1, n, devices=[dev] * n))
    shard_of = (h >> np.uint64(SHARD_BITS_SHIFT)) % np.uint64(n)
    comp = [torch.from_numpy((table.composite[shard_of == s] ^ km["flip"])
                             .view(np.int64)).to(dev) for s in range(n)]
    cnts = [torch.from_numpy(table.counts[shard_of == s].astype(np.int32))
            .to(dev) for s in range(n)]
    return {"tab": tab, "planes": planes, "comp": comp, "cnts": cnts,
            "info": {"shards": n, "shard_size": tab.shard_size,
                     "n_probes": tab.n_probes, "numpy_build_s": build_s}}


def measure_lookup_sharded(km: dict, sh: dict, Q: int, dev, rng,
                           unsharded: dict) -> dict:
    """kmer_lookup_sharded on every shard against its twin, and the shards'
    sum against kmer_lookup on the unsharded table, bit for bit (min_count 5
    and 7), on Q queries of the phase 2b mix; shard 0's call time,
    kernel-only time, device time, bound and yardstick (searchsorted on the
    shard's sorted keys, the queries of other shards masked), beside
    kmer_lookup's call time at Q (`unsharded`: phase 2b's rows)."""
    import numpy as np
    import torch

    from nextpolish2_tpu_torch.ops.kmer_table import (
        kmer_lookup, kmer_lookup_sharded, kmer_lookup_sharded_call,
        kmer_lookup_sharded_plain, probe_plain)

    tab, (shi, slo, sct) = sh["tab"], sh["planes"]
    utab, (hi, lo, ct) = km["tab"], km["planes"]
    q = lookup_queries(km, Q, rng)
    qd = [torch.from_numpy(a).to(dev) for a in tab.query_host_arrays(q)]
    qu = [torch.from_numpy(a).to(dev) for a in utab.query_host_arrays(q)]
    for mc in (5, 7):
        rest = kmer_lookup(hi, lo, ct, *qu, mc, utab.n_probes)
        for s in range(tab.n_shards):
            got = kmer_lookup_sharded(shi[s], slo[s], sct[s], *qd, s, mc,
                                      tab.n_probes)
            want = kmer_lookup_sharded_plain(shi[s], slo[s], sct[s], *qd, s,
                                             mc, tab.n_probes)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f"{SHARDED} != its twin at Q={Q}, shard {s}, "
                     f"min_count={mc}")
            rest = rest - got
        torch.cuda.synchronize()
        if rest.any():
            fail(f"the {tab.n_shards} shards' sum != kmer_lookup at Q={Q}, "
                 f"min_count={mc}")
    owned = qd[3] == 0
    probes = int(probe_plain(shi[0], slo[0], sct[0], *qd[:3],
                             tab.n_probes)[1][owned].sum())
    qc = torch.from_numpy(((((q & np.uint64(km["table"].pmask))
                             << np.uint64(54)) | (q >> np.uint64(10)))
                           ^ km["flip"]).view(np.int64)).to(dev)
    comp, cnts = sh["comp"][0], sh["cnts"][0]

    def library():
        idx = torch.searchsorted(comp, qc).clamp_(max=comp.shape[0] - 1)
        out = torch.where((comp[idx] == qc) & owned, cnts[idx], 0)
        return torch.where(out >= 5, out, 0)

    if not torch.equal(library(), kmer_lookup_sharded(
            shi[0], slo[0], sct[0], *qd, 0, 5, tab.n_probes)):
        fail(f"searchsorted yardstick != {SHARDED} at Q={Q}")

    def call():
        return kmer_lookup_sharded(shi[0], slo[0], sct[0], *qd, 0, 5,
                                   tab.n_probes)

    return kmer_row(
        SHARDED, Q, 0, median_ms(call, TIMED_LAUNCHES),
        median_ms(lambda: kmer_lookup_sharded_plain(
            shi[0], slo[0], sct[0], *qd, 0, 5, tab.n_probes), PLAIN_RUNS),
        Q * 20 + 32 * probes, 11 * Q + 8 * probes,
        median_ms(library, TIMED_LAUNCHES), shard=0, shards=tab.n_shards,
        owned=int(owned.sum()), probes=probes,
        kernel_ms=entry_ms(SHARDED, kmer_lookup_sharded_call(
            shi[0], slo[0], sct[0], *qd, 0, 5, tab.n_probes)),
        unsharded_kmer_lookup_ms=unsharded.get(("kmer_lookup", Q),
                                               {}).get("ms"),
        **device_trace(call))


def sharded_phase(kmer: dict, dev) -> dict:
    """Phase 11: the sharded lookup at SHARDED_SIZES. Returns
    {(name, N): row} and the setup for later sizes."""
    import numpy as np

    t0 = time.time()
    sh = sharded_setup(kmer["km"], dev)
    rng = np.random.default_rng(13)
    rows = {(SHARDED, Q): measure_lookup_sharded(kmer["km"], sh, Q, dev, rng,
                                                 kmer["rows"])
            for Q in SHARDED_SIZES}
    print(json.dumps({"phase": "kmer_lookup_sharded_vs_plain",
                      "seconds": time.time() - t0, "table": sh["info"],
                      "rows": list(rows.values())}), flush=True)
    return {"rows": rows, "sh": sh}


@contextlib.contextmanager
def mesh_run(n_win: int, n_kmer: int, dev):
    """An active n_win x n_kmer mesh of `dev` repeated for a block, the
    position counts at 0 before it; yields the batch sizes KmerTable.get
    was called with inside it."""
    import numpy as np

    from nextpolish2_tpu_torch.io.yak import KmerTable
    from nextpolish2_tpu_torch.parallel import mesh as pm

    sizes: list = []
    orig = KmerTable.get

    def get(self, hashes, min_count=0):
        sizes.append(len(np.atleast_1d(hashes)))
        return orig(self, hashes, min_count)

    KmerTable.get = get
    pm.set_active_mesh(pm.make_mesh(n_win, n_kmer,
                                    devices=[dev] * (n_win * n_kmer)))
    pm.reset_position_counts()
    try:
        yield sizes
    finally:
        pm.set_active_mesh(None)
        KmerTable.get = orig


def mesh_path(paths: "Paths", phase: str, must: tuple, must_not: tuple, fn,
              dev, keep: bool = True) -> dict:
    """One path of phase 12 on the MESH mesh: every 'win' position must
    have run, and every get() batch of 256 queries or more must have gone
    to the sharded table (SHARDED_LOOKUPS counts them; every 'kmer'
    position and kmer_lookup_sharded ran for them)."""
    from nextpolish2_tpu_torch.io import yak
    from nextpolish2_tpu_torch.parallel import mesh as pm

    n_win, n_kmer = MESH
    before = yak.SHARDED_LOOKUPS
    with mesh_run(n_win, n_kmer, dev) as sizes:
        res = paths.run(phase, must, must_not, fn, keep=keep)
        runs = dict(pm.POSITION_RUNS)
    big = sum(n >= 256 for n in sizes)
    sharded = yak.SHARDED_LOOKUPS - before
    if sharded != big:
        fail(f"{phase}: {big} get() batches of 256 or more queries, "
             f"{sharded} sharded lookups")
    for i in range(n_win):
        if not runs.get(("win", i)):
            fail(f"{phase}: 'win' position {i} ran no rows")
    if big and (not all(runs.get(("kmer", s)) for s in range(n_kmer))
                or not res["launches"].get(SHARDED)):
        fail(f"{phase}: the sharded lookups skipped a 'kmer' position or "
             f"its kernel")
    out = {"phase": phase + "_mesh", "mesh": f"{n_win}x{n_kmer}",
           "get_batches": len(sizes), "get_batches_256_up": big,
           "sharded_lookups": sharded,
           "position_runs": {f"{a}{i}": n for (a, i), n
                             in sorted(runs.items())}}
    print(json.dumps(out), flush=True)
    return {**res, **out}


def batcher_rows(src: dict, dev, ids, with_csr: bool,
                 dp_variant: str = "v2") -> tuple:
    """The windows `ids` of `src` (narrow, K=8) through one DeviceBatcher,
    with or without their CSR closures: (stats, per-window rows)."""
    from nextpolish2_tpu_torch.pipeline.batcher import DeviceBatcher
    from nextpolish2_tpu_torch.pipeline.engine import (K_SMALL,
                                                       resolve_dp_variants)
    from nextpolish2_tpu_torch.pipeline.windows import (aggregate_csr_parts,
                                                        aggregate_host)

    wb = src["wb"]
    lead, seed, last = src["anchors"]
    b = DeviceBatcher(dev, resolve_dp_variants(dp_variant))
    try:
        futs = []
        for c0 in range(0, len(ids), 32):
            sub = ids[c0 : c0 + 32]
            futs.append(b.submit(
                (NARROW_W, K_SMALL), len(sub),
                lambda sub=sub: aggregate_host(
                    wb, K_SMALL, width=NARROW_W, n_windows=len(sub),
                    win_idx=sub),
                lead[sub], seed[sub], last[sub],
                aggregate_csr=(lambda lo, hi, sub=sub: aggregate_csr_parts(
                    wb, K_SMALL, width=NARROW_W, n_windows=hi - lo,
                    win_idx=sub[lo:hi])) if with_csr else None))
        rows = [w for f in futs for w in f.result(timeout=300)]
    finally:
        b.shutdown()
    return b.stats, rows


def mesh_batcher_check(src: dict, dev, n: int, mesh: tuple,
                       with_csr: bool, reason: str) -> dict:
    """The first n narrow K=8 windows of `src` through a batcher without a
    mesh (CSR-direct, one device), then under an active `mesh` (with or
    without CSR closures): every batch of the second run must fall back to
    dense for `reason`, and give the first run's rows. no_csr_closure under
    a mesh takes the sparse format, sharded (dp_backtrack_sparse_packed
    must run once a batch); shape_misalign runs on one device."""
    import numpy as np

    from nextpolish2_tpu_torch.parallel import mesh as pm
    from nextpolish2_tpu_torch.pipeline import engine
    from nextpolish2_tpu_torch.pipeline.engine import K_SMALL

    ids = np.nonzero((src["span"] <= NARROW_W)
                     & (src["ktier"] == K_SMALL))[0][:n]
    ref_stats, want = batcher_rows(src, dev, ids, True)
    sparse_calls = [0]
    orig = engine.dp_backtrack_sparse_packed

    def counted(*a, **kw):
        sparse_calls[0] += 1
        return orig(*a, **kw)

    engine.dp_backtrack_sparse_packed = counted
    try:
        with mesh_run(*mesh, dev):
            stats, rows = batcher_rows(src, dev, ids, with_csr)
            runs = dict(pm.POSITION_RUNS)
    finally:
        engine.dp_backtrack_sparse_packed = orig
    if stats.batches == 0 or stats.csr_batches != 0 or \
            stats.dense_reasons != {reason: stats.batches}:
        fail(f"mesh batcher ({reason}): {stats.batches} batches, "
             f"{stats.csr_batches} CSR, {stats.dense_reasons}")
    win = {k: v for k, v in runs.items() if k[0] == "win"}
    sharded = reason == "no_csr_closure"
    if sharded and (sparse_calls[0] != stats.batches or win != {
            ("win", i): stats.batches for i in range(mesh[0])}):
        fail(f"mesh batcher: {sparse_calls[0]} sparse dispatches and "
             f"positions {win} for {stats.batches} batches")
    if not sharded and (win or sparse_calls[0]):
        fail(f"misaligned batches ran sharded: {win}")
    if len(rows) != len(ids) or len(want) != len(ids):
        fail("batcher returned the wrong number of windows")
    for wa, wb_ in zip(rows, want):
        for xa, xb in zip(wa, wb_):
            if not np.array_equal(xa, xb):
                fail(f"mesh batcher rows ({reason}) differ from the "
                     "unsharded CSR rows")
    return {"mesh": "{}x{}".format(*mesh), "n_windows": len(ids),
            "batches": stats.batches, "fill": stats.fill,
            "dense_reasons": stats.dense_reasons,
            "sparse_dispatches": sparse_calls[0],
            "reference_csr_batches": ref_stats.csr_batches,
            "position_runs": {f"{a}{i}": v for (a, i), v
                              in sorted(runs.items())}}


def free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def fasta_equal(path: str, truth: str) -> int:
    """Records of `path` against `truth` (names and sequences, in order);
    fails on a difference. Returns the record count."""
    from nextpolish2_tpu_torch.io.fastx import read_fastx

    got = list(read_fastx(path))
    want = list(read_fastx(os.path.join(DATA, truth)))
    if [n for n, _ in got] != [n for n, _ in want]:
        fail(f"{path}: contig names or order differ from {truth}")
    for (name, g), (_, w) in zip(got, want):
        if g != w:
            fail(f"{path}: {name} differs from {truth}")
    return len(got)


def two_process_phase(work: str) -> dict:
    """Phase 13: two CLI processes on the one card split m20's contigs
    (NP2_COORDINATOR on a free loopback port); process 0 merges the shards.
    Each process has its own timeout and is killed past it."""
    out = os.path.join(work, "m20.merged.fa")
    port = free_port()
    t0 = time.time()
    procs = []
    for h in range(2):
        env = dict(os.environ, PYTHONPATH=HERE,
                   NP2_COORDINATOR=f"127.0.0.1:{port}",
                   NP2_NUM_PROCESSES="2", NP2_PROCESS_ID=str(h),
                   NP2_MERGE_TIMEOUT_S="240")
        env.pop("NP2_NO_AUTOMERGE", None)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "nextpolish2_tpu_torch.cli",
             os.path.join(DATA, "m20.bam"), os.path.join(DATA, "m20.fa"),
             os.path.join(DATA, "m20.k21.yak"), "-L", "1000", "-t", "4",
             "-o", out], env=env, cwd=HERE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    errs = []
    for h, p in enumerate(procs):
        try:
            _, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            p.kill()
            _, err = p.communicate()
            errs.append(f"process {h} timed out:\n{err[-3000:]}")
            continue
        if p.returncode != 0:
            errs.append(f"process {h} exited {p.returncode}:\n{err[-3000:]}")
        elif h == 0 and "merged 2 host shards" not in err:
            errs.append(f"process 0 did not merge:\n{err[-3000:]}")
    wall = time.time() - t0
    if errs:
        for p in procs:
            if p.poll() is None:
                p.kill()
        fail("two-process CLI run: " + "\n".join(errs))
    n = fasta_equal(out, "m20.truth.fa")
    left = [f for f in os.listdir(work) if f.endswith(".done")]
    shards = sorted(f for f in os.listdir(work) if ".shard" in f)
    if left or shards != ["m20.merged.fa.shard0", "m20.merged.fa.shard1"]:
        fail(f"two-process CLI run left {left}, shards {shards}")
    res = {"phase": "cli_two_processes", "wall_s": wall, "processes": 2,
           "contigs": n, "identical_to": "m20.truth.fa"}
    print(json.dumps(res), flush=True)
    return res


def profile_cli_check(work: str) -> dict:
    """Phase 14's path: the slice through the CLI with --profile-dir (in
    this process); the output must equal the golden and the Chrome trace
    name the DP and backtrack kernels."""
    from nextpolish2_tpu_torch import cli

    prof = os.path.join(work, "prof")
    out = os.path.join(work, "slice.fa")
    t0 = time.time()
    rc = cli.main([os.path.join(DATA, "slice.bam"),
                   os.path.join(DATA, "slice.fa"),
                   os.path.join(DATA, "k21.yak"),
                   os.path.join(DATA, "k31.yak"), "-L", "1000",
                   "--profile-dir", prof, "-o", out])
    wall = time.time() - t0
    if rc != 0:
        fail(f"CLI with --profile-dir exited {rc}")
    fasta_equal(out, "slice.golden.fa")
    traces = os.listdir(prof)
    if len(traces) != 1:
        fail(f"--profile-dir wrote {traces}")
    with open(os.path.join(prof, traces[0])) as f:
        text = f.read()
    names = {k: text.count(k) for k in ("dp_v2_kernel", "backtrack_kernel")}
    if not all(names.values()):
        fail(f"the trace lacks a kernel: {names}")
    return {"wall_s": wall, "trace": traces[0], "trace_bytes": len(text),
            "kernel_mentions": names}


# phase 15's files: (label, assembly, table); E. coli's one contig is one
# lookup launch of ~4.6 M queries, m20's 50 kb contigs stay on the host
QV_RUNS = (("ecoli", "ecoli.fa", "ecoli.k21.yak"),
           ("ecoli_truth", "ecoli.truth.fa", "ecoli.k21.yak"),
           ("m20", "m20.fa", "m20.k21.yak"))


def qv_phase(paths: "Paths", km: dict, dev, rows: dict) -> dict:
    """Phase 15: tools.qv on the card (qv_of, the entry point's function)
    for each QV_RUNS file at the default routing, then with the host route
    forced (NP2_KMER_DEVICE_MIN above any batch): equal QvResults. Every
    contig of NP2_KMER_DEVICE_MIN k-mers or more is one kmer_lookup launch
    and no smaller one is. Then kmer_lookup's kernel row at E. coli's real
    queries (one contig, Q > 2^22), against its twin and the host search,
    stored under the shape bucket its QV launches counted in."""
    import numpy as np
    import torch

    from nextpolish2_tpu_torch.io.fastx import read_fastx
    from nextpolish2_tpu_torch.io.yak import KMER_DEVICE_MIN, seq_kmers
    from nextpolish2_tpu_torch.ops.kmer_table import (kmer_lookup,
                                                      kmer_lookup_plain)
    from nextpolish2_tpu_torch.tools.qv import qv_of
    from nextpolish2_tpu_torch.utils.torchcfg import bucket_pow2

    out = {}
    for label, fa, yak in QV_RUNS:
        fa_p, yak_p = os.path.join(DATA, fa), os.path.join(DATA, yak)
        qs = [len(seq_kmers(seq, 21)) for _, seq in read_fastx(fa_p)]
        big = [q for q in qs if q >= KMER_DEVICE_MIN]
        got = {}

        def run(route: str):
            t0 = time.time()
            got[route] = qv_of(fa_p, yak_p, 5, dev)
            sync(dev)
            return {"wall_s": time.time() - t0, "result": str(got[route])}

        dev_res = paths.run(
            f"qv_{label}", ("kmer_lookup",) if big else (),
            tuple(k for k in ALL_KERNELS
                  if k != "kmer_lookup" or not big),
            lambda: run("device"))
        host_res = paths.run(
            f"qv_{label}_host_route", (), ALL_KERNELS,
            lambda: with_env({"NP2_KMER_DEVICE_MIN": 1 << 40}, run, "host"),
            keep=False)
        if got["device"] != got["host"]:
            fail(f"QV of {fa}: device route {got['device']} != host route "
                 f"{got['host']}")
        launches = dev_res["launches"].get("kmer_lookup", 0)
        if launches != len(big):
            fail(f"QV of {fa}: {launches} kmer_lookup launches for "
                 f"{len(big)} contigs of {KMER_DEVICE_MIN}+ k-mers")
        r = got["device"]
        out[label] = {
            "file": fa, "table": yak, "contigs": len(qs),
            "total_kmers": r.total_kmers, "missing_kmers": r.missing_kmers,
            "error_rate": r.error_rate, "qv": r.qv,
            "device_route_wall_s": dev_res["wall_s"],
            "host_route_wall_s": host_res["wall_s"],
            "lookup_launches": launches,
            "max_q_per_launch": max(big, default=0),
            "max_q_per_contig": max(qs)}
    if out["ecoli"]["max_q_per_launch"] < 1 << 22:
        fail(f"E. coli's QV launch took {out['ecoli']['max_q_per_launch']} "
             "queries, fewer than 2^22")

    # the kernel at E. coli's real queries
    table, tab, (hi, lo, ct) = km["table"], km["tab"], km["planes"]
    seq = next(iter(read_fastx(os.path.join(DATA, "ecoli.fa"))))[1]
    q = table.to_hash(seq_kmers(seq, table.ksize))
    qd = [torch.from_numpy(a).to(dev) for a in tab.query_host_arrays(q)]
    got = kmer_lookup(hi, lo, ct, *qd, 5, tab.n_probes)
    want = kmer_lookup_plain(hi, lo, ct, *qd, 5, tab.n_probes)
    sync(dev)
    if not torch.equal(got, want):
        fail("kmer_lookup != its twin on E. coli's QV queries")
    with host_route(table):
        host = table.get(q, 5)
    counts5 = got.cpu().numpy()
    if not np.array_equal(counts5, host):
        fail("kmer_lookup != the host search on E. coli's QV queries")
    bucket = bucket_pow2(len(q), 1 << 12)
    rows[("kmer_lookup", bucket)] = lookup_row(
        km, q, qd, counts5, dev, queries="QV of ecoli.fa", bucket=bucket,
        missing=int((counts5 == 0).sum()))
    line = {"phase": "qv_device_lookup", **out,
            "kernel_row_at_real_q": {
                k: rows[("kmer_lookup", bucket)][k]
                for k in ("shape", "ms", "kernel_ms", "plain_ms", "bound_ms",
                          "probes", "library_ms")}}
    print(json.dumps(line), flush=True)
    return line


def aggregate_csr_phase(paths: "Paths", src: dict, dev) -> dict:
    """Phase 16: one E. coli chunk at the production shape K=8, B=128,
    W=1280 (its first 128 narrow K=8 windows). aggregate_windows on the
    card against the host aggregation of the same windows (all five
    fields); dp_backtrack_csr on the card from the chunk's CSR upload
    (its launches counted as a path) against dp_backtrack_csr_blob on the
    same chunk, output unpacked (all seven tensors)."""
    import numpy as np
    import torch

    from nextpolish2_tpu_torch.ops.consensus import (aggregate_windows,
                                                     dp_backtrack_csr,
                                                     dp_backtrack_csr_blob,
                                                     unpack_backtrack_out)
    from nextpolish2_tpu_torch.pipeline.engine import csr_blob, pad_anchors
    from nextpolish2_tpu_torch.pipeline.windows import (aggregate_csr_host,
                                                        aggregate_host)

    K, B, W = 8, 128, NARROW_W
    (_, ids), = pick_lanes([src], K, B, W)
    if len(ids) != B:
        fail(f"{src['source']}: {len(ids)} distinct narrow windows, not {B}")
    wb = src["wb"]
    streams = [wb.window_stream(int(w)) for w in ids]
    T = max(len(c) for c, _ in streams)
    cols = np.full((B, T), W, np.int32)
    keys = np.zeros((B, T), np.int32)
    for i, (c, k) in enumerate(streams):
        cols[i, : len(c)] = c
        keys[i, : len(k)] = k
    if (cols > W).any():
        fail("a narrow window's stream reaches past the chunk width")
    host = aggregate_host(wb, K, width=W, n_windows=B, win_idx=ids)
    host_ms = wall_ms(lambda: aggregate_host(wb, K, width=W, n_windows=B,
                                             win_idx=ids), 3)
    ct, kt = torch.from_numpy(cols).to(dev), torch.from_numpy(keys).to(dev)
    agg = aggregate_windows(ct, kt, W, K)
    for name, want in zip(("key", "count", "coverage", "n_slots",
                           "overflow"), host):
        if not np.array_equal(getattr(agg, name).cpu().numpy(), want):
            fail(f"aggregate_windows.{name} != the host aggregation")
    agg_ms = median_ms(lambda: aggregate_windows(ct, kt, W, K), 5)

    lead, seed, last_col = pad_anchors(src["anchors"], ids, B)
    csr = aggregate_csr_host(wb, K, width=W, n_windows=B, win_idx=ids)
    if csr is None:
        fail("native CSR aggregation unavailable")
    up = [torch.from_numpy(np.asarray(a).astype(np.int32)).to(dev)
          for a in csr[:8]]
    over = torch.from_numpy(csr[8]).to(dev)
    ld, sd, lc = (torch.from_numpy(np.asarray(a).astype(t)).to(dev)
                  for a, t in ((lead, np.int32), (seed, np.uint8),
                               (last_col, np.int32)))
    max_steps = W + 128

    def run_csr():
        return dp_backtrack_csr(*up, over, ld, sd, lc, B, W, K, max_steps)

    got = {}

    def path():
        got["out"] = run_csr()
        sync(dev)

    paths.run("dp_backtrack_csr_ecoli_chunk",
              ("consensus_dp_v2", "backtrack_packed"),
              tuple(k for k in ALL_KERNELS
                    if k not in ("consensus_dp_v2", "backtrack_packed")),
              path)
    blob, P, Pd, Pe = csr_blob(csr[:-1], lead, seed, last_col, K)
    blob_t = torch.from_numpy(blob).to(dev)

    def run_blob():
        return dp_backtrack_csr_blob(blob_t, B=B, W=W, K=K, P=P, Pd=Pd,
                                     Pe=Pe, max_steps=max_steps)

    (out, lvl), (ref, ref_lvl) = got["out"], unpack_backtrack_out(run_blob(),
                                                                 lc)
    for name, a, b in zip(("cols", "packed", "qv", "best", "n_steps",
                           "truncated", "lvl_over"), out + (lvl,),
                          ref + (ref_lvl,)):
        if a.dtype != b.dtype or not torch.equal(a, b):
            fail(f"dp_backtrack_csr {name} != dp_backtrack_csr_blob's")
    line = {"phase": "aggregate_and_csr_program", "source": src["source"],
            "K": K, "B": B, "W": W, "stream_len": T,
            "aggregate_windows_ms": agg_ms, "host_aggregation_ms": host_ms,
            "dp_backtrack_csr_ms": median_ms(run_csr, 5),
            "dp_backtrack_csr_blob_ms": median_ms(run_blob, 5),
            "host_overflow_windows": int(host[4].sum()),
            "steps": int(out[4].sum())}
    print(json.dumps(line), flush=True)
    return line


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def port_tool(module: str, *args) -> float:
    """python -m nextpolish2_tpu_torch.<module> ARGS in a child process
    (its own timeout); fails on a non-zero exit. Returns its wall seconds."""
    t0 = time.time()
    try:
        r = subprocess.run(
            [sys.executable, "-m", f"nextpolish2_tpu_torch.{module}", *args],
            cwd=HERE, env=dict(os.environ, PYTHONPATH=HERE),
            capture_output=True, text=True, timeout=300)
    except subprocess.TimeoutExpired:
        fail(f"{module} timed out")
    if r.returncode != 0:
        fail(f"{module} exited {r.returncode}:\n{r.stderr[-3000:]}")
    return time.time() - t0


def cli_polish(paths: "Paths", phase: str, args: list, out: str, dev,
               must: tuple = ("consensus_dp_v2", "backtrack_packed")
               ) -> dict:
    """The CLI in this process (as phase 14 runs it) on ARGS -o out on
    `dev`, its launches counted as the path `phase`."""
    from nextpolish2_tpu_torch import cli

    def run():
        t0 = time.time()
        rc = cli.main([*args, "-L", "1000", "--device", dev.type, "-o",
                       out])
        if rc != 0:
            fail(f"{phase}: the CLI exited {rc}")
        return {"wall_s": time.time() - t0}

    return paths.run(phase, must, ("consensus_dp_base", "consensus_dp_dynk",
                                   SHARDED) if must else ALL_KERNELS, run)


def data_prep_phase(paths: "Paths", work: str, dev,
                    size: int = 2_000_000) -> dict:
    """Phase 17: the port's data-prep chain on the card. A one-contig
    chromosome fixture from tools.make_big_fixture, polished through the
    CLI (equal to its truth), with tools.qv before and after (the polished
    QV at least the assembly's); and a small aligned fixture from
    tools.make_fixture whose reads go through tools.align and
    tools.kmer_count again, polished by the CLI's cuda and oracle engines
    (equal outputs)."""
    from nextpolish2_tpu_torch.io.bam import BamReader
    from nextpolish2_tpu_torch.io.fastx import read_fastx
    from nextpolish2_tpu_torch.tools.qv import qv_of

    chr_ = os.path.join(work, "chr")
    gen_s = port_tool("tools.make_big_fixture", chr_, "--contigs", "1",
                      "--size", str(size), "--small", "0", "--cov", "30",
                      "--seed", "11")
    files = [chr_ + ".bam", chr_ + ".fa", chr_ + ".k21.yak"]
    pol = cli_polish(paths, "data_prep_chr_cli", files,
                     chr_ + ".polished.fa", dev)
    fasta_equal(chr_ + ".polished.fa", chr_ + ".truth.fa")
    qv = {}
    for label, fa in (("assembly", chr_ + ".fa"),
                      ("polished", chr_ + ".polished.fa")):
        def run():
            t0 = time.time()
            qv[label] = qv_of(fa, files[2], 5, dev)
            return {"wall_s": time.time() - t0, "result": str(qv[label])}

        paths.run(f"data_prep_qv_{label}", ("kmer_lookup",),
                  ("consensus_dp_v2", "consensus_dp_base",
                   "consensus_dp_dynk", "backtrack_packed",
                   "kmer_min_scores", SHARDED), run)
    if qv["polished"].qv < qv["assembly"].qv:
        fail(f"QV fell in polishing: {qv['assembly']} -> {qv['polished']}")
    bases = sum(len(s) for _, s in read_fastx(chr_ + ".fa"))

    small = os.path.join(work, "small")
    small_gen_s = port_tool("tools.make_fixture", small, "--contigs", "2",
                            "--size", "30000", "--cov", "30", "--seed", "13")
    with open(small + ".reads.fa", "wb") as f:
        for _tid, recs in BamReader(small + ".bam").by_contig():
            for r in recs:
                f.write(b">" + r.qname + b"\n" + r.seq + b"\n")
    align_s = port_tool("tools.align", small + ".fa", small + ".reads.fa",
                        small + ".realigned.bam")
    count_s = port_tool("tools.kmer_count", "-k", "21", "-o",
                        small + ".reads", small + ".reads.fa")
    args = [small + ".realigned.bam", small + ".fa", small + ".reads.k21.yak"]
    cuda = cli_polish(paths, "data_prep_small_cli", args, small + ".cuda.fa",
                      dev)
    oracle = cli_polish(paths, "data_prep_small_oracle",
                        args + ["--engine", "oracle"], small + ".oracle.fa",
                        dev, must=())
    with open(small + ".cuda.fa", "rb") as a, \
            open(small + ".oracle.fa", "rb") as b:
        if a.read() != b.read():
            fail("the small fixture: --engine cuda != --engine oracle")
    truth = dict(read_fastx(small + ".truth.fa"))
    same = sum(truth.get(n) == s for n, s in read_fastx(small + ".cuda.fa"))
    line = {"phase": "data_prep_chain",
            "chromosome": {"bases": bases, "make_big_fixture_s": gen_s,
                           "polish_wall_s": pol["wall_s"],
                           "identical_to": "truth",
                           "qv_assembly": str(qv["assembly"]),
                           "qv_polished": str(qv["polished"])},
            "small": {"contigs": len(truth), "make_fixture_s": small_gen_s,
                      "align_s": align_s, "kmer_count_s": count_s,
                      "cuda_wall_s": cuda["wall_s"],
                      "oracle_wall_s": oracle["wall_s"],
                      "cuda_equals_oracle": True,
                      "contigs_equal_to_truth": f"{same}/{len(truth)}"}}
    print(json.dumps(line), flush=True)
    return line


def with_env(values: dict, fn, *args, **kw):
    with env_set(**values):
        return fn(*args, **kw)


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "nextpolish2_tpu_torch")) or \
            not os.path.isdir(DATA):
        print("chip_smoke: run from the root of a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs an NVIDIA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}")

    # phase 1: builds (nvcc for the kernels, g++ for the host library, all
    # at once)
    from nextpolish2_tpu_torch.io import native
    from nextpolish2_tpu_torch.ops import consensus_cuda as cc

    t0 = time.time()
    native_ok = []
    th = threading.Thread(target=lambda: native_ok.append(native.available()))
    th.start()
    info = cc.build_kernels(force=True)
    th.join()
    if not native_ok[0]:
        fail("native host library did not build")
    print(json.dumps({"phase": "build", "route": "nvcc -shared + ctypes",
                      "arch": "sm_90a", "seconds": time.time() - t0,
                      "kernel_build_s": {k: v["seconds"]
                                         for k, v in info.items()},
                      "native_loaded": True}))
    for name, v in info.items():
        for line in v["log"].splitlines():
            if any(w in line for w in ("registers", "spill",
                                       "entry function")):
                print(f"ptxas {name}: {line.strip()}")
    # every kernel keeps its carry in registers: no instance may have a
    # stack frame or spill
    for name in cc.SOURCES:
        frames = re.findall(r"(\d+) bytes stack frame, (\d+) bytes spill "
                            r"stores, (\d+) bytes spill loads",
                            info[name]["log"])
        if not frames or any(int(x) for f in frames for x in f):
            fail(f"{name}: ptxas reports a stack frame or spills: {frames}")
    lap("1_build")

    # phase 2: kernels against their plain twins at the production shapes,
    # on E. coli windows; the slice adds the only K=48-tier window in the
    # test data (no E. coli window has more than 8 slots in a column)
    t0 = time.time()
    sources = [contig_windows("ecoli.fa", "ecoli.bam"),
               contig_windows("slice.fa", "slice.bam")]
    print(json.dumps({"phase": "windows", "seconds": time.time() - t0,
                      **{s["source"]: {
                          "windows": int(s["wb"].n_windows),
                          "wider_than_narrow_tier":
                              int((s["span"] > NARROW_W).sum()),
                          "k_tier_48": int((s["ktier"] == 48).sum())}
                         for s in sources}}))
    rows = {}
    for K, B, W in DP_SHAPES:
        for r in measure_shape(sources, K, B, W, dev):
            rows[(r["name"], K, B, W)] = r
    edge_case_check(dev)
    lap("2_dp_kernels")

    # phase 2b: the two k-mer kernels on E. coli's table
    kmer = kmer_phase(dev)
    rows.update(kmer["rows"])
    lap("2b_kmer_kernels")

    # phase 3: the main path (the k-mer routes stay below their thresholds
    # on every bundled contig, and no contig is long enough to segment)
    paths = Paths()
    off = KMER_KERNELS + (SHARDED,)
    paths.run(
        "main_path_ecoli", ("consensus_dp_v2", "backtrack_packed"),
        ("consensus_dp_base", "consensus_dp_dynk") + off,
        lambda: polish_check("ecoli.fa", "ecoli.bam", ["ecoli.k21.yak"],
                             "ecoli.truth.fa", "cuda"))
    if not native.available():
        fail("native host library not loaded on the main path")
    lap("3_main_path")

    # phase 4: the slice with two k-mer tables
    paths.run(
        "slice", ("consensus_dp_v2", "backtrack_packed"),
        ("consensus_dp_base", "consensus_dp_dynk") + off,
        lambda: polish_check("slice.fa", "slice.bam", ["k21.yak", "k31.yak"],
                             "slice.golden.fa", "cuda"))
    lap("4_slice")

    # phase 5: the other two DP formulations on their routes
    paths.run(
        "ecoli_dynk_dense_route", ("consensus_dp_dynk", "backtrack_packed"),
        ("consensus_dp_v2", "consensus_dp_base") + off,
        lambda: polish_check("ecoli.fa", "ecoli.bam", ["ecoli.k21.yak"],
                             "ecoli.truth.fa", "cuda", dp_variant="dynk"))
    paths.run(
        "slice_base_blob_route", ("consensus_dp_base", "backtrack_packed"),
        ("consensus_dp_v2", "consensus_dp_dynk") + off,
        lambda: polish_check("slice.fa", "slice.bam", ["k21.yak", "k31.yak"],
                             "slice.golden.fa", "cuda", dp_variant="base"))
    lap("5_dynk_base")

    # phase 6: 20 contigs through the cross-contig batcher, then one by one
    for threads in (8, 1):
        res = paths.run(
            f"m20_t{threads}", ("consensus_dp_v2", "backtrack_packed"),
            ("consensus_dp_base", "consensus_dp_dynk") + off,
            lambda: polish_check("m20.fa", "m20.bam", ["m20.k21.yak"],
                                 "m20.truth.fa", "cuda", threads=threads))
        if res["contigs"] != 20:
            fail(f"m20: {res['contigs']} contigs polished, expected 20")
        if threads > 1 and (res["batches"] == 0
                            or res["csr_batches"] != res["batches"]):
            fail(f"m20 -t {threads}: {res['csr_batches']}/{res['batches']} "
                 "batches were CSR-direct")
    lap("6_m20")

    # phase 7: the batcher's dense fallback on the card
    paths.run(
        "batcher_dense_fallback_v2", ("consensus_dp_v2", "backtrack_packed"),
        ("consensus_dp_base", "consensus_dp_dynk", SHARDED),
        lambda: dense_fallback_check(sources[0], dev, "v2", 640), keep=False)
    paths.run(
        "batcher_dense_fallback_dynk",
        ("consensus_dp_v2", "consensus_dp_dynk", "backtrack_packed"),
        ("consensus_dp_base", SHARDED),
        lambda: dense_fallback_check(sources[0], dev, "dynk", 640),
        keep=False)
    lap("7_dense_fallback")

    # phase 8: the segmented engine on the slice (5 kb segments) with both
    # k-mer routes forced onto the card: the only bundled contig whose
    # alleles reach the scorer (E. coli's segmented run is phase 10's)
    paths.run(
        "slice_segmented_device_kmer",
        ("consensus_dp_v2", "backtrack_packed") + KMER_KERNELS,
        ("consensus_dp_base", "consensus_dp_dynk", SHARDED),
        lambda: with_env({"NP2_SEG_FORCE": 1, "NP2_SEG_LEN": 5000,
                          "NP2_KMER_DEVICE_MIN": 1,
                          "NP2_KMER_SCORE_DEVICE_MIN": 1}, polish_check,
                         "slice.fa", "slice.bam", ["k21.yak", "k31.yak"],
                         "slice.golden.fa", "cuda"),
        segmented=True)
    lap("8_slice_segmented")

    # phase 9: 20 contigs, each segmented, through the batcher at -t 8
    res = paths.run(
        "m20_t8_segmented", ("consensus_dp_v2", "backtrack_packed"),
        ("consensus_dp_base", "consensus_dp_dynk") + off,
        lambda: with_env({"NP2_SEG_FORCE": 1, "NP2_SEG_LEN": 16384},
                         polish_check, "m20.fa", "m20.bam", ["m20.k21.yak"],
                         "m20.truth.fa", "cuda", threads=8),
        segmented=True)
    if res["contigs"] != 20 or res["segmented_contigs"] != 20 or \
            res["batches"] == 0:
        fail(f"m20 segmented -t 8: {res['segmented_contigs']} of "
             f"{res['contigs']} contigs segmented, {res['batches']} batches")
    lap("9_m20_segmented")

    # phase 10: E. coli whole-contig and segmented (device k-mer routes
    # forced), each in a child process, with their peak RSS
    memory_phase(paths)
    lap("10_ecoli_children")

    # phase 11: the sharded lookup kernel on E. coli's table in 2 shards
    shk = sharded_phase(kmer, dev)
    rows.update(shk["rows"])
    lap("11_sharded_lookup")

    # phase 12: the mesh path, MESH positions of the one card
    with_v2 = ("consensus_dp_v2", "backtrack_packed")
    not_v2 = ("consensus_dp_base", "consensus_dp_dynk") + KMER_KERNELS
    slice_yaks = ("slice.fa", "slice.bam", ["k21.yak", "k31.yak"],
                  "slice.golden.fa", "cuda")
    mesh_path(paths, "mesh_slice", with_v2, not_v2,
              lambda: polish_check(*slice_yaks), dev)
    mesh_path(paths, "mesh_slice_base",
              ("consensus_dp_base", "backtrack_packed"),
              ("consensus_dp_v2", "consensus_dp_dynk") + KMER_KERNELS,
              lambda: polish_check(*slice_yaks, dp_variant="base"), dev)
    mesh_path(paths, "mesh_slice_dynk",
              ("consensus_dp_dynk", "backtrack_packed"),
              ("consensus_dp_v2", "consensus_dp_base") + KMER_KERNELS,
              lambda: polish_check(*slice_yaks, dp_variant="dynk"), dev)
    mesh_path(paths, "mesh_ecoli", with_v2, not_v2,
              lambda: polish_check("ecoli.fa", "ecoli.bam",
                                   ["ecoli.k21.yak"], "ecoli.truth.fa",
                                   "cuda"), dev)
    res = mesh_path(paths, "mesh_m20_t8", with_v2, not_v2,
                    lambda: polish_check("m20.fa", "m20.bam",
                                         ["m20.k21.yak"], "m20.truth.fa",
                                         "cuda", threads=8), dev)
    if res["contigs"] != 20 or res["batches"] == 0 or \
            res["csr_batches"] != res["batches"]:
        fail(f"m20 -t 8 under the mesh: {res['csr_batches']}/"
             f"{res['batches']} batches CSR-direct, {res['contigs']} contigs")
    paths.run("mesh_batcher_sparse_fallback", with_v2, not_v2 + (SHARDED,),
              lambda: mesh_batcher_check(sources[0], dev, 640, MESH, False,
                                         "no_csr_closure"), keep=False)
    paths.run("mesh_batcher_shape_misalign", with_v2, not_v2 + (SHARDED,),
              lambda: mesh_batcher_check(sources[0], dev, 200, (3, 1), True,
                                         "shape_misalign"), keep=False)
    lap("12_mesh_paths")

    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=HERE) as work:
        # phase 13: two CLI processes share the card and split m20
        two_process_phase(work)
        lap("13_cli_two_processes")
        # phase 14: the CLI's --profile-dir on the slice
        paths.run("cli_profile_slice", with_v2, not_v2 + (SHARDED,),
                  lambda: profile_cli_check(work))
        lap("14_cli_profile")
        # phase 15: QV through the device k-mer table
        qv_phase(paths, kmer["km"], dev, rows)
        lap("15_qv_device_lookup")
        # phase 16: aggregate_windows and dp_backtrack_csr on an E. coli
        # chunk
        aggregate_csr_phase(paths, sources[0], dev)
        lap("16_aggregate_and_csr")
        # phase 17: the data-prep chain
        data_prep_phase(paths, work, dev)
        lap("17_data_prep_chain")

    # any other shape a path launched gets measured too (the twins once)
    for key in sorted(paths.shapes):
        if key in rows:
            continue
        if len(key) == 4:
            for r in measure_shape(sources, *key[1:], dev, plain_runs=1):
                rows[(r["name"], *key[1:])] = r
        elif key[0] == "kmer_lookup":
            rows[key] = measure_lookup(kmer["km"], key[1], dev,
                                       np.random.default_rng(12))[0]
        elif key[0] == SHARDED:
            rows[key] = measure_lookup_sharded(
                kmer["km"], shk["sh"], key[1], dev,
                np.random.default_rng(12), rows)
        else:
            row = measure_score(kmer["km"], kmer["seq"], key[1], dev,
                                np.random.default_rng(12), set())[0]
            rows[("kmer_min_scores", row["shape"]["N"])] = row
    # launches: per polish() path, and their sum
    for key, r in rows.items():
        r["launches_by_path"] = {phase: by_shape[key] for phase, by_shape
                                 in paths.by_path.items() if key in by_shape}
        r["launches"] = sum(r["launches_by_path"].values())
    for name in ALL_KERNELS:
        if not any(r["launches"] for k, r in rows.items() if k[0] == name):
            fail(f"{name} was launched on no path")
    lap("18_other_shapes")

    print(json.dumps({"phase": "timeline", "seconds_at_end": TIMELINE}))
    print(json.dumps({"kernels": [rows[k] for k in sorted(rows)]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rss-child"]:
        raise SystemExit(rss_child(sys.argv[2]))
    raise SystemExit(main())
