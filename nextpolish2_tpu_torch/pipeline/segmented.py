"""Bounded-memory segmented polishing for chromosome-scale contigs.

The whole-contig engine (engine.polish_contig_cuda) holds one entry per
aligned base resident (~20-32 B/entry incl. sort buffers): a 250 Mb contig at
30x is ~150-240 GB, beyond host RAM. The reference has the same O(contig)
per-worker footprint (per-contig Msa vector, main.rs:1734); this module
instead streams the contig in anchor-bounded SEGMENTS so resident state is
O(segment + consensus + LQ carryover):

  per iteration (main.rs:1819-1836 loop):
    pass A (ascending, one sequential BAM scan via io.native.RangeScanner):
      per segment: ingest reads overlapping [cut_k - 2, t_hi), window-plan
      [cut_k, cut_{k+1}] (cuts are anchors, chosen inside build_window_batch),
      run the device engine (engine.device_consensus_stream: the same chunk
      program and CUDA kernels as the whole-contig path), keep only the
      segment's REVERSED consensus stream piece (~7 B/base), free the read
      streams.
    global: concatenate pieces (descending) -> the exact whole-contig
      reversed backtrack stream -> lq_from_qv_stream (unchanged code).
    pass B (second sequential scan): per segment, re-ingest and run
      extract_alleles on the LQ regions routed by region.start, with local
      indices mapped to global read orders.
    global: retrieve_kmer_count; then phasing (iteration 1) or
      seed/splice/recheck (final iteration), all small-data, unchanged code.

Exactness: any anchor-bounded window plan reproduces the whole-contig DP
(pipeline/windows.py proof), and segment boundaries are just window
boundaries; LQ detection runs globally on the identical stream; extraction
decomposes exactly because every read that can reach a segment's regions
overlaps the segment's range (reads must CONTAIN a region to contribute,
main.rs:1447-1452) and the monotone extraction cursor's running-max state is
reproduced (np2_range_next extract_mode). tests/test_torch_segmented.py
byte-compares against the whole-contig engine, the JAX package's segmented
engine and the goldens.

Threads: the device is driven from the calling thread only (ChunkRunner
streams are per thread); the lookahead and sort workers run host code only,
and both drain before the scanner that owns their native state closes.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

import numpy as np

from ..config import PolishConfig
from ..io.yak import KmerTable
from ..models.oracle_align import AlignTags, ref_as_tags
from ..models.oracle_lq import (
    L_SUCC,
    extract_alleles,
    fill_seed_lqseqs,
    mark_hete_lqseqs,
    phase_reads_by_lqseqs,
    retrieve_kmer_count,
    reupdate_consensus_with_lqseqs,
    update_consensus_with_lqseqs,
)
from ..models.oracle_msa import Consensus, kmer_stream, lq_from_qv_stream
from ..utils.seqcodes import ASCII2CODE
from ..utils.timing import carry, stage
from .windows import SegmentCutError, WindowOverflow


def seg_len() -> int:
    """Nominal segment length in bases. The peak RSS follows it, not the
    contig: about 2.2 GB per Mi of segment plus 9.2 GB, some 70 B per
    aligned base with two segments live at once (the lookahead); measured
    on a 62.2 Mb contig at 30x on an H100 host, 44.6 GB at 16 Mi and 18.1
    GB at 4 Mi (PERF.md)."""
    return int(os.environ.get("NP2_SEG_LEN", str(16 << 20)))


def seg_threshold() -> int:
    """Contig length above which the segmented engine takes over."""
    return int(os.environ.get("NP2_SEG_MIN", str(48 << 20)))


def use_segmented(n_pos: int) -> bool:
    if os.environ.get("NP2_SEG_FORCE"):
        return True
    if os.environ.get("NP2_NO_SEG"):
        return False
    return n_pos >= seg_threshold()


def _seg_alignseqs(r: dict, codes: np.ndarray, relmax: int,
                   dropped_orders: set) -> tuple:
    """(alignseqs, flat) for one segment fetch, mirroring
    oracle.build_alignseqs_native_flat's layout: ref pseudo-alignment first
    (covering the segment's local range [0, relmax]), then the fetched reads
    in global order; clip-filter and phasing drops applied."""
    base = r["base"]
    nref = relmax + 1
    ref_rel = codes[base : base + nref]
    n = len(r["t"])
    t_full = np.empty(nref + n, dtype=np.int32)
    t_full[:nref] = np.arange(nref, dtype=np.int32)
    t_full[nref:] = r["t"]
    k_full = np.empty(nref + n, dtype=np.int32)
    rk = kmer_stream(ref_as_tags(ref_rel))[1]
    k_full[:nref] = rk.astype(np.uint32).view(np.int32)
    k_full[nref:] = r["k"]
    q_full = np.empty(nref + n, dtype=np.uint8)
    np.bitwise_and(k_full, 0xF, out=q_full, casting="unsafe")

    ref_tags = AlignTags(aln_t_s=0, aln_t_e=nref - 1, t_pos=t_full[:nref],
                         q_base=q_full[:nref], kkey=k_full[:nref])
    alignseqs: List[AlignTags] = [ref_tags]
    nr = len(r["orders"])
    ends = np.append(r["read_start"][1:], n)
    bounds = r["bounds"]
    clip_drop = r["clip_drop"]
    orders = r["orders"]
    for i in range(nr):
        s, e = int(r["read_start"][i]), int(ends[i])
        a = AlignTags(
            aln_t_s=int(bounds[i, 0]), aln_t_e=int(bounds[i, 1]),
            t_pos=t_full[nref + s : nref + e],
            q_base=q_full[nref + s : nref + e],
            kkey=k_full[nref + s : nref + e])
        if clip_drop[i] or int(orders[i]) in dropped_orders:
            a.dropped = True
        alignseqs.append(a)
    aoff = np.empty(nr + 2, dtype=np.int64)
    aoff[0] = 0
    aoff[1] = nref
    aoff[2:] = nref + ends
    flat = {"t": t_full, "k": k_full, "q": q_full, "aoff": aoff}
    return alignseqs, flat


def _pass_a(tseq_len: int, codes: np.ndarray, cfg: PolishConfig,
            bam_path: str, tid: int, dropped_orders: set, sl: int,
            runner, variants) -> tuple:
    """One ascending DP sweep. Returns (pieces, cuts, best_sum): pieces are
    per-segment reversed-stream tuples (pos_i32_abs, base_u8, qv_u8, low_b)
    in ascending segment order; cuts = [0, c1, ..., tseq_len] the realized
    segment boundaries (anchors).

    Software pipeline: segment k+1's range is fixed the moment segment k's
    window plan lands (its realized cut: the engine's on_plan callback), so
    the k+1 scan + prefault + alignseqs assembly run on a single lookahead
    worker while segment k's aggregation + device DP run here. ONE worker
    serializes every scanner call, so the scan order (and therefore every
    order-dependent native state: carry set, clip chain, order counters) is
    exactly the serial loop's."""
    from ..io.native import (RangeScanner, find_anchors_runs_native, prefault,
                             sort_stream_runs_native)
    from .engine import device_consensus_stream
    from .windows import _start_counts

    pieces: List[tuple] = []
    cuts: List[int] = [0]
    best_sum = 0
    slack = max(8192, sl // 64)
    per_entry = int(os.environ.get("NP2_PREFAULT_PER_ENTRY", "32"))
    state = {"prev_ns": 0}
    pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="np2seg")
    # second worker: the per-segment stream sort (consumed lazily by
    # build_window_batch AFTER the plan fires on_plan, so the next
    # segment's scan on `pool` overlaps this segment's sort here)
    sort_pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="np2sort")
    # the pools MUST drain before the scanner closes (a lookahead ingest on a
    # freed native handle would fault), hence shutdown inside the with block
    with RangeScanner(bam_path, tid, codes, cfg) as sc:
        try:

            def seg_geom(cut_abs: int) -> tuple:
                nominal_hi = min(cut_abs + sl, tseq_len)
                last = nominal_hi >= tseq_len
                t_hi = tseq_len if last else min(nominal_hi + slack, tseq_len)
                return nominal_hi, last, t_hi

            def ingest(cut_abs: int, t_hi: int, last: bool) -> tuple:
                # pre-provision BEFORE the segment's allocations (sized from
                # the previous segment: segment streams are near-uniform),
                # so the faulted heap is REUSED by them; runs on the
                # lookahead worker, the same thread that then allocates
                if state["prev_ns"] * per_entry >= (256 << 20):
                    with stage("ingest_prefault"):
                        prefault(state["prev_ns"] * per_entry, 8)
                with stage("seg_ingest"):
                    r = sc.next(max(cut_abs - 2, 0), t_hi)
                base = r["base"]
                # the chosen cut can land anywhere <= t_hi - 2 (first anchor
                # past nominal when none lies below), so the segment-local
                # frame must cover that far
                relmax = (tseq_len - 1 - base) if last \
                    else max(r["maxt"], t_hi - 2) - base
                state["prev_ns"] = len(r["t"]) + relmax + 1
                alignseqs, flat = _seg_alignseqs(r, codes, relmax,
                                                 dropped_orders)
                cache: dict = {"flat_all": flat}
                # anchors from the UNSORTED run stream (order-independent
                # per-column aggregates; bit-identical to the sorted sweep),
                # so the window plan, and with it the NEXT segment's cut,
                # lands without waiting for the sort, which runs on its own
                # worker and is resolved only after the plan fires on_plan
                # (build_window_batch): scan(k+1) overlaps sort(k)
                n_loc = relmax + 1
                drop = np.array([a.dropped or len(a) == 0
                                 for a in alignseqs], dtype=np.uint8)
                with stage("find_anchors"):
                    cache["anchors"] = find_anchors_runs_native(
                        flat["t"], flat["k"], flat["aoff"], drop, n_loc,
                        codes[base : base + n_loc],
                        _start_counts(alignseqs, n_loc))
                # reuse sort output buffers (already-provisioned pages),
                # DOUBLE-buffered: segment k+2 reuses segment k's pair; by
                # the time its sort runs (submitted here, after plan k+1
                # consumed segment k) the calling thread has released
                # segment k's sorted views
                flip = state.get("flip", 0)
                state["flip"] = flip ^ 1
                pair = state.setdefault("sort_bufs", [None, None])

                def sort_task(flip=flip, drop=drop, flat=flat, n_loc=n_loc):
                    t_buf, k_buf = pair[flip] or (None, None)
                    with stage("stream_sort"):
                        t_s, k_s, maxd = sort_stream_runs_native(
                            flat["t"], flat["k"], flat["aoff"], drop, n_loc,
                            t_buf, k_buf)
                    if maxd >= (1 << 14):
                        raise WindowOverflow(
                            "delta overflow: insertion run >= 16384 columns")
                    pair[flip] = (
                        t_s.base if t_s.base is not None else t_s,
                        k_s.base if k_s.base is not None else k_s)
                    return t_s, k_s

                cache["sorted_future"] = sort_pool.submit(carry(sort_task))
                return base, relmax, alignseqs, cache

            cut = 0
            first = True
            nominal_hi, last, t_hi = seg_geom(0)
            fut = pool.submit(carry(ingest), 0, t_hi, last)
            while True:
                look: dict = {}
                while True:
                    base, relmax, alignseqs, stream_cache = fut.result()
                    info: dict = {}

                    def on_plan(cut_local: int, base=base, last=last,
                                look=look) -> None:
                        # segment k's realized cut is final: start segment
                        # k+1's ingest on the worker NOW, overlapping this
                        # segment's aggregation + device DP
                        if last:
                            return
                        nxt = cut_local + base
                        g = seg_geom(nxt)
                        look["next"] = (nxt, g)
                        look["fut"] = pool.submit(
                            carry(ingest), nxt, g[2], g[1])

                    try:
                        pos, b, qv, low = device_consensus_stream(
                            alignseqs, relmax + 1,
                            codes[base : base + relmax + 1],
                            cfg, runner, variants, stream_cache,
                            plan_start=cut - base,
                            plan_end=(relmax if last else None),
                            plan_end_nominal=(None if last
                                              else nominal_hi - base),
                            plan_end_max=(None if last else t_hi - 2 - base),
                            first_keep_ge=first, out_info=info,
                            on_plan=on_plan)
                        break
                    except SegmentCutError:
                        if t_hi >= tseq_len:
                            # retry with plan_end forced to the contig end
                            last = True
                            t_hi = tseq_len
                        else:
                            t_hi = min(t_hi + sl, tseq_len)
                        # extension re-scan: same t_lo, larger t_hi (the
                        # scanner supports this); no lookahead is pending
                        # because on_plan only fires after a plan succeeds
                        fut = pool.submit(carry(ingest), cut, t_hi, last)
                best_sum += info["best_sum"]
                pieces.append(((pos + base).astype(np.int32),
                               b.astype(np.uint8, copy=False),
                               qv.astype(np.uint8, copy=False),
                               low.astype(bool, copy=False)))
                first = False
                if last:
                    break
                cut, (nominal_hi, last, t_hi) = look["next"]
                fut = look["fut"]
                cuts.append(cut)
        finally:
            pool.shutdown(wait=True)
            sort_pool.shutdown(wait=True)
    cuts.append(tseq_len)
    return pieces, cuts, best_sum


def _pass_b(lqseqs, cuts: Sequence[int], tseq_len: int, codes: np.ndarray,
            cfg: PolishConfig, bam_path: str, tid: int,
            dropped_orders: set, table: KmerTable) -> None:
    """One ascending extraction sweep: fill each LQ region's candidate
    alleles from the segment that owns it (by region.start)."""
    from ..io.native import RangeScanner

    if not lqseqs:
        return
    starts = np.fromiter((r.start for r in lqseqs), np.int64, len(lqseqs))
    ksize = table.ksize
    pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="np2segb")
    # the pool drains before the scanner closes (as in _pass_a)
    with RangeScanner(bam_path, tid, codes, cfg) as sc:
        try:

            def scan(lo: int, hi: int) -> dict:
                with stage("seg_ingest"):
                    return sc.next(lo, hi, extract_mode=True)

            # one-segment lookahead: all ranges are known up front (the
            # pass-A cuts), so segment k+1's scan overlaps segment k's
            # extraction; the single worker keeps scanner calls in order
            fut = pool.submit(carry(scan), cuts[0], cuts[1])
            for k in range(len(cuts) - 1):
                lo_c, hi_c = cuts[k], cuts[k + 1]
                idx = np.nonzero((starts >= lo_c) & (starts < hi_c))[0]
                r = fut.result()
                if k + 2 < len(cuts):
                    fut = pool.submit(
                        carry(scan), cuts[k + 1], cuts[k + 2])
                if not len(idx):
                    continue
                regs = [lqseqs[int(j)] for j in idx]  # descending order kept
                base = r["base"]
                relmax = max(int(r["maxt"]),
                             max(rg.end for rg in regs) + ksize + 2) - base
                relmax = min(relmax, tseq_len - 1 - base)
                alignseqs, flat = _seg_alignseqs(r, codes, relmax,
                                                 dropped_orders)
                order_map = np.concatenate(
                    [np.zeros(1, np.int64), r["orders"]])
                with stage("extract_alleles"):
                    extract_alleles(
                        alignseqs, regs, table, cfg.lqseq_max_can_count,
                        cache={"ea_concat": (flat["t"], flat["q"],
                                             flat["aoff"])},
                        coord_offset=base, order_map=order_map)
        finally:
            pool.shutdown(wait=True)


def polish_contig_cuda_segmented(tseq: bytes, tables: Sequence[KmerTable],
                                 cfg: Optional[PolishConfig],
                                 bam_path: str, tid: int, *, device=None,
                                 dp_variant=None) -> Consensus:
    """Segmented equivalent of engine.polish_contig_cuda for one long contig
    (its device and dp_variant arguments mean the same; with an active
    cross-contig batcher the segments' chunks go through it).

    Requires the native library (RangeScanner); output is byte-identical to
    the whole-contig engine. There is no oracle fallback at this scale: a
    WindowOverflow (degenerate input) propagates.
    """
    from ..utils.torchcfg import resolve_device
    from .batcher import get_active_batcher
    from .engine import ChunkRunner, _stat, resolve_dp_variants

    dev = resolve_device(device)
    variants = resolve_dp_variants(dp_variant)
    runner = None if get_active_batcher() is not None else ChunkRunner(dev)
    _stat("segmented_contigs")
    cfg = cfg or PolishConfig()
    tables = sorted(tables, key=lambda t: t.ksize)
    codes = ASCII2CODE[np.frombuffer(tseq, dtype=np.uint8)]
    n_pos = len(tseq)
    sl = seg_len()
    dropped_orders: set = set()

    for i in range(cfg.iter_count):
        out_cns = i + 1 == cfg.iter_count
        pieces, cuts, best_sum = _pass_a(n_pos, codes, cfg, bam_path, tid,
                                         dropped_orders, sl, runner, variants)
        _stat("segments", len(pieces))
        # the whole-contig default-kmer check, once per iteration over the
        # sum of every segment's window maxima (main.rs:1651)
        if best_sum < 0:
            raise WindowOverflow(
                "global best score < 0 (degenerate default kmer)")
        # global reversed stream = segment pieces in DESCENDING genome order
        pieces.reverse()
        pos = np.concatenate([p[0] for p in pieces])
        b = np.concatenate([p[1] for p in pieces])
        qv = np.concatenate([p[2] for p in pieces])
        low = np.concatenate([p[3] for p in pieces])
        del pieces
        with stage("lq_detect"):
            cb, lqseqs = lq_from_qv_stream(pos.astype(np.int64), b, qv, low,
                                           cfg.hq_min_qv, cfg.lq_min_length)
        del pos, b, qv, low
        if not lqseqs:
            if out_cns:
                return cb
            continue
        _pass_b(lqseqs, cuts, n_pos, codes, cfg, bam_path, tid,
                dropped_orders, tables[0])
        with stage("kmer_scoring"):
            retrieve_kmer_count(lqseqs, tables[0], cfg.min_kmer_count)
        if out_cns:
            with stage("splice_recheck"):
                fill_seed_lqseqs(lqseqs, cfg.max_indel_len,
                                 cfg.lqseq_max_can_count)
                consensus = update_consensus_with_lqseqs(lqseqs, cb, L_SUCC)
                for p, table in enumerate(tables):
                    consensus = reupdate_consensus_with_lqseqs(
                        lqseqs, consensus, table, cfg.min_kmer_count, p + 1,
                        cfg.lqseq_max_can_count)
            return consensus
        with stage("phasing"):
            mark_hete_lqseqs(lqseqs, cfg.lqseq_max_can_count)
            invalid = phase_reads_by_lqseqs(lqseqs, cfg.model == "ref",
                                            cfg.use_all_reads)
        dropped_orders.update(int(o) for o in invalid)
    raise AssertionError("unreachable")
