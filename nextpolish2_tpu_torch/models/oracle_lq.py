"""Oracle LQ-interval machinery: candidate-allele extraction, yak k-mer scoring,
heterozygous-site marking, read phasing glue, seed filling, consensus splicing and
the multi-k recheck cascade.

Faithful reimplementation of reference src/main.rs:647-1543. One deliberate
difference: the reference re-streams each .yak file from disk per scoring call
(retrieve_kmer_count -> KmerInfo::retrieve_kmers); we query the resident KmerTable
directly — get(hash, min_count) is the exact composition of the reference's
candidate-insert + file-scan + get.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from itertools import product as cartesian_product
from typing import Dict, List, Optional

import numpy as np

from ..config import PolishConfig
from ..io.yak import INVALID_KMER, KmerTable
from ..utils import timing
from ..utils.seqcodes import CODE2ASCII
from .louvain import assign_data, insert_data, new_data, phase_communities
from .oracle_align import AlignTags
from .oracle_msa import Consensus, LqRegion

# label bits (main.rs:655-658)
L_TEMP = 0b0000_0001
L_SUCC = 0b1000_0000
L_HETE = 0b0100_0000
L_RECH = 0b0010_0000

INVALID = int(INVALID_KMER)

# batch_min_kscores scores a batch of at least this many bases on the device
# (NP2_KMER_SCORE_DEVICE_MIN overrides) when its table has use_device set and
# fits the card. chip_smoke.py's k-mer phase on an H100 (PERF.md): the fused
# device scorer, upload and download included, beats the host chain from
# the smallest batch measured (2^12 bases); with the one-time device build
# of E. coli's table added it breaks even from 2^16 to 2^18
KMER_SCORE_DEVICE_MIN = 1 << 16


@dataclass(slots=True)
class LqSeq:
    order: int
    kscore: int
    kmer: int  # full yak hash, or INVALID
    seq: bytes


def extract_alleles(alignseqs: List[AlignTags], lqseqs: List[LqRegion],
                    table: KmerTable, max_can: int = 60,
                    cache: Optional[dict] = None,
                    coord_offset: int = 0,
                    order_map: Optional[np.ndarray] = None) -> None:
    """Per-read allele extraction over LQ intervals
    (generate_lqseqs_from_tags_kmer first half, main.rs:1429-1523).

    lqseqs are in DESCENDING genome order. alignseqs[0] must be the reference
    pseudo-alignment (order 0). Appends LqSeq entries in read order.

    Dispatches to the native implementation (np2_extract_alleles: one walk
    over each read's tags) when available; _extract_alleles_py below is the
    executable spec and the fallback (differential-tested in
    tests/test_torch_lq_front.py). `cache` (any
    dict, e.g. the engine's per-contig stream_cache) persists the concatenated
    tag arrays across phasing iterations.

    Segmented use (pipeline/segmented.py): coord_offset rebases the regions'
    absolute coordinates into the segment-local frame of alignseqs;
    order_map maps a local alignseq index to its global read order (the
    LqSeq.order the phasing graph keys on; index 0 = ref = 0)."""
    from ..io.native import extract_alleles_native

    if coord_offset:
        # shallow rebasing proxies sharing the real regions' seqs lists:
        # appends land on the caller's objects, coordinates go local
        lqseqs_local = [LqRegion(start=r.start - coord_offset,
                                 end=r.end - coord_offset, label=r.label,
                                 sudoseed=r.sudoseed, seqs=r.seqs)
                        for r in lqseqs]
    else:
        lqseqs_local = lqseqs
    lqseqs = lqseqs_local
    if len(lqseqs) and len(alignseqs):
        cache = cache if cache is not None else {}
        if "ea_concat" not in cache:
            lens = np.fromiter((len(a) for a in alignseqs), np.int64,
                               len(alignseqs))
            aoff = np.zeros(len(alignseqs) + 1, dtype=np.int64)
            np.cumsum(lens, out=aoff[1:])
            t_pos_all = (np.concatenate([a.t_pos for a in alignseqs])
                         if aoff[-1] else np.zeros(0, np.int32))
            q_base_all = (np.concatenate([a.q_base for a in alignseqs])
                          if aoff[-1] else np.zeros(0, np.uint8))
            cache["ea_concat"] = (t_pos_all, q_base_all, aoff)
        t_pos_all, q_base_all, aoff = cache["ea_concat"]
        aln_t_s = np.fromiter((a.aln_t_s for a in alignseqs), np.int64,
                              len(alignseqs))
        aln_t_e = np.fromiter((a.aln_t_e for a in alignseqs), np.int64,
                              len(alignseqs))
        active = np.fromiter((not a.dropped and len(a) > 0
                              for a in alignseqs), bool, len(alignseqs))
        rstart = np.fromiter((r.start for r in lqseqs), np.int64, len(lqseqs))
        rend = np.fromiter((r.end for r in lqseqs), np.int64, len(lqseqs))
        nseq0 = np.fromiter((len(r.seqs) for r in lqseqs), np.int32,
                            len(lqseqs))
        from ..utils.timing import stage

        with stage("extract_native"):
            res = extract_alleles_native(t_pos_all, q_base_all, aoff, aln_t_s,
                                         aln_t_e, active, rstart, rend, nseq0,
                                         table.ksize, max_can)
        if res is not None:
            region, order, soff, seq, prehash, has, pairs = res
            timing.count("lq.read_regions", pairs)
            timing.count("lq.alleles", len(region))
            if order_map is not None:
                order = order_map[order].astype(np.int32, copy=False)
            with stage("extract_materialize"):
                hashes = np.zeros(len(prehash), np.uint64)
                hi = np.nonzero(has)[0]
                if len(hi):
                    hashes[hi] = table.to_hash(prehash[hi]).astype(np.uint64)
                from ..io.native import load_obj

                obj = load_obj()
                if obj is not None:
                    # C bulk builder: creates the LqSeq objects and appends
                    # them to each region's seqs list in one native loop
                    obj.build_lqseqs([r.seqs for r in lqseqs],
                                     np.ascontiguousarray(region, np.int32),
                                     np.ascontiguousarray(order, np.int32),
                                     hashes, np.ascontiguousarray(has, np.uint8),
                                     np.ascontiguousarray(soff, np.int64),
                                     seq.tobytes(), INVALID)
                    return
                sbytes = seq.tobytes()
                soff_l = soff.tolist()
                kmer_l = np.where(has.astype(bool), hashes,
                                  np.uint64(INVALID)).tolist()
                order_l = order.tolist()
                for i, r in enumerate(region.tolist()):
                    lqseqs[r].seqs.append(LqSeq(
                        order_l[i], 0, kmer_l[i],
                        sbytes[soff_l[i]:soff_l[i + 1]]))
            return
    _extract_alleles_py(alignseqs, lqseqs, table, max_can, order_map=order_map)


def _extract_alleles_py(alignseqs: List[AlignTags], lqseqs: List[LqRegion],
                        table: KmerTable, max_can: int = 60,
                        order_map: Optional[np.ndarray] = None) -> None:
    """Pure-Python spec for extract_alleles (kept as differential oracle)."""
    ksize = table.ksize
    # The reference's per-allele rolling k-mer (main.rs:1433-1434, 1488-1492)
    # packs 2 bits/base into a u64 unconditionally. With a k >= 32 smallest
    # table (no documented config does this; option.rs:238 sorts tables by k)
    # a release Rust build still runs: `<<` masks the shift amount mod 64
    # (RFC 560), so for k = 32 `mask = (1 << 64) - 1` becomes 0 (fwd k-mer
    # pinned at 0) and for k > 32 `shift`/`mask` wrap mod 64. We mirror those
    # exact wrapped semantics for behavioral parity.
    shift = np.uint64((2 * (ksize - 1)) & 63)
    mask = np.uint64(((1 << ((2 * ksize) & 63)) - 1) & 0xFFFFFFFFFFFFFFFF)
    s = len(lqseqs) - 1
    # pass 1: per alignment, vectorized region slicing; the k-mer rolling and
    # yak hashing are deferred so they run ONCE over all alleles (pass 2)
    pend: List[tuple] = []   # (lqseq, order, chars, kb_row index or -1)
    kb_rows: List[np.ndarray] = []
    n_queued: Dict[int, int] = {}  # id(lqseq) -> queued append count
    pairs = 0  # (read, region) pairs visited
    for idx, a in enumerate(alignseqs):
        if a.dropped or len(a) == 0:
            continue
        while s > 0 and lqseqs[s].start < a.aln_t_s:
            s -= 1
        if lqseqs[s].start < a.aln_t_s or lqseqs[s].end > a.aln_t_e:
            continue
        j = s
        while j > 0 and lqseqs[j].end <= a.aln_t_e:
            j -= 1
        if lqseqs[j].end > a.aln_t_e:
            j += 1

        # decode tags until t_pos > lqseqs[j].end + ksize (main.rs:1462-1471)
        stop = int(np.searchsorted(a.t_pos, lqseqs[j].end + ksize, side="right"))
        t_pos = a.t_pos[:stop + 1] if stop < len(a) else a.t_pos
        q_base = a.q_base[: len(t_pos)]
        # vectorized inner loop: valid (non-gap) tags sorted by t_pos; per region
        # the allele = valid bases in [start, end], the kmer = first ksize valid
        # bases from start (may run past end), exactly the reference scan
        vi = np.nonzero(q_base != 4)[0]
        vpos = t_pos[vi]
        vq = q_base[vi]

        regs = lqseqs[j : s + 1]
        pairs += len(regs)
        starts = np.fromiter((r.start for r in regs), np.int64, len(regs))
        ends = np.fromiter((r.end for r in regs), np.int64, len(regs))
        i0s = np.searchsorted(vpos, starts, side="left")
        i1s = np.searchsorted(vpos, ends, side="right")
        for r, lqseq in enumerate(regs):
            if len(lqseq.seqs) + n_queued.get(id(lqseq), 0) >= max_can:
                continue
            i0, i1 = int(i0s[r]), int(i1s[r])
            if i1 <= i0:
                continue  # empty allele -> the reference appends nothing
            chars = CODE2ASCII[vq[i0:i1]].tobytes()
            if i0 + ksize <= len(vq):
                kb_rows.append(vq[i0 : i0 + ksize])
                row = len(kb_rows) - 1
            else:
                row = -1
            pend.append((lqseq, idx, chars, row))
            n_queued[id(lqseq)] = n_queued.get(id(lqseq), 0) + 1

    # pass 2: one vectorized rolling over all k-mer windows + one batched
    # to_hash. Raw rolling with q_base used unchecked incl N/M codes —
    # reference main.rs:1488-1492 does the same; numpy uint64 shifts wrap
    # like Rust release shl, preserving the k >= 32 wrapped semantics.
    hashes = np.zeros(0, np.uint64)
    if kb_rows:
        kb = np.stack(kb_rows).astype(np.uint64)
        k_fwd = np.zeros(len(kb), np.uint64)
        k_rev = np.zeros(len(kb), np.uint64)
        three, two = np.uint64(3), np.uint64(2)
        for step in range(ksize):
            qb = kb[:, step]
            k_fwd = ((k_fwd << two) | qb) & mask
            k_rev = (k_rev >> two) | ((three ^ qb) << shift)
        hashes = table.to_hash(np.minimum(k_fwd, k_rev)).astype(np.uint64)
    timing.count("lq.read_regions", pairs)
    timing.count("lq.alleles", len(pend))
    for lqseq, idx, chars, row in pend:
        lqseq.seqs.append(LqSeq(
            order=int(order_map[idx]) if order_map is not None else idx,
            kscore=0,
            kmer=int(hashes[row]) if row >= 0 else INVALID,
            seq=chars,
        ))


def batch_min_kscores(seqs: List[bytes], table: KmerTable,
                      min_kmer_count: int) -> np.ndarray:
    """min k-mer count per sequence in ONE batched lookup.

    Sequences are joined with an 'N' separator (invalid bases reset the rolling
    window, so no k-mer crosses a boundary); one rolling pass + one table query
    covers the whole batch — the batched-gather formulation of the reference's
    per-allele scans (main.rs:740-778).
    """
    if not seqs:
        return np.zeros(0, dtype=np.int64)
    from ..io.yak import rolling_kmers
    from ..utils.seqcodes import seq_to_codes

    from ..utils.timing import stage

    # device route: the WHOLE chain (rolling k-mer -> yak hash -> probe ->
    # per-allele min) in one kernel launch from the raw bytes
    # (ops/kmer_score.py), for a batch of at least NP2_KMER_SCORE_DEVICE_MIN
    # bases (default KMER_SCORE_DEVICE_MIN); both routes are exact
    if table.ksize < 32 and table.device_route(
            sum(len(s) for s in seqs), "NP2_KMER_SCORE_DEVICE_MIN",
            KMER_SCORE_DEVICE_MIN):
        from ..ops.kmer_score import device_min_kscores

        with stage("kscore_device"):
            out = device_min_kscores(table, seqs, min_kmer_count)
        return out.astype(np.int64)

    with stage("kscore_roll"):
        joined = b"N".join(seqs)
        kmers, valid = rolling_kmers(seq_to_codes(joined), table.ksize)
    out = np.zeros(len(seqs), dtype=np.int64)
    vidx = np.nonzero(valid)[0]
    if len(vidx):
        with stage("kscore_lookup"):
            counts = table.get(table.to_hash(kmers[vidx]), min_kmer_count)
        # map each valid end position to its sequence id
        starts = np.zeros(len(seqs), dtype=np.int64)
        lens = np.fromiter((len(s) for s in seqs), dtype=np.int64,
                           count=len(seqs))
        np.cumsum(lens[:-1] + 1, out=starts[1:])
        sid = np.searchsorted(starts, vidx, side="right") - 1
        # per-seq min over counts (0 participates; absent k-mer -> score 0)
        mins = np.full(len(seqs), np.iinfo(np.int64).max, dtype=np.int64)
        np.minimum.at(mins, sid, counts.astype(np.int64))
        has = np.zeros(len(seqs), dtype=bool)
        has[sid] = True
        out = np.where(has, np.where(mins == np.iinfo(np.int64).max, 0, mins), 0)
    return out


def retrieve_kmer_count(lqseqs: List[LqRegion], table: KmerTable,
                        min_kmer_count: int) -> None:
    """Score each allele by its min k-mer count (main.rs:740-778), batched."""
    ksize = table.ksize
    from ..io.native import load_obj

    obj = load_obj()
    parts = None
    if obj is not None and hasattr(obj, "collect_score_jobs"):
        try:
            # one C pass over ~150k alleles (np2obj.collect_score_jobs);
            # TypeError = dataclass-spec LqSeqs -> the Python twin below
            parts = obj.collect_score_jobs(lqseqs, ksize, INVALID)
        except TypeError:
            parts = None
    if parts is not None:
        long_refs, long_seqs, single_refs, single_hashes = parts
    else:
        long_refs: List[LqSeq] = []
        long_seqs: List[bytes] = []
        single_refs: List[LqSeq] = []
        single_hashes: List[int] = []
        for lqseq in lqseqs:
            for seq in lqseq.seqs:
                if len(seq.seq) > ksize:
                    long_refs.append(seq)
                    long_seqs.append(seq.seq)
                elif seq.kmer != INVALID:
                    single_refs.append(seq)
                    single_hashes.append(seq.kmer)

    def put(refs, scores):
        scores = np.ascontiguousarray(scores, dtype=np.int64)
        if parts is not None and hasattr(obj, "assign_kscores"):
            obj.assign_kscores(refs, scores)
            return
        for s, v in zip(refs, scores.tolist()):
            s.kscore = v

    if long_seqs:
        put(long_refs, batch_min_kscores(long_seqs, table, min_kmer_count))
    if single_hashes:
        from ..utils.timing import stage

        with stage("kscore_single"):
            # dedup: the same short allele recurs across a region's ~60
            # candidates and across regions (chr-scale contigs carry
            # millions of single-kmer alleles but only ~1e5 distinct
            # hashes) — one unique-lookup + inverse gather
            arr = np.array(single_hashes, dtype=np.uint64)
            uniq, inv = np.unique(arr, return_inverse=True)
            counts = table.get(uniq, min_kmer_count)[inv]
        put(single_refs, counts)


def is_valid_snp(seq1: bytes, seq2: bytes) -> bool:
    """Homopolymer-compressed inequality (main.rs:780-801)."""
    i = j = 0
    n1, n2 = len(seq1), len(seq2)
    while i < n1 and j < n2:
        if seq1[i] != seq2[j]:
            return True
        while i + 1 < n1 and seq1[i] == seq1[i + 1]:
            i += 1
        while j + 1 < n2 and seq2[j] == seq2[j + 1]:
            j += 1
        i += 1
        j += 1
    return False


def get_min_count(c: int) -> int:
    """Coverage-scaled minimum allele support (main.rs:803-811)."""
    if c >= 9:
        return 3
    if c >= 6:
        return 2
    return 1


def fill_order_stat(lqseq: LqRegion, stats: List[int],
                    order_stat: Dict[int, int]) -> tuple[int, int, int, int]:
    """Allele-identity counting + top-2 stats (main.rs:813-849).

    Returns (max1_c, max1_p, max2_c, max2_p); fills stats (per seq index) and
    order_stat (first-occurrence order -> count).

    O(n) grouping formulation of the reference's O(n^2) identity scan
    (allele bytes hashed once each instead of compared pairwise); the scan
    order and tie rules are untouched. _fill_order_stat_scalar below is the
    literal port, kept as the differential spec."""
    max1_c = max1_p = max2_c = max2_p = 0
    for i in range(len(stats)):
        stats[i] = 0
    order_stat.clear()
    seqs = lqseq.seqs
    groups: Dict[bytes, List[int]] = {}
    for p, s in enumerate(seqs):
        groups.setdefault(s.seq, []).append(p)
    for p1, seq in enumerate(seqs):
        if seq.kscore <= 0:
            continue
        if stats[p1] > 0:
            continue
        members = groups[seq.seq]  # ascending positions
        from bisect import bisect_left

        c = len(members) - bisect_left(members, p1)
        order_stat[seq.order] = c
        for p2 in members:
            if p2 >= p1:
                stats[p2] = c
        if c > max1_c or (c == max1_c and seq.order == 0):
            max2_c = max1_c
            max2_p = max1_p
            max1_c = c
            max1_p = p1
        elif max1_p == max2_p or c > max2_c:
            max2_c = c
            max2_p = p1
    return max1_c, max1_p, max2_c, max2_p


def _fill_order_stat_scalar(lqseq: LqRegion, stats: List[int],
                            order_stat: Dict[int, int]
                            ) -> tuple[int, int, int, int]:
    """Literal port of main.rs:813-849 (differential spec for
    fill_order_stat)."""
    max1_c = max1_p = max2_c = max2_p = 0
    for i in range(len(stats)):
        stats[i] = 0
    order_stat.clear()
    seqs = lqseq.seqs
    for p1, seq in enumerate(seqs):
        if seq.kscore <= 0:
            continue
        if stats[p1] > 0:
            continue
        c = sum(1 for x in seqs[p1:] if x.seq == seq.seq)
        order_stat[seq.order] = c
        for p2, x in enumerate(seqs[p1:]):
            if x.seq == seq.seq:
                stats[p1 + p2] = c
        if c > max1_c or (c == max1_c and seq.order == 0):
            max2_c = max1_c
            max2_p = max1_p
            max1_c = c
            max1_p = p1
        elif max1_p == max2_p or c > max2_c:
            max2_c = c
            max2_p = p1
    return max1_c, max1_p, max2_c, max2_p


def no_dupseq_lqseq(lqseq: LqRegion) -> bool:
    """True if no duplicate alleles among non-ref seqs (main.rs:851-860)."""
    seqs = lqseq.seqs
    for p1 in range(1, len(seqs)):
        for p2 in range(p1 + 1, len(seqs)):
            if seqs[p1].seq == seqs[p2].seq:
                return False
    return True


def _native_seed_pass(name: str):
    """np2obj's routine `name` (io/_native/np2obj.c), or None without it."""
    from ..io.native import load_obj

    obj = load_obj()
    return getattr(obj, name, None) if obj is not None else None


def mark_hete_lqseqs(lqseqs: List[LqRegion], max_can: int = 60) -> None:
    """Heterozygous-interval marking; zeroes minor-allele kscores (main.rs:916-946).

    Dispatches to the native loop over every region (np2obj.mark_hete,
    which also decides is_valid_snp) when available; _mark_hete_lqseqs_py
    below is the executable spec and the fallback, taken on TypeError
    (dataclass LqSeqs), as retrieve_kmer_count falls back from
    collect_score_jobs. Differential-tested in tests/test_torch_seed_pass.py."""
    native = _native_seed_pass("mark_hete")
    if native is not None:
        try:
            het = native(lqseqs, max_can)
        except TypeError:
            pass
        else:
            timing.count("lq.het_regions", het)
            timing.count("lq.seed_native", len(lqseqs))
            return
    _mark_hete_lqseqs_py(lqseqs, max_can)


def _mark_hete_lqseqs_py(lqseqs: List[LqRegion], max_can: int = 60) -> None:
    """Pure-Python spec for mark_hete_lqseqs (main.rs:916-946)."""
    stats = [0] * max_can
    order_stat: Dict[int, int] = {}
    het = 0
    for lqseq in lqseqs:
        max1_c, max1_p, max2_c, max2_p = fill_order_stat(lqseq, stats, order_stat)
        min_c = get_min_count(len(lqseq.seqs))
        if (
            max2_c >= min_c
            and (
                len(lqseq.seqs[max1_p].seq) == len(lqseq.seqs[max2_p].seq)
                or (len(lqseq.seqs) >= 6 and max2_c >= max1_c // 2)
            )
            and is_valid_snp(lqseq.seqs[max1_p].seq, lqseq.seqs[max2_p].seq)
        ):
            lqseq.label |= L_HETE
            for p, seq in enumerate(lqseq.seqs):
                if seq.kscore > 0 and stats[p] < min_c:
                    seq.kscore = 0
            het += 1
    timing.count("lq.het_regions", het)


def phase_reads_by_lqseqs(lqseqs: List[LqRegion], asref: bool,
                          use_all_reads: bool) -> List[int]:
    """Read-pair agreement graph + Louvain phasing (main.rs:948-1015).

    Returns read orders to invalidate (their alignments removed from iteration 2).
    """
    data, ref_weight, invalid_ids = _phase_edges_vec(lqseqs, asref,
                                                     use_all_reads)
    new_invalid = phase_communities(data, ref_weight)
    new_invalid.extend(invalid_ids)  # disjoint: no invalid id is a node
    timing.count("phasing.reads_dropped", len(new_invalid))
    return new_invalid


def _phase_edges_vec(lqseqs: List[LqRegion], asref: bool,
                     use_all_reads: bool):
    """Vectorized agreement-graph builder; returns (data, ref_weight,
    invalid_ids) identical to _phase_edges_scalar.

    Vectorized edge accumulation: per het interval the O(n^2) candidate pairs
    are generated with numpy (allele identity compared once per seq via a
    group-id table, not once per pair), all intervals' edge triplets are
    reduced in a single unique+bincount pass, and the Graph dicts are built
    once from the reduced sums. All weights are +/-1 counts summed exactly in
    f64 and the Louvain stage iterates in canonical sorted order, so edge
    VALUES are the only thing that matters — bit-identical to the pair-loop
    reference semantics (see _phase_edges_scalar, kept for the differential
    test in tests/test_lq_units.py)."""
    e1_parts: List[np.ndarray] = []  # non-ref pair endpoints + weights
    e2_parts: List[np.ndarray] = []
    ew_parts: List[np.ndarray] = []
    r2_parts: List[np.ndarray] = []  # ref-pair partner order + weight
    rw_parts: List[np.ndarray] = []
    for lqseq in lqseqs:
        if not lqseq.label & L_HETE:
            continue
        seqs = [s for s in lqseq.seqs if s.kscore != 0]
        if len(seqs) < 2:
            continue
        orders = np.array([s.order for s in seqs], dtype=np.int64)
        gid_map: Dict[bytes, int] = {}
        gids = np.array([gid_map.setdefault(s.seq, len(gid_map))
                         for s in seqs], dtype=np.int64)
        ii, jj = np.triu_indices(len(seqs), 1)
        w = np.where(gids[ii] == gids[jj], 1.0, -1.0)
        assert not (orders[1:] == 0).any(), "seq2 order must be nonzero"
        if orders[0] == 0:  # reference allele survives the kscore filter
            ref_pair = ii == 0
            r2_parts.append(orders[jj[ref_pair]])
            rw_parts.append(w[ref_pair])
            ii, jj, w = ii[~ref_pair], jj[~ref_pair], w[~ref_pair]
        e1_parts.append(orders[ii])
        e2_parts.append(orders[jj])
        ew_parts.append(w)

    def _cat(parts, dtype):
        return (np.concatenate(parts) if parts
                else np.zeros(0, dtype=dtype))

    n1 = _cat(e1_parts, np.int64)
    n2 = _cat(e2_parts, np.int64)
    ew = _cat(ew_parts, np.float64)
    # reduce unordered (n1, n2) -> summed agreement weight and negative-pair
    # count (the scalar loop inserts both directions, so orientation is
    # irrelevant to the sums)
    packed = (np.minimum(n1, n2) << 32) | np.maximum(n1, n2)
    uniq, inv = np.unique(packed, return_inverse=True)
    wsum = np.bincount(inv, weights=ew, minlength=len(uniq))
    negcnt = np.bincount(inv, weights=(ew < 0).astype(np.float64),
                         minlength=len(uniq))
    u1 = (uniq >> 32).astype(np.int64)
    u2 = (uniq & 0xFFFFFFFF).astype(np.int64)
    # >=3 conflicting het sites -> hard conflict override (main.rs:994-1002)
    val = np.where(negcnt >= 3.0, -negcnt, wsum)

    invalid_ids: set[int] = set()
    rr2 = _cat(r2_parts, np.int64)
    rrw = _cat(rw_parts, np.float64)
    if not use_all_reads:
        invalid_ids.update(int(o) for o in rr2[rrw < 0])

    # Build the symmetric Graph; ids whose every edge was invalidated must
    # still get an (empty) top-level row — the scalar filter only pops the
    # invalid ids themselves, and empty rows become singleton Louvain nodes
    # that participate in decluster renumbering.
    data = new_data()
    edges = 0
    for a, b, v in zip(u1.tolist(), u2.tolist(), val.tolist()):
        a_ok = a not in invalid_ids
        b_ok = b not in invalid_ids
        if a_ok:
            row = data.setdefault(a, {})
            if b_ok:
                row[b] = v
                edges += 1
        if b_ok:
            row = data.setdefault(b, {})
            if a_ok:
                row[a] = v
    timing.count("phasing.edges", edges)

    ref_weight = None
    if asref and len(rr2):
        ru, rinv = np.unique(rr2, return_inverse=True)
        rsum = np.bincount(rinv, weights=rrw, minlength=len(ru))
        ref_weight = dict(zip(ru.tolist(), rsum.tolist()))

    return data, ref_weight, invalid_ids


def _phase_edges_scalar(lqseqs: List[LqRegion], asref: bool,
                        use_all_reads: bool):
    """Reference pair-loop edge builder (main.rs:948-1002), kept as the
    executable spec for the vectorized phase_reads_by_lqseqs; returns
    (data, ref_weight, invalid_ids) ready for phase_communities."""
    data = new_data()
    dif = new_data()
    ref_data = new_data()
    invalid_ids: set[int] = set()
    for lqseq in lqseqs:
        if not lqseq.label & L_HETE:
            continue
        seqs = lqseq.seqs
        for i in range(len(seqs)):
            s1 = seqs[i]
            if s1.kscore == 0:
                continue
            for j in range(i + 1, len(seqs)):
                s2 = seqs[j]
                if s2.kscore == 0:
                    continue
                w = 1.0 if s1.seq == s2.seq else -1.0
                if s1.order == 0:
                    if asref:
                        insert_data(ref_data, s1.order, s2.order, w)
                    if w < 0 and not use_all_reads:
                        invalid_ids.add(s2.order)
                    continue
                assert s2.order != 0, "seq2 order must be nonzero"
                if w == -1.0:
                    insert_data(dif, s1.order, s2.order, -1.0)
                    insert_data(dif, s2.order, s1.order, -1.0)
                insert_data(data, s1.order, s2.order, w)
                insert_data(data, s2.order, s1.order, w)

    for key1 in sorted(dif):
        for key2 in sorted(dif[key1]):
            if dif[key1][key2] <= -3.0:
                assign_data(data, key1, key2, dif[key1][key2])

    if not use_all_reads:
        for k in invalid_ids:
            data.pop(k, None)
        for row in data.values():
            for k in invalid_ids:
                row.pop(k, None)

    ref_weight = next(iter(ref_data.values()), None) if ref_data else None
    return data, ref_weight, invalid_ids


def fill_seed_lqseqs(lqseqs: List[LqRegion], max_indel_len: int,
                     max_can: int = 60) -> None:
    """Pick dominant-allele seeds; prune candidates; set SUCC/RECH
    (main.rs:862-914).

    Dispatches to the native loop over every region (np2obj.seed_regions)
    when available; _fill_seed_lqseqs_py below is the executable spec and
    the fallback, taken on TypeError (dataclass LqSeqs). Both cut a
    region's seqs list in place and rebind seqs to a new empty list where
    the region leaves the recheck (RECH cleared)."""
    native = _native_seed_pass("seed_regions")
    if native is not None:
        try:
            native(lqseqs, max_indel_len, max_can)
        except TypeError:
            pass
        else:
            timing.count("lq.seed_native", len(lqseqs))
            return
    _fill_seed_lqseqs_py(lqseqs, max_indel_len, max_can)


def _fill_seed_lqseqs_py(lqseqs: List[LqRegion], max_indel_len: int,
                         max_can: int = 60) -> None:
    """Pure-Python spec for fill_seed_lqseqs (main.rs:862-914)."""
    stats = [0] * max_can
    order_stat: Dict[int, int] = {}
    for lqseq in lqseqs:
        max1_c, max1_p, _, _ = fill_order_stat(lqseq, stats, order_stat)
        lqseq.sudoseed = lqseq.seqs[max1_p].seq
        lqseq.label |= L_SUCC | L_RECH
        min_c = get_min_count(len(lqseq.seqs))
        assert lqseq.seqs[0].order == 0, "the first lqseq is not ref."

        # protect the reference allele (main.rs:877-890)
        if 0 in order_stat:
            if 1 < order_stat[0] < min_c:
                order_stat[0] = min_c
        else:
            c = sum(1 for x in lqseq.seqs if x.seq == lqseq.seqs[0].seq)
            if c > 1:
                order_stat[0] = min_c

        if max1_p != 0 and max1_c < min_c and (max1_c > 1 or no_dupseq_lqseq(lqseq)):
            order_stat[lqseq.seqs[max1_p].order] = min_c
            order_stat[0] = min_c
        elif max1_c < min_c:
            order_stat[0] = min_c

        # retain_sort_seqs (main.rs:714-727): stable sort by count desc, truncate
        lqseq.seqs.sort(key=lambda v: -order_stat.get(v.order, 0))
        c = 0
        for seq in lqseq.seqs:
            if order_stat.get(seq.order, 0) < min_c:
                break
            c += 1
        del lqseq.seqs[c:]

        skip_long = abs(len(lqseq.sudoseed) - len(lqseq.seqs[0].seq)) > max_indel_len \
            if lqseq.seqs else False
        if len(lqseq.seqs) <= 1 or skip_long:
            if lqseq.seqs or skip_long:
                lqseq.sudoseed = lqseq.seqs[0].seq
            lqseq.label &= ~L_RECH
            lqseq.seqs = []


def _next_labeled(lqseqs: List[LqRegion], i: int, label: int) -> int:
    """get_lqseqs_next_idx_by_lable (main.rs:1017-1025): scan downward; -1 = none."""
    i -= 1
    while i >= 0 and not (lqseqs[i].label & label):
        i -= 1
    return i


def update_consensus_with_lqseqs(lqseqs: List[LqRegion],
                                 consensus: Consensus,
                                 label: int) -> Consensus:
    """Splice sudoseeds over labeled intervals (main.rs:1027-1058).

    lqseqs are in descending genome order; iterated from the tail (ascending).
    Array formulation: `pos` is nondecreasing, so the reference's linear scan
    for `pos == start` is a binary search; the output is a concatenation of
    kept segments and sudoseed blocks. If a labeled region's start position is
    absent at/after the cursor the reference's scan never matches again and no
    further region is spliced — the `break` mirrors that exactly.

    While the recorder is on, each splice whose seed differs from the bytes
    it replaces counts in lq.regions_changed; the recheck's splices
    (reupdate_consensus_with_lqseqs) come through here too, so a region
    that the recheck splices again with other bytes counts again.

    Dispatches to one native walk (np2obj.splice_labeled, which sizes the
    output and then fills it) when available and the arrays are int64 and
    uint8; _update_consensus_with_lqseqs_py below is the executable spec
    and the fallback, taken on TypeError.
    """
    pos, base = consensus.pos, consensus.base
    native = _native_seed_pass("splice_labeled")
    if native is not None and pos.dtype == np.int64 and base.dtype == np.uint8:
        try:
            out_pos, out_base, changed = native(
                lqseqs, label, np.ascontiguousarray(pos),
                np.ascontiguousarray(base), timing.enabled())
        except TypeError:
            pass
        else:
            timing.count("lq.regions_changed", changed)
            return Consensus(pos=np.frombuffer(out_pos, np.int64),
                             base=np.frombuffer(out_base, np.uint8))
    return _update_consensus_with_lqseqs_py(lqseqs, consensus, label)


def _update_consensus_with_lqseqs_py(lqseqs: List[LqRegion],
                                     consensus: Consensus,
                                     label: int) -> Consensus:
    """Pure-Python spec for update_consensus_with_lqseqs (main.rs:1027-1058)."""
    pos, base = consensus.pos, consensus.base
    n = len(pos)
    on = timing.enabled()
    changed = 0
    pos_parts: List[np.ndarray] = []
    base_parts: List[np.ndarray] = []
    c = 0
    li = _next_labeled(lqseqs, len(lqseqs), label)
    while li >= 0 and c < n:
        lq = lqseqs[li]
        i0 = c + int(np.searchsorted(pos[c:], lq.start, side="left"))
        if i0 >= n or pos[i0] != lq.start:
            break  # reference scan would never match again (li stays put)
        pos_parts.append(pos[c:i0])
        base_parts.append(base[c:i0])
        seed = np.frombuffer(lq.sudoseed, dtype=np.uint8)
        pos_parts.append(np.full(len(seed), lq.start, dtype=np.int64))
        base_parts.append(seed)
        c = int(np.searchsorted(pos, lq.end, side="right"))
        if on and base[i0:c].tobytes() != lq.sudoseed:
            changed += 1
        li = _next_labeled(lqseqs, li, label)
    timing.count("lq.regions_changed", changed)
    pos_parts.append(pos[c:])
    base_parts.append(base[c:])
    return Consensus(pos=np.concatenate(pos_parts),
                     base=np.concatenate(base_parts))


def _iter_consensus_region(consensus: Consensus, s: int, e: int
                           ) -> tuple[int, int]:
    """Indices of consensus strictly inside (s, e) (main.rs:1068-1097).

    The reference walks a persistent cursor; on the nondecreasing pos array the
    walk's fixed point is exactly this binary-search pair, independent of the
    cursor, so the cursor is dropped."""
    si = int(np.searchsorted(consensus.pos, s, side="right"))
    ei = int(np.searchsorted(consensus.pos, e, side="left"))
    return si, ei


def _iter_consensus_extend(consensus: Consensus, p: int, l: int,
                           toleft: bool) -> tuple[int, int]:
    """k-1 flank index range, exclusive of pos p (main.rs:1100-1139)."""
    n = len(consensus.pos)
    if toleft:
        ei = int(np.searchsorted(consensus.pos, p, side="left"))
        si = max(ei - l, 0)
    else:
        si = int(np.searchsorted(consensus.pos, p, side="right"))
        ei = min(si + l, n)
    return si, ei


def reupdate_consensus_with_lqseqs(lqseqs: List[LqRegion],
                                   consensus: Consensus,
                                   table: KmerTable, min_kmer_count: int,
                                   iter_count: int,
                                   max_can: int = 60) -> Consensus:
    """One recheck pass with one yak table (main.rs:1060-1420).

    Chains of RECH intervals closer than ksize (max 6) are rescored as the
    cartesian product of their candidate alleles spliced with k-1 flank context;
    best valid combination becomes the new seeds; intervals with >1 valid allele
    stay RECH for the next (longer-k) table.
    """
    ksize = table.ksize
    rech_idxs = [i for i in range(len(lqseqs) - 1, -1, -1) if lqseqs[i].label & L_RECH]

    # Pass 1: enumerate all candidate sequences (single-region alleles and
    # chained cartesian combinations, each spliced with k-1 flank context),
    # mirroring the reference's candidate-collection pass (main.rs:1193-1265).
    jobs: List[bytes] = []
    plan: List[tuple] = []
    sj = 0
    while sj < len(rech_idxs):
        ej = sj + 1
        while (ej < len(rech_idxs)
               and lqseqs[rech_idxs[ej]].start < lqseqs[rech_idxs[ej - 1]].end + ksize):
            ej += 1
            if ej > sj + 5:
                break
        si_l, ei_l = _iter_consensus_extend(
            consensus, lqseqs[rech_idxs[sj]].start, ksize - 1, True)
        si_r, ei_r = _iter_consensus_extend(
            consensus, lqseqs[rech_idxs[ej - 1]].end, ksize - 1, False)
        flank_l = consensus.base[si_l:ei_l].tobytes()
        flank_r = consensus.base[si_r:ei_r].tobytes()

        if ej == sj + 1:
            for seq in lqseqs[rech_idxs[sj]].seqs:
                jobs.append(flank_l + seq.seq + flank_r)
                plan.append(("single", seq))
        else:
            # gap sequences between consecutive chained regions (cursor walks
            # are deterministic for fixed (s, e))
            gaps: List[bytes] = []
            for i in range(sj, ej - 1):
                s = lqseqs[rech_idxs[i]].end
                e = lqseqs[rech_idxs[i + 1]].start
                if s + 1 == e:
                    gaps.append(b"")
                else:
                    gs, ge = _iter_consensus_region(consensus, s, e)
                    gaps.append(consensus.base[gs:ge].tobytes())
            cand_lists = [
                list(enumerate(lqseqs[rech_idxs[x]].seqs)) for x in range(sj, ej)
            ]
            chain_regions = [rech_idxs[x] for x in range(sj, ej)]
            plan.append(("chain_start", chain_regions))
            for combo in cartesian_product(*cand_lists):
                parts = [flank_l]
                for i, (_, seq) in enumerate(combo):
                    parts.append(seq.seq)
                    if i < len(combo) - 1:
                        parts.append(gaps[i])
                parts.append(flank_r)
                jobs.append(b"".join(parts))
                plan.append(("combo", [(chain_regions[i], p)
                                       for i, (p, _) in enumerate(combo)]))
            plan.append(("chain_end", chain_regions))
        sj = ej

    # ONE batched scoring pass over every candidate (main.rs:1267 equivalent)
    scores = batch_min_kscores(jobs, table, min_kmer_count)

    # Pass 2: apply in the reference's order (per-chain zero + buffered writes,
    # later combos overwriting earlier ones — main.rs:1317-1366)
    ji = 0
    kscore_buf: List[tuple[int, int, int]] = []
    for entry in plan:
        kind = entry[0]
        if kind == "single":
            entry[1].kscore = int(scores[ji])
            ji += 1
        elif kind == "chain_start":
            kscore_buf = []
        elif kind == "combo":
            ks = int(scores[ji])
            ji += 1
            if ks > 0:
                for ridx, p in entry[1]:
                    kscore_buf.append((ridx, p, ks))
        else:  # chain_end
            for ridx in entry[1]:
                for seq in lqseqs[ridx].seqs:
                    seq.kscore = 0
            for ridx, p, ks in kscore_buf:
                lqseqs[ridx].seqs[p].kscore = ks

    # choose seeds (main.rs:1371-1406)
    for lqseq in lqseqs:
        if not lqseq.label & L_RECH:
            continue
        c = 0
        valid_count = 0
        for p, seq in enumerate(lqseq.seqs):
            if seq.kscore != 0:
                if c == 0 or seq.order == 0:
                    c = p + 1
                valid_count += 1
        if valid_count > 1:
            lqseq.label |= L_TEMP
        if c != 0:
            lqseq.sudoseed = lqseq.seqs[c - 1].seq
        elif iter_count == 1:
            i = 0
            for p, seq in enumerate(lqseq.seqs):
                if seq.order == 0:
                    i = p
                    break
            lqseq.sudoseed = lqseq.seqs[i].seq

    consensus = update_consensus_with_lqseqs(lqseqs, consensus, L_RECH)

    for lqseq in lqseqs:
        if lqseq.label & L_RECH:
            if lqseq.label & L_TEMP:
                lqseq.label &= ~L_TEMP
            else:
                lqseq.label &= ~L_RECH
    return consensus
