"""The reference's LQ-interval machinery: candidate-allele extraction, yak k-mer scoring,
heterozygous-site marking, read phasing glue, seed filling, consensus splicing and
the multi-k recheck cascade.

Faithful reimplementation of reference src/main.rs:647-1543. One deliberate
difference: the reference re-streams each .yak file from disk per scoring call
(retrieve_kmer_count -> KmerInfo::retrieve_kmers); we query the resident KmerTable
directly — get(hash, min_count) is the exact composition of the reference's
candidate-insert + file-scan + get.
"""

from __future__ import annotations

from dataclasses import dataclass
from itertools import product as cartesian_product
from typing import Dict, List

import numpy as np

from .yak import INVALID_KMER, KmerTable
from .seqcodes import CODE2ASCII
from .louvain import assign_data, insert_data, new_data, phase_communities
from .align import AlignTags
from .msa import Consensus, LqRegion

# label bits (main.rs:655-658)
L_TEMP = 0b0000_0001
L_SUCC = 0b1000_0000
L_HETE = 0b0100_0000
L_RECH = 0b0010_0000

INVALID = int(INVALID_KMER)

@dataclass(slots=True)
class LqSeq:
    order: int
    kscore: int
    kmer: int  # full yak hash, or INVALID
    seq: bytes


def extract_alleles(alignseqs: List[AlignTags], lqseqs: List[LqRegion],
                    table: KmerTable, max_can: int = 60) -> None:
    """Per-read allele extraction over LQ intervals
    (generate_lqseqs_from_tags_kmer first half, main.rs:1429-1523).

    lqseqs are in DESCENDING genome order. alignseqs[0] must be the reference
    pseudo-alignment (order 0). Appends LqSeq entries in read order."""
    _extract_alleles_py(alignseqs, lqseqs, table, max_can)


def _extract_alleles_py(alignseqs: List[AlignTags], lqseqs: List[LqRegion],
                        table: KmerTable, max_can: int = 60,
                        ) -> None:
    """Allele extraction, alignment by alignment."""
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
    # regions are in descending genome order, so their ends descend too
    neg_ends = -np.fromiter((r.end for r in lqseqs), np.int64, len(lqseqs))
    all_starts = np.fromiter((r.start for r in lqseqs), np.int64, len(lqseqs))
    queued = np.fromiter((len(r.seqs) for r in lqseqs), np.int64, len(lqseqs))
    steps = np.arange(ksize, dtype=np.int64)
    three, two = np.uint64(3), np.uint64(2)

    def hashes_of(rows: np.ndarray) -> list:
        # Raw rolling with q_base used unchecked incl N/M codes — reference
        # main.rs:1488-1492 does the same; numpy uint64 shifts wrap like
        # Rust release shl, preserving the k >= 32 wrapped semantics.
        kb = rows.astype(np.uint64)
        k_fwd = np.zeros(len(kb), np.uint64)
        k_rev = np.zeros(len(kb), np.uint64)
        for step in range(ksize):
            qb = kb[:, step]
            k_fwd = ((k_fwd << two) | qb) & mask
            k_rev = (k_rev >> two) | ((three ^ qb) << shift)
        return table.to_hash(np.minimum(k_fwd, k_rev)).astype(
            np.uint64).tolist()

    # per alignment, every region it covers at once, in read order
    for idx, a in enumerate(alignseqs):
        if a.dropped or len(a) == 0:
            continue
        while s > 0 and lqseqs[s].start < a.aln_t_s:
            s -= 1
        if lqseqs[s].start < a.aln_t_s or lqseqs[s].end > a.aln_t_e:
            continue
        # the reference walks j down from s while lqseqs[j].end <= aln_t_e
        # (and back up one where it overshoots): the first region ending
        # at or before aln_t_e
        j = min(int(np.searchsorted(neg_ends, -a.aln_t_e, side="left")),
                s + 1)

        # decode tags until t_pos > lqseqs[j].end + ksize (main.rs:1462-1471)
        stop = int(np.searchsorted(a.t_pos, lqseqs[min(j, s)].end + ksize,
                                   side="right"))
        t_pos = a.t_pos[:stop + 1] if stop < len(a) else a.t_pos
        q_base = a.q_base[: len(t_pos)]
        # valid (non-gap) tags sorted by t_pos; per region the allele = valid
        # bases in [start, end], the kmer = first ksize valid bases from
        # start (may run past end), exactly the reference scan
        vi = np.nonzero(q_base != 4)[0]
        vpos = t_pos[vi]
        vq = q_base[vi]
        i0s = np.searchsorted(vpos, all_starts[j:s + 1], side="left")
        i1s = np.searchsorted(vpos, -neg_ends[j:s + 1], side="right")
        # a region at its candidate cap, or with an empty allele, gets
        # nothing from this read
        take = (queued[j:s + 1] < max_can) & (i1s > i0s)
        queued[j:s + 1] += take
        if not take.any():
            continue
        regs = np.flatnonzero(take)
        i0, i1 = i0s[regs], i1s[regs]
        fits = i0 + ksize <= len(vq)
        if fits.all():
            kmers = hashes_of(vq[i0[:, None] + steps])
        else:
            kmers = [INVALID] * len(regs)
            for r, h in zip(np.flatnonzero(fits).tolist(),
                            hashes_of(vq[i0[fits, None] + steps])):
                kmers[r] = h
        ascii_ = CODE2ASCII[vq].tobytes()
        for r, b, e, km in zip(regs.tolist(), i0.tolist(), i1.tolist(),
                               kmers):
            lqseqs[j + r].seqs.append(LqSeq(idx, 0, km, ascii_[b:e]))


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
    from .yak import rolling_kmers
    from .seqcodes import seq_to_codes

    joined = b"N".join(seqs)
    kmers, valid = rolling_kmers(seq_to_codes(joined), table.ksize)
    out = np.zeros(len(seqs), dtype=np.int64)
    vidx = np.nonzero(valid)[0]
    if len(vidx):
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
    if True:
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
        for s, v in zip(refs, scores.tolist()):
            s.kscore = v

    if long_seqs:
        put(long_refs, batch_min_kscores(long_seqs, table, min_kmer_count))
    if single_hashes:
        if True:
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
    """Allele-identity counting + top-2 stats (main.rs:813-849), the literal
    pair scan. Returns (max1_c, max1_p, max2_c, max2_p); fills stats (per
    seq index) and order_stat (first-occurrence order -> count)."""
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


def mark_hete_lqseqs(lqseqs: List[LqRegion], max_can: int = 60) -> None:
    """Heterozygous-interval marking; zeroes minor-allele kscores (main.rs:916-946)."""
    stats = [0] * max_can
    order_stat: Dict[int, int] = {}
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


def phase_reads_by_lqseqs(lqseqs: List[LqRegion], asref: bool,
                          use_all_reads: bool) -> List[int]:
    """Read-pair agreement graph + Louvain phasing (main.rs:948-1015).

    Returns read orders to invalidate (their alignments removed from iteration 2).
    """
    data, ref_weight, invalid_ids = _phase_edges_scalar(lqseqs, asref,
                                                        use_all_reads)
    new_invalid = phase_communities(data, ref_weight)
    new_invalid.extend(invalid_ids)
    return new_invalid


def _phase_edges_scalar(lqseqs: List[LqRegion], asref: bool,
                        use_all_reads: bool):
    """The pair-loop edge construction (main.rs:948-1002); returns (data,
    ref_weight, invalid_ids) ready for phase_communities."""
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
    (main.rs:862-914)."""
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
    """
    pos, base = consensus.pos, consensus.base
    n = len(pos)
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
        li = _next_labeled(lqseqs, li, label)
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
