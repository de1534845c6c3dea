"""Oracle MSA pileup + consensus DP + backtrack/LQ detection.

Faithful reimplementation of the reference 3-mer MSA graph and Viterbi consensus
(src/main.rs:33-268 Kmer/Msa, main.rs:576-589 update_msas, main.rs:1645-1687 DP,
main.rs:1555-1643 backtrack + LQ regions).

A 3-mer is keyed by (delta, bases) where bases packs two t_pos-equality flag bits
and three 4-bit base codes (main.rs:55-101). Per reference position the distinct
3-mers are kept in first-occurrence order, then stably sorted by the delta of their
third base (Msa::sort, main.rs:227-229) — this ordering is semantically load-bearing
for DP tie-breaking and in-position dependency order.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from .align import AlignTags

NEG_INF = -(2**62)  # i64::MIN >> 1 equivalent guard (main.rs:1661)
HEAD_Q = 15


def _b3_delta(flags: int, delta: int) -> int:
    """delta of the third base, used as the Msa sort key (Kmer::bases, main.rs:105-184)."""
    if flags & 0b0101 == 0b0101:
        return delta + 2
    if flags & 0b0001:
        return 1
    return 0


def _decode(flags: int, delta: int, q1: int, q2: int, q3: int, p: int):
    """Kmer::bases(p): the three (t_pos, delta, q_base) bases (main.rs:105-184)."""
    if flags & 0b0101 == 0b0101:  # A--
        return (p, delta, q1), (p, delta + 1, q2), (p, delta + 2, q3)
    if flags & 0b0001:  # AA-
        return (p - 1, delta, q1), (p, 0, q2), (p, 1, q3)
    if flags & 0b0100:  # A-A
        return (p - 1, delta, q1), (p - 1, delta + 1, q2), (p, 0, q3)
    return (p - 2, delta, q1), (p - 1, 0, q2), (p, 0, q3)  # AAA


@dataclass
class Msas:
    """Column-major MSA in flat form: the distinct 3-mers of every reference
    position, position by position in Msa::sort order, as int64 arrays;
    position p's 3-mers are the entries bounds[p] .. bounds[p + 1] - 1."""

    n_pos: int
    bounds: np.ndarray
    deltas: np.ndarray
    flags: np.ndarray
    q1: np.ndarray
    q2: np.ndarray
    q3: np.ndarray
    counts: np.ndarray
    coverage: np.ndarray  # per position (Msa::coverage, main.rs:232-241)


def kmer_stream(a: AlignTags) -> tuple[np.ndarray, np.ndarray]:
    """One alignment -> its (t_pos, key) 3-mer observation stream.

    key packs (b1.delta:u16 | flags:4 | q1:4 | q2:4 | q3:4) exactly like Kmer::new
    (main.rs:84-101); the stream is what update_msas pushes (main.rs:576-589).
    """
    n = len(a)
    t = a.t_pos
    d = a.delta
    q = a.q_base.astype(np.uint32)
    head_t = a.aln_t_s - 1
    # b1/b2 shifted streams with two virtual heads (update_msas, main.rs:579-581)
    b1_t = np.empty(n, dtype=np.int64)
    b1_d = np.empty(n, dtype=np.int64)
    b1_q = np.empty(n, dtype=np.uint32)
    b2_t = np.empty(n, dtype=np.int64)
    b2_q = np.empty(n, dtype=np.uint32)
    b1_t[2:] = t[:-2]
    b1_d[2:] = d[:-2]
    b1_q[2:] = q[:-2]
    b2_t[1:] = t[:-1]
    b2_q[1:] = q[:-1]
    b1_t[0] = head_t
    b1_d[0] = 0
    b1_q[0] = HEAD_Q
    if n > 1:
        b1_t[1] = head_t
        b1_d[1] = 1
        b1_q[1] = HEAD_Q
    b2_t[0] = head_t
    b2_q[0] = HEAD_Q
    flag = ((b2_t == b1_t).astype(np.uint32) << 2) | (b2_t == t).astype(np.uint32)
    key = (
        (b1_d.astype(np.uint64) << np.uint64(16))
        | (flag.astype(np.uint64) << np.uint64(12))
        | (b1_q.astype(np.uint64) << np.uint64(8))
        | (b2_q.astype(np.uint64) << np.uint64(4))
        | q.astype(np.uint64)
    )
    return t, key


def build_msas(alignseqs: List[AlignTags], n_pos: int) -> Msas:
    """update_msas over all non-dropped alignments (main.rs:576-589), vectorized.

    Produces per-position kmer lists in first-occurrence order stably sorted by
    b3-delta, with occurrence counts.
    """
    pos_chunks = []
    key_chunks = []
    for a in alignseqs:
        if a.dropped or len(a) == 0:
            continue
        t, key = kmer_stream(a)
        pos_chunks.append(t)
        key_chunks.append(key)

    if not pos_chunks:
        z = np.zeros(0, dtype=np.int64)
        return Msas(n_pos, np.zeros(n_pos + 1, dtype=np.int64), z, z, z, z,
                    z, z, np.zeros(n_pos, dtype=np.int64))

    pos_all = np.concatenate(pos_chunks)
    key_all = np.concatenate(key_chunks)
    comb = (pos_all.astype(np.uint64) << np.uint64(32)) | key_all
    uniq, first_idx, counts = np.unique(comb, return_index=True, return_counts=True)
    upos = (uniq >> np.uint64(32)).astype(np.int64)
    ukey = uniq & np.uint64(0xFFFFFFFF)
    udelta = (ukey >> np.uint64(16)).astype(np.int64)
    uflag = ((ukey >> np.uint64(12)) & np.uint64(0xF)).astype(np.int64)
    uq1 = ((ukey >> np.uint64(8)) & np.uint64(0xF)).astype(np.int64)
    uq2 = ((ukey >> np.uint64(4)) & np.uint64(0xF)).astype(np.int64)
    uq3 = (ukey & np.uint64(0xF)).astype(np.int64)
    b3d = np.where(uflag & 0b0101 == 0b0101, udelta + 2, np.where(uflag & 1 == 1, 1, 0))
    # order: position, then b3-delta, then first occurrence (stable Msa::sort)
    order = np.lexsort((first_idx, b3d, upos))
    upos = upos[order]
    counts = counts[order].astype(np.int64)
    b3d = b3d[order]
    bounds = np.searchsorted(upos, np.arange(n_pos + 1))
    cov_sums = np.concatenate([[0], np.cumsum(np.where(b3d == 0, counts, 0))])
    coverage = cov_sums[bounds[1:]] - cov_sums[bounds[:-1]]
    return Msas(n_pos, bounds.astype(np.int64), udelta[order], uflag[order],
                uq1[order], uq2[order], uq3[order], counts,
                coverage.astype(np.int64))


@dataclass
class Consensus:
    """Array-based consensus: parallel (pos, base) arrays in genome order.

    Replaces the reference's per-base `Vec<ConsensusBase>` (main.rs:591-596)
    — the array form makes splicing/flank extraction O(segments) numpy ops
    instead of per-object Python (the round-1 scale blocker).

    Invariant: pos is nondecreasing (insertions repeat a position)."""

    pos: np.ndarray   # int64 genome positions, nondecreasing
    base: np.ndarray  # uint8 ASCII bytes

    def __len__(self) -> int:
        return len(self.pos)

    def to_bytes(self) -> bytes:
        return self.base.tobytes()


@dataclass
class LqRegion:
    """An LQ interval (LqSeqs coordinates): start <= end genome positions."""

    start: int
    end: int
    label: int = 0
    sudoseed: bytes = b""
    seqs: list = None  # List[LqSeq], filled by allele extraction

    def __post_init__(self):
        if self.seqs is None:
            self.seqs = []


def decode_all(msas: Msas):
    """_decode of every MSA entry at once: (t, delta, q) of its three bases
    as int64 arrays, b1 first."""
    n_ent = msas.bounds[msas.n_pos]
    p = np.repeat(np.arange(msas.n_pos, dtype=np.int64),
                  np.diff(np.asarray(msas.bounds, dtype=np.int64)))
    f = np.asarray(msas.flags, dtype=np.int64)
    d = np.asarray(msas.deltas, dtype=np.int64)
    a__ = (f & 0b0101) == 0b0101
    aa_ = ~a__ & ((f & 0b0001) != 0)
    a_a = ~a__ & ~aa_ & ((f & 0b0100) != 0)
    aaa = ~(a__ | aa_ | a_a)
    t1 = np.where(a__, p, np.where(aaa, p - 2, p - 1))
    t2 = np.where(a__ | aa_, p, p - 1)
    d2 = np.where(a__ | a_a, d + 1, 0)
    d3 = np.where(a__, d + 2, np.where(aa_, 1, 0))
    q = [np.asarray(x, dtype=np.int64).reshape(n_ent)
         for x in (msas.q1, msas.q2, msas.q3)]
    return (t1, d, q[0]), (t2, d2, q[1]), (p, d3, q[2])


def _pair_key(a, b):
    """One int64 for two consecutive bases (t, delta, q) -> (t', delta', q'):
    t' - t is 0 (then delta' = delta + 1) or 1 (then delta' = 0), so (t,
    delta, q, t' - t, q') says it all."""
    (t, d, q), (t2, _, q2) = a, b
    if len(t) and (t.max() >= 1 << 26 or d.max() >= 1 << 16):
        raise ValueError("contig or insertion too long for the pair key")
    return ((((t << 16 | d) << 4 | q) << 1 | (t2 - t)) << 4) | q2


def consensus_dp(msas: Msas) -> tuple[List[int], List[int], Tuple[int, int]]:
    """Forward Viterbi over the 3-mer graph (get_cns_from_align_tags,
    main.rs:1645-1687), as consensus_dp_scalar computes it.

    Returns (score per MSA entry, besti per MSA entry: the predecessor's
    index within its own position, global best (pos, kmer_idx)).

    An entry's candidates are the entries whose last two bases equal its
    first two (Msa::get), found by one sort of pair keys. An entry with
    one earlier candidate takes that candidate's score plus its gain, so
    such entries form chains scored by sums along the chain from its
    root. The roots (heads, entries with no candidate, several, or a later
    one) are scored one by one in entry order, as the scalar loop does;
    a later candidate still reads 0 there, the score it holds before its
    turn. A chain whose root sits at NEG_INF is scored step by step, with
    the scalar loop's clamp at NEG_INF.
    """
    n = msas.n_pos
    bounds = np.asarray(msas.bounds, dtype=np.int64)
    n_ent = int(bounds[n])
    if n_ent == 0:
        return [], [], (-1, -1)
    b1, b2, b3 = decode_all(msas)
    p = b3[0]
    gain = 10 * np.asarray(msas.counts, dtype=np.int64) \
        - 4 * np.asarray(msas.coverage, dtype=np.int64)[p]
    head = b2[2] == HEAD_Q
    # candidates: last two bases equal to the entry's first two, except
    # read-start heads past position 2 (main.rs:1664-1668)
    suffix = _pair_key(b2, b3)
    suffix[(b1[2] == HEAD_Q) & (p >= 3)] = -1
    order = np.argsort(suffix, kind="stable")
    sorted_suffix = suffix[order]
    prefix = _pair_key(b1, b2)
    lo_i = np.searchsorted(sorted_suffix, prefix, "left")
    hi_i = np.searchsorted(sorted_suffix, prefix, "right")
    ncand = np.where(head, 0, hi_i - lo_i)
    first = order[np.minimum(lo_i, n_ent - 1)]
    idx = np.arange(n_ent, dtype=np.int64)
    chain = ~head & (ncand == 1) & (first < idx)
    plo = bounds[b2[0]]  # start of the predecessor's position
    v1q = b1[2]
    # chains: root and the gain summed from each entry up to its root
    anc = np.where(chain, first, idx)
    acc = np.where(chain, gain, 0)
    while True:
        up = anc[anc]
        if np.array_equal(up, anc):
            break
        acc = acc + acc[anc]
        anc = up

    # every score lies in [NEG_INF, 10 * reads * positions]: int64 holds it
    scores = np.zeros(n_ent, dtype=np.int64)
    bestis = np.where(chain, first - plo, 0)
    low = {}  # exact scores of chain entries under a NEG_INF root

    def score_of(f: int, at: int) -> int:
        if f > at:
            return 0  # not scored yet when `at` reads it
        if not chain[f]:
            return int(scores[f])
        r = int(anc[f])
        if scores[r] > NEG_INF // 2:
            return int(scores[r]) + int(acc[f])
        path, g = [], f
        while g != r and g not in low:
            path.append(g)
            g = int(first[g])
        for g in reversed(path):
            pf = int(first[g])
            cand = (low[pf] if pf in low else int(scores[pf])) + int(gain[g])
            low[g] = max(cand, NEG_INF)
            if not (cand > NEG_INF or (cand == NEG_INF and v1q[pf] != 4)):
                bestis[g] = 0
        return low[f]

    roots = np.flatnonzero(~chain).tolist()
    gain_l, lo_l, hi_l = gain.tolist(), lo_i.tolist(), hi_i.tolist()
    order_l, head_l, plo_l = order.tolist(), head.tolist(), plo.tolist()
    v1q_l = v1q.tolist()
    for e in roots:
        g = gain_l[e]
        if head_l[e]:
            scores[e] = g
            continue
        s = NEG_INF
        besti = 0
        for k in range(lo_l[e], hi_l[e]):
            f = order_l[k]
            cand = score_of(f, e) + g
            if cand > s or (cand == s and v1q_l[f] != 4):
                s = cand
                besti = f - plo_l[e]
        scores[e] = s
        bestis[e] = besti
    # the chain entries' scores (and their bestis under a NEG_INF root)
    fine = chain & (scores[anc] > NEG_INF // 2)
    scores[fine] = scores[anc[fine]] + acc[fine]
    for f in np.flatnonzero(chain & ~fine).tolist():
        scores[f] = score_of(f, n_ent)
    gb_score, gb = 0, (-1, -1)
    base = int(bounds[n - 1])
    for e, v in enumerate(scores[base:].tolist()):
        if v >= gb_score:
            gb_score, gb = v, (n - 1, e)
    return scores.tolist(), bestis.tolist(), gb


def consensus_dp_scalar(msas: Msas
                        ) -> tuple[List[int], List[int], Tuple[int, int]]:
    """Forward Viterbi over the 3-mer graph (get_cns_from_align_tags, main.rs:1645-1687),
    entry by entry as the reference writes it; consensus_dp gives the same.

    Returns (score per MSA entry, besti per MSA entry: the predecessor's
    index within its own position, global best (pos, kmer_idx)). An entry's
    in-position predecessors (insertion chains) sort before it, so their
    scores are set when it reads them.
    """
    n = msas.n_pos
    B, D, F, Q1, Q2, Q3, C, COV = (
        np.asarray(x).tolist() for x in (
            msas.bounds, msas.deltas, msas.flags, msas.q1, msas.q2, msas.q3,
            msas.counts, msas.coverage))
    scores = [0] * B[n]
    bestis = [0] * B[n]
    gb_score = 0  # Default Kmer has score 0 (main.rs:1651)
    gb = (-1, -1)
    for p in range(n):
        lo = B[p]
        cov4 = 4 * COV[p]
        for e in range(lo, B[p + 1]):
            b1, b2, _b3 = _decode(F[e], D[e], Q1[e], Q2[e], Q3[e], p)
            gain = 10 * C[e] - cov4
            if b2[2] == HEAD_Q:
                s = gain
            else:
                s = NEG_INF
                besti = 0
                pt = b2[0]
                plo = B[pt]
                low8 = (b1[2] << 4) | b2[2]
                d23 = 1 if b1[0] == b2[0] else 0
                for f in range(plo, B[pt + 1]):
                    # prefilter then full check (Msa::get, main.rs:209-225)
                    if (Q2[f] << 4 | Q3[f]) != low8:
                        continue
                    if F[f] & 1 != d23:
                        continue
                    v1, v2, v3 = _decode(F[f], D[f], Q1[f], Q2[f], Q3[f], pt)
                    if v2 != b1 or v3 != b2:
                        continue
                    if pt >= 3 and v1[2] == HEAD_Q:
                        # prevent backtracking into a read-start head (main.rs:1664-1668)
                        continue
                    cand = scores[f] + gain
                    if cand > s or (cand == s and v1[2] != 4):
                        s = cand
                        besti = f - plo
                bestis[e] = besti
            scores[e] = s
            if p == n - 1 and s >= gb_score:
                gb_score = s
                gb = (p, e - lo)
    return scores, bestis, gb


def lq_from_stream(pos: np.ndarray, base: np.ndarray, cnt: np.ndarray,
                   cov: np.ndarray, hq_min_qv: int = 95, lq_min_length: int = 2,
                   ) -> tuple[Consensus, List[LqRegion]]:
    """LQ-region detection over the REVERSED backtrack stream
    (generate_cns_from_best_score_lq inline state machine, main.rs:1573-1637).

    pos/base/cnt/cov are parallel arrays in reverse genome order (the order the
    backtrack walk emits). Returns (genome-order Consensus, LQ regions in
    DESCENDING genome order).
    """
    qv = np.where(cov > 0,
                  cnt.astype(np.int64) * 100 // np.maximum(cov, 1), 0)
    lowcov = cov < 2
    return lq_from_qv_stream(pos, base, qv, lowcov, hq_min_qv, lq_min_length)


def lq_from_qv_stream(pos: np.ndarray, base: np.ndarray, qv: np.ndarray,
                      lowcov: np.ndarray, hq_min_qv: int = 95,
                      lq_min_length: int = 2,
                      ) -> tuple[Consensus, List[LqRegion]]:
    """lq_from_stream over precomputed per-position qv (= count*100 //
    coverage) + coverage<2 flags, the only two facts the LQ state machine
    reads.

    Event-driven equivalent of the reference's per-base scan: state only
    changes at low-coverage / low-qv positions and at the first qualifying
    close position after an LQ run, so the loop jumps between those events
    (all precomputed vectorized) instead of walking every base.
    """
    n = len(pos)
    lqseqs: List[LqRegion] = []
    if n:
        L = lq_min_length
        lowcov = np.asarray(lowcov, dtype=bool)
        lowqv = ~lowcov & (qv < hq_min_qv)
        ev_i = np.nonzero(lowcov | lowqv)[0]
        ev_low = lowqv[ev_i]
        # diff[i]: entries i and i+1 differ in BOTH pos and base
        diff = (pos[1:] != pos[:-1]) & (base[1:] != base[:-1])
        # close candidates: p >= 2 with cb[p-1] != cb[p-2] (both fields)
        close_idx = np.nonzero(diff)[0] + 2
        # backscan stop: largest j <= x with j <= 1 or diff[j-1]
        goodmask = np.empty(n, dtype=bool)
        goodmask[:2] = True
        if n > 2:
            goodmask[2:] = diff[1:]
        lastgood = np.maximum.accumulate(
            np.where(goodmask, np.arange(n, dtype=np.int64), 0))

        lq_s: Optional[int] = None
        n_ev = len(ev_i)
        # where a run is open at event k, its last LQ position is event
        # k - 1's: the first close candidate past it, for every k at once
        nc = len(close_idx)
        first_close = np.full(n_ev + 1, n + 1, dtype=np.int64)
        if n_ev and nc:
            jj = np.searchsorted(close_idx, ev_i + 2 * L + 1)
            first_close[1:] = np.where(
                jj < nc, close_idx[np.minimum(jj, nc - 1)], n + 1)
        first_close = first_close.tolist()
        ev_l = ev_i.tolist()
        ev_low = ev_low.tolist()
        k = 0
        while k <= n_ev:
            nxt = ev_l[k] if k < n_ev else n
            if lq_s is not None:
                # first HQ position after the run that closes it (main.rs:1586)
                if first_close[k] < nxt:
                    pc = first_close[k]
                    ce = pc - 2
                    cs = lq_s - L if lq_s > L else 1
                    cs = int(lastgood[cs])
                    # regions accumulate in descending genome order;
                    # overlapping ones merge (main.rs:1612-1622)
                    if lqseqs and pos[cs] >= lqseqs[-1].start:
                        lqseqs[-1].start = int(pos[ce])
                    else:
                        lqseqs.append(LqRegion(start=int(pos[ce]),
                                               end=int(pos[cs])))
                    lq_s = None
            if k == n_ev:
                break
            if ev_low[k]:
                if lq_s is None:
                    lq_s = ev_l[k]
            else:  # coverage < 2 resets the run (main.rs:1578-1580)
                lq_s = None
            k += 1

    return Consensus(pos=pos[::-1].copy(),
                     base=base[::-1].astype(np.uint8)), lqseqs


def backtrack_lq(msas: Msas, bestis: List[int], gb: Tuple[int, int],
                 hq_min_qv: int = 95, lq_min_length: int = 2,
                 ) -> tuple[Consensus, List[LqRegion]]:
    """Backtrack emitting consensus bases + detect LQ regions
    (generate_cns_from_best_score_lq, main.rs:1555-1643).

    Returns (genome-order Consensus, LQ regions in DESCENDING genome order).
    """
    from .seqcodes import CODE2ASCII

    if gb[0] < 0:
        z64 = np.zeros(0, dtype=np.int64)
        return Consensus(pos=z64, base=np.zeros(0, dtype=np.uint8)), []
    bounds = np.asarray(msas.bounds, dtype=np.int64)
    _, b2, b3 = decode_all(msas)
    # each entry's best predecessor: besti indexes msas[base2.t_pos]
    # (main.rs:1632-1633); the walk ends at a read-start head
    pred = (bounds[b2[0]] + np.asarray(bestis, dtype=np.int64)).tolist()
    head = (b2[2] == HEAD_Q).tolist()
    e = int(bounds[gb[0]]) + gb[1]
    path = [e]
    while not head[e]:
        e = pred[e]
        path.append(e)
    path = np.asarray(path, dtype=np.int64)
    path = path[b3[2][path] != 4]  # gaps are skipped (main.rs:1575)
    s_pos = b3[0][path]
    return lq_from_stream(
        s_pos, CODE2ASCII[b3[2][path]].astype(np.uint8),
        np.asarray(msas.counts, dtype=np.int64)[path],
        np.asarray(msas.coverage, dtype=np.int64)[s_pos],
        hq_min_qv, lq_min_length)
