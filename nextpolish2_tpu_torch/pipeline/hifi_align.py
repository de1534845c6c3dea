"""Seed-chain-patch aligner for HiFi reads -> sorted BAM.

Data-prep equivalent of the reference's external `minimap2 -ax map-hifi` step
(reference README.md:55-77, test/hh.sh), so that making a fixture needs no
aligner binary. Not part of the polishing engine itself. A copy of the JAX
package's pipeline/hifi_align.py (numpy only, on the host): the same reads
give the same records, and through io/bam.BamWriter the same BAM bytes.

HiFi reads are ~99.9% accurate, so alignment = exact k-mer anchor chains with tiny
gap patches between anchors (full DP only on the short inter-anchor segments).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..io.bam import BamRecord, BamWriter
from ..utils.seqcodes import revcomp, seq_to_codes

_U64 = np.uint64


def _forward_kmers(codes: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Forward 2-bit packed k-mers at each end position; validity mask."""
    n = len(codes)
    if n < k:
        return np.zeros(0, dtype=_U64), np.zeros(0, dtype=np.int64)
    c = codes.astype(_U64)
    val = codes < 4
    out = np.zeros(n - k + 1, dtype=_U64)
    ok = np.ones(n - k + 1, dtype=bool)
    for t in range(k):
        out |= c[t : n - k + 1 + t] << _U64(2 * (k - 1 - t))
        ok &= val[t : n - k + 1 + t]
    return out, np.nonzero(ok)[0]


@dataclass
class TargetIndex:
    k: int
    # sorted forward k-mers of the target and their start positions
    kmers: np.ndarray
    positions: np.ndarray
    max_occ: int = 64  # ignore repetitive seeds

    @classmethod
    def build(cls, seq: bytes, k: int = 15, max_occ: int = 64) -> "TargetIndex":
        km, pos = _forward_kmers(seq_to_codes(seq), k)
        km = km[pos]
        order = np.argsort(km, kind="stable")
        return cls(k=k, kmers=km[order], positions=pos[order], max_occ=max_occ)

    def hits(self, qk: np.ndarray, qpos: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """All (tpos, qpos) matches of query k-mers, repetitive seeds dropped."""
        lo = np.searchsorted(self.kmers, qk, side="left")
        hi = np.searchsorted(self.kmers, qk, side="right")
        cnt = hi - lo
        keep = (cnt > 0) & (cnt <= self.max_occ)
        lo, hi, qp = lo[keep], hi[keep], qpos[keep]
        total = int((hi - lo).sum())
        t_out = np.empty(total, dtype=np.int64)
        q_out = np.empty(total, dtype=np.int64)
        o = 0
        for l, h, q in zip(lo, hi, qp):
            n = h - l
            t_out[o : o + n] = self.positions[l:h]
            q_out[o : o + n] = q
            o += n
        # the loop is over matched seeds only: fine at data-prep scale
        return t_out, q_out


def _edit_align(q: bytes, t: bytes, free_t_start: bool = False,
                free_t_end: bool = False) -> tuple[List[Tuple[int, int]], int]:
    """Edit-distance alignment of two short segments -> (cigar_ops, t_start).

    Ops are {0:M, 1:I, 2:D}. free_t_start/free_t_end make the target end(s)
    unpenalized (semi-global), used when patching read ends against a target
    window longer than the read remnant; t_start is the offset into t where the
    alignment begins (nonzero only with free_t_start). Plain DP; segments are tiny.
    """
    n, m = len(q), len(t)
    if n == 0:
        return ([(2, m)] if (m and not (free_t_start or free_t_end)) else []), 0
    if m == 0:
        return [(1, n)], 0
    INS, DEL, SUB = 1, 2, 0
    prev = np.zeros(m + 1, dtype=np.int32) if free_t_start else np.arange(m + 1, dtype=np.int32)
    tb = np.zeros((n + 1, m + 1), dtype=np.uint8)
    if not free_t_start:
        tb[0, 1:] = DEL
    tarr = np.frombuffer(t, dtype=np.uint8)
    qarr = np.frombuffer(q, dtype=np.uint8)
    for i in range(1, n + 1):
        cur = np.empty(m + 1, dtype=np.int32)
        cur[0] = i
        sub = prev[:-1] + (tarr != qarr[i - 1])
        ins = prev[1:] + 1
        best = np.minimum(sub, ins)
        choice = np.where(sub <= ins, SUB, INS)
        # deletions need a sequential pass
        for j in range(1, m + 1):
            d = cur[j - 1] + 1
            if d < best[j - 1]:
                cur[j] = d
                tb[i, j] = DEL
            else:
                cur[j] = best[j - 1]
                tb[i, j] = choice[j - 1]
        tb[i, 0] = INS
        prev = cur
    j_end = int(np.argmin(prev)) if free_t_end else m
    # traceback
    ops: List[Tuple[int, int]] = []
    i, j = n, j_end
    while i > 0 or (j > 0 and not free_t_start):
        if free_t_start and i == 0:
            break
        mv = tb[i, j]
        if i > 0 and j > 0 and mv == SUB:
            op = 0
            i, j = i - 1, j - 1
        elif i > 0 and (mv == INS or j == 0):
            op = 1
            i -= 1
        else:
            op = 2
            j -= 1
        if ops and ops[-1][0] == op:
            ops[-1] = (op, ops[-1][1] + 1)
        else:
            ops.append((op, 1))
    ops.reverse()
    return ops, j


def _push(ops: List[Tuple[int, int]], op: int, length: int) -> None:
    if length <= 0:
        return
    if ops and ops[-1][0] == op:
        ops[-1] = (op, ops[-1][1] + length)
    else:
        ops.append((op, length))


@dataclass
class AlignResult:
    pos: int                      # target start
    cigar: List[Tuple[int, int]]  # with soft clips
    reverse: bool
    nmatch: int


def align_read(index: TargetIndex, tseq: bytes, read: bytes,
               max_patch: int = 4000, band_slop: int = 1000) -> Optional[AlignResult]:
    """Align one HiFi read against the indexed target. Returns None if unmapped."""
    best = None
    for reverse in (False, True):
        seq = revcomp(read) if reverse else read
        qk, qpos = _forward_kmers(seq_to_codes(seq), index.k)
        if len(qpos) == 0:
            continue
        t, q = index.hits(qk[qpos], qpos)
        if len(t) < 8:
            continue
        diag = t - q
        # dominant diagonal band via coarse histogram
        band = np.round(diag / band_slop).astype(np.int64)
        vals, cnts = np.unique(band, return_counts=True)
        b0 = vals[np.argmax(cnts)]
        sel = (band >= b0 - 1) & (band <= b0 + 1)
        score = int(cnts.max())
        if best is None or score > best[0]:
            best = (score, reverse, t[sel], q[sel], seq)
    if best is None:
        return None
    _, reverse, t, q, seq = best

    # chain: sort by qpos then keep tpos strictly increasing (greedy LIS-ish;
    # anchors within one diagonal band so greedy works)
    order = np.lexsort((t, q))
    t, q = t[order], q[order]
    keep_t = -1
    keep_q = -1
    anchors: List[Tuple[int, int]] = []
    for ti, qi in zip(t, q):
        if ti > keep_t and qi > keep_q:
            anchors.append((int(ti), int(qi)))
            keep_t, keep_q = ti, qi
    if len(anchors) < 2:
        return None

    k = index.k
    ops: List[Tuple[int, int]] = []
    nmatch = 0
    t0, q0 = anchors[0]
    # left end: patch to read start if close, else soft clip
    if q0 > 0:
        tl = max(0, t0 - q0 - 50)
        if q0 <= max_patch and t0 > 0:
            seg_ops, j0 = _edit_align(seq[:q0], tseq[tl:t0], free_t_start=True)
            t_start = tl + j0
            for op, l in seg_ops:
                _push(ops, op, l)
        else:
            _push(ops, 4, q0)  # soft clip
            t_start = t0
    else:
        t_start = t0
    _push(ops, 0, k)
    nmatch += k
    pt, pq = t0 + k, q0 + k

    for ti, qi in anchors[1:]:
        if ti < pt or qi < pq:
            continue  # overlapped by previous anchor extension
        dt, dq = ti - pt, qi - pq
        if dt == 0 and dq == 0:
            pass
        elif dt == dq and seq[pq:qi] == tseq[pt:ti]:
            _push(ops, 0, dt)
            nmatch += dt
        elif dt <= max_patch and dq <= max_patch:
            for op, l in _edit_align(seq[pq:qi], tseq[pt:ti])[0]:
                _push(ops, op, l)
        else:
            return None  # refuse wild gaps; data-prep tool, not a general mapper
        _push(ops, 0, k)
        nmatch += k
        pt, pq = ti + k, qi + k

    # right end
    qrem = len(seq) - pq
    if qrem > 0:
        trem = min(len(tseq) - pt, qrem + 50)
        if qrem <= max_patch and trem > 0:
            seg_ops, _ = _edit_align(seq[pq:], tseq[pt : pt + trem], free_t_end=True)
            for op, l in seg_ops:
                _push(ops, op, l)
        else:
            _push(ops, 4, qrem)

    return AlignResult(pos=t_start, cigar=ops, reverse=reverse, nmatch=nmatch)


def align_to_bam(target_path_seqs: List[Tuple[str, bytes]],
                 reads: List[Tuple[str, bytes]],
                 out_bam: str, k: int = 15) -> int:
    """Align reads to targets, write a coordinate-sorted BAM. Returns #mapped."""
    refs = [(name, len(seq)) for name, seq in target_path_seqs]
    results: List[BamRecord] = []
    for tid, (tname, tseq) in enumerate(target_path_seqs):
        index = TargetIndex.build(tseq, k=k)
        for rname, rseq in reads:
            r = align_read(index, tseq, rseq)
            if r is None:
                continue
            seq_ref_orient = revcomp(rseq) if r.reverse else rseq
            results.append(BamRecord(
                qname=rname.encode(), flag=(16 if r.reverse else 0), tid=tid,
                pos=r.pos, mapq=60, cigar=r.cigar, seq=seq_ref_orient,
            ))
    results.sort(key=lambda rec: (rec.tid, rec.pos))
    with BamWriter(out_bam, refs) as w:
        for rec in results:
            w.write(rec)
    return len(results)
