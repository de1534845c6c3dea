"""Alignment ingest for the oracle engine: CIGAR expansion, trim, align tags,
clip filter.

Faithful reimplementation of the reference semantics (src/main.rs:270-589); the
packed 4-bit AlignSeq storage (main.rs:270-351) is replaced by explicit numpy tag
arrays (t_pos, delta, q_base) with identical decoded content — packing is a storage
detail, the tag stream is the semantic object.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from .config import PolishConfig
from .bamio import BamRecord
from .seqcodes import ASCII2CODE

U32_MAX = 0xFFFFFFFF
HEAD_QBASE = 15  # AlignBase::head marker (main.rs:41-47)


class AlignTags:
    """One alignment as a decoded tag stream (equivalent of AlignSeq).

    t_pos/delta/q_base arrays have one entry per post-shift alignment column
    (main.rs:314-338 get_align_tag); aln_t_s/aln_t_e as in AlignSeq::new
    (aln_t_e = last ref position covered, inclusive).

    `delta` is derived lazily from t_pos when not supplied:
    delta[i] = i - (last index at which t_pos advanced).
    """

    __slots__ = ("aln_t_s", "aln_t_e", "t_pos", "_delta", "q_base",
                 "clip_label", "dropped")

    def __init__(self, aln_t_s: int, aln_t_e: int, t_pos: np.ndarray,
                 delta: Optional[np.ndarray] = None,
                 q_base: Optional[np.ndarray] = None,
                 clip_label: bool = False, dropped: bool = False):
        self.aln_t_s = aln_t_s
        self.aln_t_e = aln_t_e
        self.t_pos = t_pos
        self._delta = delta
        self.q_base = q_base
        self.clip_label = clip_label
        self.dropped = dropped  # align_bases cleared (clip filter / phasing)

    @property
    def delta(self) -> np.ndarray:
        if self._delta is None:
            t = self.t_pos
            n = len(t)
            idx = np.arange(n, dtype=np.int64)
            chg = np.empty(n, dtype=bool)
            if n:
                chg[0] = True
                chg[1:] = t[1:] != t[:-1]
            last = np.maximum.accumulate(np.where(chg, idx, 0)) if n else idx
            self._delta = idx - last
        return self._delta

    def __len__(self) -> int:
        return len(self.t_pos)


@dataclass
class Expanded:
    """Gapped pairwise alignment (equivalent of Alignment, main.rs:353-529)."""

    aln_t_s: int
    aln_t_e: int
    aln_q_s: int
    aln_q_e: int
    q_codes: np.ndarray  # uint8 codes incl 4 for '-'
    t_codes: np.ndarray
    t_gap: np.ndarray    # bool: t is '-'
    q_gap: np.ndarray
    shift: int = 0

    def aln_len(self) -> int:
        return len(self.t_codes) - self.shift


def expand_cigar(rec: BamRecord, tseq_codes: np.ndarray) -> Expanded:
    """CIGAR -> two gapped code arrays (reference fill_with_cigar, main.rs:386-440).

    tseq_codes are the codes of the FULL contig; positions are absolute.
    Panics (raises) on N/P ops like the reference.
    """
    qcodes = ASCII2CODE[np.frombuffer(rec.seq, dtype=np.uint8)]
    t_parts: List[np.ndarray] = []
    q_parts: List[np.ndarray] = []
    qs = 0
    ts = rec.pos
    aln_q_s = 0
    aln_q_e = 0
    is_first = True
    for op, l in rec.cigar:
        if op == 4:  # soft clip
            qs += l
            if is_first:
                aln_q_s = qs
            else:
                aln_q_e = qs - l
        elif op in (0, 7, 8):  # M/=/X
            q_parts.append(qcodes[qs : qs + l])
            t_parts.append(tseq_codes[ts : ts + l])
            qs += l
            ts += l
        elif op == 1:  # I
            q_parts.append(qcodes[qs : qs + l])
            t_parts.append(np.full(l, 4, dtype=np.uint8))
            qs += l
        elif op == 2:  # D
            q_parts.append(np.full(l, 4, dtype=np.uint8))
            t_parts.append(tseq_codes[ts : ts + l])
            ts += l
        elif op == 5:  # hard clip
            pass
        else:
            raise ValueError(f"Unknown cigar op: {op}")
        is_first = False
    if aln_q_e == 0:
        aln_q_e = qs
    t_codes = np.concatenate(t_parts) if t_parts else np.zeros(0, dtype=np.uint8)
    q_codes = np.concatenate(q_parts) if q_parts else np.zeros(0, dtype=np.uint8)
    return Expanded(
        aln_t_s=rec.pos, aln_t_e=ts, aln_q_s=aln_q_s, aln_q_e=aln_q_e,
        q_codes=q_codes, t_codes=t_codes,
        t_gap=t_codes == 4, q_gap=q_codes == 4,
    )


def trim(aln: Expanded, length: int) -> None:
    """Trim so the alignment starts/ends with `length` exactly-matched columns
    (reference Alignment::trim, main.rs:446-513). Sets aln.shift; truncates arrays.

    Vectorized: shift = start of the first length-run of matches; end truncated to
    the end of the last length-run; aln_{t,q}_{s,e} adjusted by the count of
    target/query-consuming columns outside [shift, new_len) — identical net effect
    to the reference's per-column bookkeeping.

    NOTE reference compares raw ASCII; we compare codes. Identical except exotic
    bases (e.g. 'R' vs 'Y' both code 4 and would compare equal here but unequal as
    ASCII) — both appear only in malformed input.
    """
    t, q = aln.t_codes, aln.q_codes
    n = len(t)
    if n == 0:
        aln.shift = 0
        return
    match = t == q
    idx = np.arange(n, dtype=np.int64)
    lastbad = np.maximum.accumulate(np.where(~match, idx, -1))
    run = idx - lastbad
    complete = run >= length
    if not complete.any():
        # reference walks the whole alignment before giving up, accumulating
        # start offsets (main.rs:453-476); the record is filtered later anyway
        aln.aln_t_s += int((t != 4).sum())
        aln.aln_q_s += int((q != 4).sum())
        aln.shift = n
        return
    i0 = int(np.argmax(complete))          # first column completing a run
    shift = i0 + 1 - length
    tcons = np.concatenate([[0], np.cumsum(t != 4)])
    qcons = np.concatenate([[0], np.cumsum(q != 4)])
    aln.aln_t_s += int(tcons[shift])
    aln.aln_q_s += int(qcons[shift])
    aln.shift = shift
    i1 = n - 1 - int(np.argmax(complete[::-1]))  # last column completing a run
    new_len = i1 + 1
    aln.aln_t_e -= int(tcons[n] - tcons[new_len])
    aln.aln_q_e -= int(qcons[n] - qcons[new_len])
    if new_len < n:
        aln.t_codes = aln.t_codes[:new_len]
        aln.q_codes = aln.q_codes[:new_len]
        aln.t_gap = aln.t_gap[:new_len]
        aln.q_gap = aln.q_gap[:new_len]


def to_tags(aln: Expanded, clip_label: bool = False) -> AlignTags:
    """Expanded alignment -> tag stream (reference AlignSeq::new + get_align_tag,
    main.rs:278-338): t gaps ('-' in target) increment delta; others advance t_pos.
    """
    t = aln.t_codes[aln.shift :]
    q = aln.q_codes[aln.shift :]
    n = len(t)
    tgap = t == 4
    # t_pos: first column is aln_t_s; each non-t-gap column after the first advances
    adv = (~tgap).astype(np.int64)
    if n:
        adv[0] = 0
    t_pos = aln.aln_t_s + np.cumsum(adv)
    # delta: count of consecutive t-gap columns since last advance
    # delta[i] = i - last index with non-gap (or 0 at i=0)
    idx = np.arange(n, dtype=np.int64)
    nz = np.where(~tgap, idx, -1)
    if n:
        nz[0] = 0  # first column acts as delta 0 regardless (main.rs:331-334)
    last_adv = np.maximum.accumulate(nz)
    delta = idx - last_adv
    aln_t_e = int(t_pos[-1]) if n else aln.aln_t_s
    return AlignTags(
        aln_t_s=aln.aln_t_s,
        aln_t_e=aln_t_e,
        t_pos=t_pos.astype(np.int64),
        delta=delta.astype(np.int64),
        q_base=q.astype(np.uint8),
        clip_label=clip_label,
    )


def ref_as_tags(tseq_codes: np.ndarray) -> AlignTags:
    """The contig itself as alignseqs[0] (reference main.rs:1732-1739)."""
    n = len(tseq_codes)
    return AlignTags(
        aln_t_s=0,
        aln_t_e=n - 1,
        t_pos=np.arange(n, dtype=np.int64),
        delta=np.zeros(n, dtype=np.int64),
        q_base=tseq_codes.astype(np.uint8),
    )


def filter_by_clip(alignseqs: List[AlignTags], cfg: PolishConfig) -> None:
    """Drop clipped alignments wholly inside regions covered by unclipped ones
    (reference filter_alignseqs_by_clip, main.rs:531-574). Marks .dropped."""
    offset = cfg.clip_margin
    ranges: List[tuple[int, int]] = []
    s = e = 0
    for a in alignseqs:
        if a.clip_label:
            continue
        ats, ate = a.aln_t_s + offset, a.aln_t_e - offset
        if s == e:
            s, e = ats, ate
        elif ats > e:
            ranges.append((s, e))
            s, e = ats, ate
        elif e < ate:
            e = ate
    if s != e:
        ranges.append((s, e))

    def in_ranges(start: int, end: int) -> bool:
        for rs, re in ranges:
            if rs <= start and end <= re:
                return True
            if end < rs:
                break
        return False

    for a in alignseqs:
        if a.clip_label:
            a.clip_label = False
            if in_ranges(a.aln_t_s, a.aln_t_e):
                a.dropped = True


def record_to_tags(rec: BamRecord, tseq_codes: np.ndarray, tseq_len: int,
                   cfg: PolishConfig) -> Optional[AlignTags]:
    """Filter + expand + trim + pack one BAM record (reference worker loop,
    main.rs:1751-1816). Returns None if filtered out."""
    rlen = rec.seq_len_from_cigar(True)
    if rec.flag & 0x404:
        return None
    if rec.mapq <= cfg.min_map_qual:
        return None
    if rlen <= cfg.min_read_len:
        return None
    if rec.is_secondary and not cfg.use_secondary:
        return None
    if rec.is_supplementary and not cfg.use_supplementary:
        return None
    if rec.reference_end() - rec.pos < max(cfg.min_map_len, int(rlen * cfg.min_map_fra)):
        return None
    aln = expand_cigar(rec, tseq_codes)
    is_clip = aln.aln_q_e - aln.aln_q_s + cfg.max_clip_len < rlen
    trim(aln, cfg.trim_len)
    if aln.aln_len() <= cfg.min_map_len:
        return None
    if is_clip and tseq_len < cfg.short_ref_len:
        # short references: clipped alignments dropped outright (main.rs:1806-1810)
        return None
    return to_tags(aln, clip_label=is_clip)
