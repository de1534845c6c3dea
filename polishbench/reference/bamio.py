"""The reference's BAM reader: pure Python over gzip, one contig's records
at a time (SAMv1). A frozen copy of the polisher's fallback reader.
"""

from __future__ import annotations

import gzip
import struct
from dataclasses import dataclass
from typing import Iterator, List, Tuple

import numpy as np

BAM_MAGIC = b"BAM\x01"

CIGAR_OPS = "MIDNSHP=X"
_CONSUMES_REF = (True, False, True, True, False, False, False, True, True)
_CONSUMES_QRY = (True, True, False, False, True, False, False, True, True)

# 4-bit seq code -> ASCII
SEQ4_TO_ASCII = np.frombuffer(b"=ACMGRSVTWYHKDBN", dtype=np.uint8)
ASCII_TO_SEQ4 = np.zeros(256, dtype=np.uint8)
for _i, _c in enumerate(b"=ACMGRSVTWYHKDBN"):
    ASCII_TO_SEQ4[_c] = _i
    ASCII_TO_SEQ4[_c | 0x20] = _i  # lowercase
ASCII_TO_SEQ4[ord("N")] = 15
ASCII_TO_SEQ4[ord("n")] = 15

FUNMAP = 0x4
FREVERSE = 0x10
FSECONDARY = 0x100
FQCFAIL = 0x200
FDUP = 0x400
FSUPPLEMENTARY = 0x800


@dataclass
class BamRecord:
    qname: bytes
    flag: int
    tid: int
    pos: int
    mapq: int
    cigar: List[Tuple[int, int]]  # (op_code, length)
    seq: bytes                    # ASCII, ref orientation (as stored in BAM)
    qual: bytes = b""

    @property
    def is_unmapped(self) -> bool:
        return bool(self.flag & FUNMAP)

    @property
    def is_secondary(self) -> bool:
        return bool(self.flag & FSECONDARY)

    @property
    def is_supplementary(self) -> bool:
        return bool(self.flag & FSUPPLEMENTARY)

    @property
    def is_reverse(self) -> bool:
        return bool(self.flag & FREVERSE)

    def reference_end(self) -> int:
        """pos + ref-consuming cigar length (rust-htslib reference_end)."""
        return self.pos + sum(l for op, l in self.cigar if _CONSUMES_REF[op])

    def seq_len_from_cigar(self, include_hard_clip: bool = True) -> int:
        """Read length from CIGAR (rust-htslib seq_len_from_cigar, main.rs:1758)."""
        n = 0
        for op, l in self.cigar:
            if _CONSUMES_QRY[op] or (include_hard_clip and op == 5):
                n += l
        return n


_AUX_FIXED = {65: 1, 99: 1, 67: 1, 115: 2, 83: 2, 105: 4, 73: 4, 102: 4}
# A     c     C     s      S      i      I      f


def _find_cg_cigar(data: bytes, off: int):
    """Scan a BAM record's aux block for the CG:B,I real-CIGAR array
    (SAMv1 §4.2.2 long-CIGAR convention); None if absent/malformed."""
    n = len(data)
    while off + 4 <= n:
        tag = data[off : off + 2]
        typ = data[off + 2]
        off += 3
        if typ == 66:  # 'B' array
            if off + 5 > n:
                return None
            sub = data[off]
            (cnt,) = struct.unpack_from("<I", data, off + 1)  # count is u32
            esz = _AUX_FIXED.get(sub, 4)
            if tag == b"CG" and sub in (73, 105) and off + 5 + 4 * cnt <= n:
                arr = np.frombuffer(data, dtype="<u4", count=cnt,
                                    offset=off + 5)
                return [(int(c) & 0xF, int(c) >> 4) for c in arr]
            off += 5 + esz * cnt
        elif typ in (90, 72):  # 'Z' / 'H'
            end = data.find(b"\x00", off)
            if end < 0:
                return None
            off = end + 1
        elif typ in _AUX_FIXED:
            off += _AUX_FIXED[typ]
        else:
            return None
    return None


class BamReader:
    """Sequential BAM reader. Exposes references (names + lengths) and an iterator
    of records; `by_contig()` groups the sorted stream per tid."""

    def __init__(self, path: str):
        self._f = gzip.open(path, "rb")
        magic = self._f.read(4)
        if magic != BAM_MAGIC:
            raise ValueError(f"{path}: not a BAM file")
        (l_text,) = struct.unpack("<i", self._f.read(4))
        self.header_text = self._f.read(l_text).rstrip(b"\x00").decode(errors="replace")
        (n_ref,) = struct.unpack("<i", self._f.read(4))
        self.references: List[Tuple[str, int]] = []
        for _ in range(n_ref):
            (l_name,) = struct.unpack("<i", self._f.read(4))
            name = self._f.read(l_name)[:-1].decode()
            (l_ref,) = struct.unpack("<i", self._f.read(4))
            self.references.append((name, l_ref))

    def __iter__(self) -> Iterator[BamRecord]:
        read = self._f.read
        unpack = struct.Struct("<iiBBHHHiiii").unpack  # after block_size
        while True:
            bs = read(4)
            if len(bs) < 4:
                return
            (block_size,) = struct.unpack("<i", bs)
            data = read(block_size)
            if len(data) < block_size:
                raise ValueError("truncated BAM record")
            (refid, pos, l_read_name, mapq, _bin, n_cigar, flag, l_seq,
             _nref, _npos, _tlen) = unpack(data[:32])
            off = 32
            qname = data[off : off + l_read_name - 1]
            off += l_read_name
            cigar_raw = np.frombuffer(data, dtype="<u4", count=n_cigar, offset=off)
            cigar = [(int(c) & 0xF, int(c) >> 4) for c in cigar_raw]
            off += 4 * n_cigar
            nseq = (l_seq + 1) // 2
            seq4 = np.frombuffer(data, dtype=np.uint8, count=nseq, offset=off)
            hi = SEQ4_TO_ASCII[seq4 >> 4]
            lo = SEQ4_TO_ASCII[seq4 & 0xF]
            seq = np.empty(2 * nseq, dtype=np.uint8)
            seq[0::2] = hi
            seq[1::2] = lo
            off += nseq
            qual = data[off : off + l_seq]
            # Long-CIGAR records: n_cigar is u16 in BAM, so >65535-op
            # alignments carry a "<l_seq>S <ref_len>N" placeholder with the
            # real CIGAR in the CG:B,I aux tag (htslib behavior behind
            # rust-htslib's r.cigar(), main.rs:1785)
            if (n_cigar == 2 and l_seq > 0 and cigar[0] == (4, l_seq)
                    and cigar[1][0] == 3):
                cg = _find_cg_cigar(data, off + l_seq)
                if cg is not None:
                    cigar = cg
            yield BamRecord(qname=qname, flag=flag, tid=refid, pos=pos, mapq=mapq,
                            cigar=cigar, seq=seq[:l_seq].tobytes(), qual=qual)

    def by_contig(self) -> Iterator[Tuple[int, List[BamRecord]]]:
        """Group the (sorted) stream by tid; yields (tid, records). Asserts sorted
        order like the reference (main.rs:1753-1756)."""
        cur_tid = None
        cur: List[BamRecord] = []
        prev_pos = -1
        for rec in self:
            if rec.tid < 0:
                continue  # unmapped at end of sorted BAM
            if rec.tid != cur_tid:
                if cur_tid is not None:
                    assert rec.tid > cur_tid, "Unsorted input file!"
                    yield cur_tid, cur
                cur_tid, cur, prev_pos = rec.tid, [], -1
            else:
                assert rec.pos >= prev_pos, "Unsorted input file!"
            prev_pos = rec.pos
            cur.append(rec)
        if cur_tid is not None:
            yield cur_tid, cur

    def close(self):
        self._f.close()
