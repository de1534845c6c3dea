"""The benchmark's own writers for its generated inputs: BGZF-framed BAM and
yak k-mer count tables, and the canonical k-mer hashing the tables need.

Self-contained (numpy and the standard library only), so that the inputs a
run polishes never depend on the program under test. The formats follow
SAMv1 (BAM records, BGZF blocks and EOF marker) and lh3/yak's v2 dump
(magic, header, 2^pre bins of u64 entries `(hash >> 10) << 10 | count`).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_U64 = np.uint64
BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")
_BGZF_BLOCK = 65280  # uncompressed payload per block

YAK_MAGIC = b"YAK\x02"
YAK_COUNTER_BITS = 10
YAK_MAX_COUNT = (1 << YAK_COUNTER_BITS) - 1

ASCII_TO_SEQ4 = np.zeros(256, dtype=np.uint8)
for _i, _c in enumerate(b"=ACMGRSVTWYHKDBN"):
    ASCII_TO_SEQ4[_c] = _i
    ASCII_TO_SEQ4[_c | 0x20] = _i
# ASCII -> 2-bit code (A C G T), 4 for anything else
ASCII_TO_CODE = np.full(256, 4, dtype=np.uint8)
for _i, _c in enumerate(b"ACGT"):
    ASCII_TO_CODE[_c] = _i
    ASCII_TO_CODE[_c | 0x20] = _i


class BgzfWriter:
    """Blocked gzip: members of at most 64 KiB of payload, each carrying
    its compressed size in a BC extra field, then the fixed EOF block."""

    def __init__(self, fileobj, level: int = 1):
        self._f = fileobj
        self._level = level
        self._buf = bytearray()

    def write(self, data: bytes) -> None:
        self._buf += data
        while len(self._buf) >= _BGZF_BLOCK:
            self._block(bytes(self._buf[:_BGZF_BLOCK]))
            del self._buf[:_BGZF_BLOCK]

    def _block(self, payload: bytes) -> None:
        co = zlib.compressobj(self._level, zlib.DEFLATED, -15)
        cdata = co.compress(payload) + co.flush()
        self._f.write(struct.pack("<4BI2BH2BHH", 0x1F, 0x8B, 0x08, 0x04, 0,
                                  0, 0xFF, 6, 0x42, 0x43, 2,
                                  len(cdata) + 25))
        self._f.write(cdata)
        self._f.write(struct.pack("<II", zlib.crc32(payload),
                                  len(payload) & 0xFFFFFFFF))

    def close(self) -> None:
        if self._buf:
            self._block(bytes(self._buf))
            self._buf.clear()
        self._f.write(BGZF_EOF)
        self._f.flush()


class BamWriter:
    """Coordinate-sorted BAM of forward, primary, mapped records."""

    def __init__(self, path: str, references):
        self._raw = open(path, "wb")
        self._w = BgzfWriter(self._raw)
        text = ("@HD\tVN:1.6\tSO:coordinate\n" + "".join(
            f"@SQ\tSN:{n}\tLN:{l}\n" for n, l in references)).encode()
        self._w.write(b"BAM\x01" + struct.pack("<i", len(text)) + text
                      + struct.pack("<i", len(references)))
        for name, length in references:
            nb = name.encode() + b"\x00"
            self._w.write(struct.pack("<i", len(nb)) + nb
                          + struct.pack("<i", length))

    def write(self, qname: str, tid: int, pos: int, cigar, seq: bytes,
              mapq: int = 60) -> None:
        name = qname.encode() + b"\x00"
        ops = b"".join(struct.pack("<I", (l << 4) | op) for op, l in cigar)
        codes = ASCII_TO_SEQ4[np.frombuffer(seq, dtype=np.uint8)]
        if len(codes) % 2:
            codes = np.append(codes, 0)
        packed = ((codes[0::2] << 4) | codes[1::2]).astype(np.uint8).tobytes()
        body = struct.pack("<iiBBHHHiiii", tid, pos, len(name), mapq, 0,
                           len(cigar), 0, len(seq), -1, -1, 0) \
            + name + ops + packed + b"\xff" * len(seq)
        self._w.write(struct.pack("<i", len(body)) + body)

    def close(self) -> None:
        self._w.close()
        self._raw.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def yak_hash64(key: np.ndarray, mask: int) -> np.ndarray:
    """yak's invertible 64-bit integer hash, masked to 2k bits."""
    key = np.asarray(key, dtype=_U64)
    m = _U64(mask)
    with np.errstate(over="ignore"):
        key = (~key + (key << _U64(21))) & m
        key = key ^ (key >> _U64(24))
        key = ((key + (key << _U64(3))) + (key << _U64(8))) & m
        key = key ^ (key >> _U64(14))
        key = ((key + (key << _U64(2))) + (key << _U64(4))) & m
        key = key ^ (key >> _U64(28))
        key = (key + (key << _U64(31))) & m
    return key


def _concat(first, first_len, last, last_len, rev: bool):
    """Packed windows of first_len + last_len bases ending at each
    position, from the windows of their first and last parts; in the
    reverse complement the last part's goes high."""
    shifted = np.zeros_like(first)
    shifted[last_len:] = first[:-last_len]  # the first part ends earlier
    if rev:
        return (last << _U64(2 * first_len)) | shifted
    return (shifted << _U64(2 * last_len)) | last


def canonical_kmers(seq: bytes, k: int) -> np.ndarray:
    """Every canonical k-mer (min of forward and reverse complement, 2 bits
    a base) of an ASCII sequence whose k bases are all ACGT, in order; a
    base outside ACGT breaks the run. k < 32. The windows are built by
    doubling: log2(k) passes over the sequence, not k."""
    if not 0 < k < 32:
        raise ValueError(f"k={k}: the generator writes tables of k < 32")
    codes = ASCII_TO_CODE[np.frombuffer(seq, dtype=np.uint8)]
    n = len(codes)
    if n < k:
        return np.zeros(0, dtype=_U64)
    pos = np.arange(n, dtype=np.int64)
    last_bad = np.maximum.accumulate(np.where(codes > 3, pos, -1))
    valid = (pos - last_bad) >= k
    c = (codes & 3).astype(_U64)
    fwd = rev = None
    length = 0
    p_fwd, p_rev, p_len = c, _U64(3) ^ c, 1
    kk = k
    while kk:
        if kk & 1:
            if fwd is None:
                fwd, rev, length = p_fwd, p_rev, p_len
            else:  # the window so far is the last part, p the first
                fwd = _concat(p_fwd, p_len, fwd, length, False)
                rev = _concat(p_rev, p_len, rev, length, True)
                length += p_len
        kk >>= 1
        if kk:
            p_fwd = _concat(p_fwd, p_len, p_fwd, p_len, False)
            p_rev = _concat(p_rev, p_len, p_rev, p_len, True)
            p_len *= 2
    return np.minimum(fwd, rev)[valid]


def count_kmers(seqs, k: int):
    """Distinct yak identities of the canonical k-mers of `seqs` and their
    counts. Sequences are joined by N, so no k-mer spans two of them."""
    km = canonical_kmers(b"N".join(seqs), k)
    h = yak_hash64(km, (1 << (2 * k)) - 1)
    return np.unique(h, return_counts=True)


def write_yak(path: str, k: int, hashes: np.ndarray, counts: np.ndarray,
              pre: int = 10) -> None:
    """A yak v2 dump of full hashes and counts (clamped at 1023)."""
    hashes = np.asarray(hashes, dtype=_U64)
    counts = np.minimum(np.asarray(counts, dtype=_U64), _U64(YAK_MAX_COUNT))
    bins = (hashes & _U64((1 << pre) - 1)).astype(np.int64)
    entries = ((hashes >> _U64(YAK_COUNTER_BITS))
               << _U64(YAK_COUNTER_BITS)) | counts
    order = np.argsort(bins, kind="stable")
    bins, entries = bins[order], entries[order]
    bounds = np.searchsorted(bins, np.arange((1 << pre) + 1))
    with open(path, "wb") as f:
        f.write(YAK_MAGIC + struct.pack("<3I", k, pre, YAK_COUNTER_BITS))
        for b in range(1 << pre):
            seg = entries[bounds[b]: bounds[b + 1]]
            f.write(struct.pack("<2I", len(seg), len(seg)))
            seg.astype("<u8").tofile(f)
