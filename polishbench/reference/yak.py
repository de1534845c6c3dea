"""The reference's yak k-mer tables: load a v2 dump into sorted arrays
and look k-mers up by binary search, on the host alone (lh3/yak format;
NextPolish2 src/utils/kmer.rs). A frozen copy of the polisher's host
lookup with its device and mesh routes taken out.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np


YAK_MAGIC = b"YAK\x02"
YAK_COUNTER_BITS = 10
YAK_MAX_COUNT = (1 << YAK_COUNTER_BITS) - 1
INVALID_KMER = np.uint64(0xFFFFFFFFFFFFFFFF)

_U64 = np.uint64


def yak_hash64(key: np.ndarray | int, mask: int) -> np.ndarray | int:
    """Invertible integer hash (reference kmer.rs:223-233), vectorized over u64."""
    scalar = np.isscalar(key) or (isinstance(key, np.ndarray) and key.ndim == 0)
    key = np.asarray(key, dtype=_U64)
    mask = _U64(mask)
    with np.errstate(over="ignore"):
        key = (~key + (key << _U64(21))) & mask
        key = key ^ (key >> _U64(24))
        key = ((key + (key << _U64(3))) + (key << _U64(8))) & mask
        key = key ^ (key >> _U64(14))
        key = ((key + (key << _U64(2))) + (key << _U64(4))) & mask
        key = key ^ (key >> _U64(28))
        key = (key + (key << _U64(31))) & mask
    return key.item() if scalar else key


def yak_hash64_64(key: np.ndarray) -> np.ndarray:
    """64-bit (unmasked) variant (reference kmer.rs:235-244)."""
    key = np.asarray(key, dtype=_U64)
    with np.errstate(over="ignore"):
        key = ~key + (key << _U64(21))
        key = key ^ (key >> _U64(24))
        key = (key + (key << _U64(3))) + (key << _U64(8))
        key = key ^ (key >> _U64(14))
        key = (key + (key << _U64(2))) + (key << _U64(4))
        key = key ^ (key >> _U64(28))
        key = key + (key << _U64(31))
    return key


def yak_hash_long(x0, x1, x2, x3) -> np.ndarray:
    """Hash of the 4-plane k>=32 representation (reference kmer.rs:246-249).

    Irreversible by design; replicate semantics, do not 'fix' (SURVEY §7 hard parts).
    """
    use_fwd = x1 < x3
    a = np.where(use_fwd, x0, x2)
    b = np.where(use_fwd, x1, x3)
    with np.errstate(over="ignore"):
        return yak_hash64_64(a) + yak_hash64_64(b)


def rolling_kmers(codes: np.ndarray, ksize: int) -> tuple[np.ndarray, np.ndarray]:
    """Canonical rolling k-mers over a code sequence.

    Returns (kmers, valid): for each end position j, kmers[j] is the canonical k-mer
    (k < 32: min(forward, revcomp) 2-bit packed; k >= 32: yak_hash_long of the 4-plane
    form) over codes[j-k+1 .. j], and valid[j] is True iff all k codes are < 4.
    Matches reference iter2kmer (kmer.rs:255-314): an invalid base resets the run.
    """
    codes = np.asarray(codes)
    n = codes.shape[0]
    kmers = np.zeros(n, dtype=_U64)
    if n < ksize:
        return kmers, np.zeros(n, dtype=bool)

    is_valid = codes < 4
    # trailing run length of valid codes ending at j
    pos = np.arange(n, dtype=np.int64)
    last_bad = np.where(~is_valid, pos, np.int64(-1))
    last_bad = np.maximum.accumulate(last_bad)
    run = pos - last_bad
    valid = run >= ksize

    c = codes.astype(_U64)
    with np.errstate(over="ignore"):
        if ksize < 32:
            fwd = np.zeros(n, dtype=_U64)
            rev = np.zeros(n, dtype=_U64)
            mask = _U64((1 << (2 * ksize)) - 1)
            for t in range(ksize):
                # window position t (0 = leftmost) contributes to end position j
                ct = c[t : n - ksize + 1 + t]
                sl = slice(ksize - 1, n)
                fwd[sl] |= ct << _U64(2 * (ksize - 1 - t))
                rev[sl] |= (_U64(3) ^ ct) << _U64(2 * t)
            fwd &= mask
            kmers = np.minimum(fwd, rev)
        else:
            mask = _U64((1 << ksize) - 1)
            x0 = np.zeros(n, dtype=_U64)
            x1 = np.zeros(n, dtype=_U64)
            x2 = np.zeros(n, dtype=_U64)
            x3 = np.zeros(n, dtype=_U64)
            for t in range(ksize):
                ct = c[t : n - ksize + 1 + t]
                lo = ct & _U64(1)
                hi = (ct >> _U64(1)) & _U64(1)
                sl = slice(ksize - 1, n)
                x0[sl] |= lo << _U64(ksize - 1 - t)
                x1[sl] |= hi << _U64(ksize - 1 - t)
                x2[sl] |= (_U64(1) - lo) << _U64(t)
                x3[sl] |= (_U64(1) - hi) << _U64(t)
            x0 &= mask
            x1 &= mask
            kmers = yak_hash_long(x0, x1, x2, x3)
    kmers = np.where(valid, kmers, _U64(0))
    return kmers, valid


@dataclass
class KmerTable:
    """A loaded yak table: per-bin sorted key arrays for vectorized exact lookups.

    keys[bin_off[b]:bin_off[b+1]] are the sorted (hash >> 10) identities of bin b;
    counts aligns with keys. to_hash/get mirror KmerInfo semantics (kmer.rs:102-124).
    """

    ksize: int
    pre: int
    bin_off: np.ndarray = field(repr=False)   # int64 [2^pre + 1]
    keys: np.ndarray = field(repr=False)      # u64, sorted within each bin
    counts: np.ndarray = field(repr=False)    # u16, aligned with keys
    # composite (bin << 54 | key) is globally sorted when pre + 54 <= 64, enabling
    # one vectorized searchsorted for the whole batch (key = hash >> 10 is <= 54 bits)
    composite: np.ndarray | None = field(default=None, repr=False)

    def __post_init__(self):
        if self.composite is None and self.pre + 54 <= 64 and len(self.keys):
            nbins = 1 << self.pre
            sizes = np.diff(self.bin_off)
            bin_ids = np.repeat(np.arange(nbins, dtype=_U64), sizes)
            self.composite = (bin_ids << _U64(54)) | self.keys

    @property
    def kmask(self) -> int:
        return (1 << (2 * self.ksize)) - 1

    @property
    def pmask(self) -> int:
        return (1 << self.pre) - 1

    def to_hash(self, kmers: np.ndarray) -> np.ndarray:
        """Canonical k-mer -> full yak hash V (identity for k >= 32, kmer.rs:102-110)."""
        if self.ksize < 32:
            return yak_hash64(kmers, self.kmask)
        return np.asarray(kmers, dtype=_U64)

    def get(self, hashes: np.ndarray, min_count: int = 0) -> np.ndarray:
        """Vectorized lookup: hash V -> stored count, 0 if absent or count < min_count.

        Combines the reference's retrieve_kmers min-count filter (kmer.rs:160-161)
        with the get (kmer.rs:123-125): a present k-mer with count < min_count
        behaves as absent (count 0).
        """
        hashes = np.atleast_1d(np.asarray(hashes, dtype=_U64))
        if len(self.keys) == 0:
            return np.zeros(len(hashes), dtype=np.uint16)
        keys = hashes >> _U64(YAK_COUNTER_BITS)
        if self.composite is not None:
            bins = hashes & _U64(self.pmask)
            q = (bins << _U64(54)) | keys
            idx = np.searchsorted(self.composite, q)
            idx_c = np.minimum(idx, len(self.composite) - 1)
            found = (idx < len(self.composite)) & (self.composite[idx_c] == q)
        else:  # very large pre: per-bin segments
            bins = (hashes & _U64(self.pmask)).astype(np.int64)
            lo = self.bin_off[bins]
            hi = self.bin_off[bins + 1]
            idx = np.empty(len(hashes), dtype=np.int64)
            for i in range(len(hashes)):
                idx[i] = lo[i] + np.searchsorted(self.keys[lo[i] : hi[i]], keys[i])
            idx_c = np.minimum(idx, len(self.keys) - 1)
            found = (idx < hi) & (self.keys[idx_c] == keys)
        out = np.where(found, self.counts[idx_c], 0)
        return np.where(out >= min_count, out, 0).astype(np.uint16)


def read_yak_header(path: str) -> tuple[int, int, int]:
    with open(path, "rb") as f:
        hdr = f.read(16)
    if hdr[:4] != YAK_MAGIC:
        raise ValueError(f"{path}: not a yak v2 dump (bad magic)")
    ksize, pre, cbits = struct.unpack("<3I", hdr[4:16])
    if cbits != YAK_COUNTER_BITS:
        raise ValueError(f"{path}: counter_bits {cbits} != {YAK_COUNTER_BITS}")
    return ksize, pre, cbits


def load_yak(path: str, min_count: int = 0) -> KmerTable:
    """Load a .yak dump fully into a KmerTable (keys sorted within bins)."""
    ksize, pre, _ = read_yak_header(path)
    nbins = 1 << pre
    bin_sizes = np.zeros(nbins, dtype=np.int64)
    all_keys: list[np.ndarray] = []
    all_counts: list[np.ndarray] = []
    with open(path, "rb") as f:
        f.seek(16)
        for b in range(nbins):
            bhdr = f.read(8)
            if len(bhdr) < 8:
                raise ValueError(f"{path}: truncated bin header {b}")
            (size,) = struct.unpack("<I", bhdr[4:8])
            raw = np.fromfile(f, dtype="<u8", count=size)
            counts = (raw & _U64(YAK_MAX_COUNT)).astype(np.uint16)
            keys = raw >> _U64(YAK_COUNTER_BITS)
            if min_count > 0:
                keep = counts >= min_count
                keys, counts = keys[keep], counts[keep]
            order = np.argsort(keys, kind="stable")
            all_keys.append(keys[order])
            all_counts.append(counts[order])
            bin_sizes[b] = len(keys)
    bin_off = np.zeros(nbins + 1, dtype=np.int64)
    np.cumsum(bin_sizes, out=bin_off[1:])
    return KmerTable(
        ksize=ksize,
        pre=pre,
        bin_off=bin_off,
        keys=np.concatenate(all_keys) if all_keys else np.zeros(0, dtype=_U64),
        counts=np.concatenate(all_counts) if all_counts else np.zeros(0, dtype=np.uint16),
    )
