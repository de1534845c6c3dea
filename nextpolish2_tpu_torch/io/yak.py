"""yak k-mer count table IO and k-mer hashing (vectorized, host side).

Format (reference src/utils/kmer.rs:8-9,72-100,132-170; original format from lh3/yak):
    magic b"YAK\\x02", then u32 {ksize, pre, counter_bits=10};
    then 2^pre bins, each: 8-byte header whose bytes [4..8] are u32 n_entries,
    followed by n_entries little-endian u64 values e = (hash >> 10) << 10 | count.
A k-mer's full yak hash V selects bin V & ((1<<pre)-1); its identity inside the bin is
V >> 10 (counter bits overlay the low hash bits). With the stock pre == 10 the pair
(bin, e >> 10) reconstructs V exactly.

Design departure from the reference: the reference re-streams the .yak file from disk
for every query batch (kmer.rs:132-170 `retrieve_kmers`) because resident RAM was its
constraint. We load each table once into flat sorted arrays (bin offsets + sorted keys
+ counts) for O(log n) vectorized lookups. With use_device set, large batches go
to a copy of the table packed once into a device-resident open-addressing table
(ops/kmer_table.py) and probed there by a CUDA kernel.
"""

from __future__ import annotations

import os
import struct
import threading
from dataclasses import dataclass, field

import numpy as np

from ..utils.seqcodes import seq_to_codes
from ..utils.timing import count, stage

YAK_MAGIC = b"YAK\x02"
YAK_COUNTER_BITS = 10
YAK_MAX_COUNT = (1 << YAK_COUNTER_BITS) - 1
INVALID_KMER = np.uint64(0xFFFFFFFFFFFFFFFF)

# KmerTable.get sends a batch of at least this many queries to a device
# table that fits its card (NP2_KMER_DEVICE_MIN overrides). chip_smoke.py's
# k-mer phase on an H100 (PERF.md): the device route, upload and download
# included, beats the host composite search from the smallest batch
# measured (2^12 queries); with the one-time device build of E. coli's 4.6M
# keys added it breaks even from 2^16 to 2^18, as the host search's speed
# varies between runs. On a 62M-key table, whose host search is slower a
# query, its two batches a run repay their build (the build and the device
# lookups 0.43 s against 1.1-1.7 s of host search)
KMER_DEVICE_MIN = 1 << 16

_U64 = np.uint64
_device_tab_lock = threading.Lock()  # one build and upload per table
# get_sharded calls in this process (tests and chip_smoke.py read it to show
# that the mesh route was taken)
SHARDED_LOOKUPS = 0


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


def seq_kmers(seq: bytes, ksize: int) -> np.ndarray:
    """All valid canonical k-mers of an ASCII sequence, in order (like seq2kmer)."""
    kmers, valid = rolling_kmers(seq_to_codes(seq), ksize)
    return kmers[valid]


def kmer_to_seq(kmer: int, ksize: int) -> str:
    """2-bit packed k-mer -> ACGT string (reference kmer.rs:316-323; k < 32 only)."""
    return "".join("ACGT"[(int(kmer) >> (2 * i)) & 3] for i in reversed(range(ksize)))


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
    # set True (the orchestrator does on a CUDA device) to route large
    # batches through the device-resident table on `device` (None: cuda)
    use_device: bool = False
    device: object = None
    _device_tab: tuple | None = field(default=None, init=False, repr=False,
                                      compare=False)
    _device_fits: bool | None = field(default=None, init=False, repr=False,
                                      compare=False)
    # [mesh, ShardedKmerTable, planes on the 'kmer' positions, {min_count:
    # lookup fn}] of get_sharded, built for the last mesh it was asked for
    _sharded: list | None = field(default=None, init=False, repr=False,
                                  compare=False)

    def __post_init__(self):
        if self.composite is None and self.pre + 54 <= 64 and len(self.keys):
            nbins = 1 << self.pre
            sizes = np.diff(self.bin_off)
            bin_ids = np.repeat(np.arange(nbins, dtype=_U64), sizes)
            self.composite = (bin_ids << _U64(54)) | self.keys

    @classmethod
    def from_arrays(cls, ksize: int, pre: int, bin_off: np.ndarray,
                    keys: np.ndarray, counts: np.ndarray) -> "KmerTable":
        """Table from the arrays another loader produced (bridge.carry_state)."""
        return cls(ksize=int(ksize), pre=int(pre),
                   bin_off=np.asarray(bin_off, dtype=np.int64),
                   keys=np.asarray(keys, dtype=_U64),
                   counts=np.asarray(counts, dtype=np.uint16))

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

    def full_hashes(self) -> np.ndarray:
        """Reconstruct full hash values V from (bin, key): exact for pre <= 10
        (the stored identity; kmer.rs:96-124)."""
        sizes = np.diff(self.bin_off)
        bins = np.repeat(np.arange(1 << self.pre, dtype=_U64), sizes)
        return (self.keys << _U64(YAK_COUNTER_BITS)) | bins

    def device_fits(self) -> bool:
        """Whether device_table can pack this table on its device: at most
        MAX_SLOTS slots (the kernels' 32-bit slot arithmetic) and, on a CUDA
        device, the build's peak (DeviceKmerTable.device_bytes) within half
        of the memory the card has free, the rest staying for the chunk
        program. Decided once per table, before anything is built; a table
        that does not fit (a human short-read table of 2-4 G keys) stays on
        the host route."""
        import torch

        from ..ops.kmer_table import MAX_SLOTS, DeviceKmerTable
        from ..utils.torchcfg import resolve_device

        with _device_tab_lock:
            if self._device_fits is None:
                dev = resolve_device(self.device)
                slots, need = DeviceKmerTable.device_bytes(len(self.keys))
                fits = slots <= MAX_SLOTS
                if fits and dev.type == "cuda":
                    free = (torch.cuda.mem_get_info(dev)[0]
                            + torch.cuda.memory_reserved(dev)
                            - torch.cuda.memory_allocated(dev))
                    fits = need <= free // 2
                self._device_fits = fits
        return self._device_fits

    def device_route(self, n: int, env: str, default: int) -> bool:
        """Whether a batch of n queries (or bases) goes to the device table:
        use_device set, at least int(os.environ.get(env, default)) items,
        and a table that fits on its device (device_fits). Both routes are
        exact: this moves time, never output."""
        return (self.use_device and self.pre <= YAK_COUNTER_BITS
                and n >= int(os.environ.get(env, str(default)))
                and self.device_fits())

    def device_table(self) -> tuple:
        """The table packed into an open-addressing DeviceKmerTable whose
        slot entries are resident on `device`: (DeviceKmerTable, key_hi,
        key_lo, counts), the planes being views of the entries' columns, as
        the kernels' wrappers take them. Packed on that device
        (DeviceKmerTable.build_torch: the numpy build's entries, bit for
        bit) once, under a module lock, so that concurrent contig threads do
        not both pay for it."""
        from ..ops.kmer_table import DeviceKmerTable
        from ..utils.torchcfg import resolve_device

        with _device_tab_lock:
            if self._device_tab is None:
                with stage("kmer_table_build"):
                    tab = DeviceKmerTable.build_torch(
                        self.full_hashes(), self.counts, self.ksize,
                        resolve_device(self.device))
                self._device_tab = (tab, tab.key_hi, tab.key_lo, tab.counts)
        return self._device_tab

    def get_device(self, hashes: np.ndarray, min_count: int) -> np.ndarray:
        """Batched lookup in the device table (ops/kmer_table.kmer_lookup):
        the same counts as the host search."""
        import torch

        from ..ops.kmer_table import kmer_lookup

        count("kmer.queries_device", len(hashes))
        tab, hi, lo, ct = self.device_table()
        q = [torch.from_numpy(a).to(hi.device)
             for a in tab.query_host_arrays(hashes)]
        out = kmer_lookup(hi, lo, ct, *q, int(min_count), tab.n_probes)
        return out.cpu().numpy().astype(np.uint16)

    def get_sharded(self, hashes: np.ndarray, min_count: int,
                    mesh) -> np.ndarray:
        """Batched lookup in the table sharded over the mesh's 'kmer' axis
        (parallel/sharded_kmer.py): each position probes its hash-prefix
        shard for the queries it owns, and their disjoint counts are
        summed. Built and placed once per mesh, under the module lock; the
        lookup function is cached per min_count. Queries are padded to a
        power of two (at least 4096), as in the JAX package."""
        import torch

        from ..parallel.sharded_kmer import (ShardedKmerTable,
                                             make_sharded_lookup)
        from ..utils.torchcfg import bucket_pow2

        global SHARDED_LOOKUPS
        with _device_tab_lock:
            SHARDED_LOOKUPS += 1  # shows that production routing took it
            if self._sharded is None or self._sharded[0] is not mesh:
                with stage("kmer_table_build"):
                    tab = ShardedKmerTable.build(
                        self.full_hashes(), self.counts.astype(np.int64),
                        self.ksize, n_shards=int(mesh.shape["kmer"]))
                    self._sharded = [mesh, tab, tab.put(mesh), {}]
            _, tab, planes, fns = self._sharded
            fn = fns.get(min_count)
            if fn is None:
                fn = fns[min_count] = make_sharded_lookup(
                    mesh, axis="kmer", min_count=min_count,
                    n_probes=tab.n_probes)
        nq = len(hashes)
        count("kmer.queries_device", nq)
        pq = bucket_pow2(nq, 4096)
        if pq != nq:
            hashes = np.concatenate(
                [hashes, np.zeros(pq - nq, dtype=hashes.dtype)])
        q = [torch.from_numpy(a) for a in tab.query_host_arrays(hashes)]
        out = fn(*planes, *q)
        return out.cpu().numpy()[:nq].astype(np.uint16)

    def get(self, hashes: np.ndarray, min_count: int = 0) -> np.ndarray:
        """Vectorized lookup: hash V -> stored count, 0 if absent or count < min_count.

        Combines the reference's retrieve_kmers min-count filter (kmer.rs:160-161)
        with the get (kmer.rs:123-125): a present k-mer with count < min_count
        behaves as absent (count 0). Under an active mesh whose 'kmer' axis
        is wider than 1, a batch of 256 queries or more is looked up in the
        sharded table (get_sharded), whether or not the whole table fits one
        device. Otherwise a batch that device_route sends to the card (from
        NP2_KMER_DEVICE_MIN queries, default KMER_DEVICE_MIN) is looked up in
        the device table. Every route is exact.
        """
        hashes = np.atleast_1d(np.asarray(hashes, dtype=_U64))
        if self.pre <= YAK_COUNTER_BITS and len(hashes) >= 256:
            from ..parallel.mesh import axis_size, get_active_mesh

            mesh = get_active_mesh()
            if axis_size(mesh, "kmer") > 1:
                with stage("kmer_get_sharded"):
                    return self.get_sharded(hashes, min_count, mesh)
        if self.device_route(len(hashes), "NP2_KMER_DEVICE_MIN",
                             KMER_DEVICE_MIN):
            with stage("kmer_get_device"):
                return self.get_device(hashes, min_count)
        count("kmer.queries_host", len(hashes))
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


def write_yak(path: str, ksize: int, hashes: np.ndarray, counts: np.ndarray,
              pre: int = 10) -> None:
    """Write a .yak dump from full-hash values + counts (counts clamp at 1023)."""
    hashes = np.asarray(hashes, dtype=_U64)
    counts = np.minimum(np.asarray(counts, dtype=np.uint64), YAK_MAX_COUNT)
    bins = (hashes & _U64((1 << pre) - 1)).astype(np.int64)
    entries = ((hashes >> _U64(YAK_COUNTER_BITS)) << _U64(YAK_COUNTER_BITS)) | counts
    order = np.argsort(bins, kind="stable")
    bins_sorted = bins[order]
    entries_sorted = entries[order]
    bounds = np.searchsorted(bins_sorted, np.arange((1 << pre) + 1))
    with open(path, "wb") as f:
        f.write(YAK_MAGIC)
        f.write(struct.pack("<3I", ksize, pre, YAK_COUNTER_BITS))
        for b in range(1 << pre):
            seg = entries_sorted[bounds[b] : bounds[b + 1]]
            f.write(struct.pack("<2I", len(seg), len(seg)))
            seg.astype("<u8").tofile(f)


def count_kmers(seqs: list[bytes], ksize: int) -> tuple[np.ndarray, np.ndarray]:
    """Count canonical k-mers across sequences; returns (full hashes V, counts).

    Identity follows reference semantics: distinct k-mers whose (bin, hash>>10)
    collide are conflated (counts summed), mirroring yak's on-disk identity.
    """
    kmask = (1 << (2 * ksize)) - 1
    # Concatenate reads with an 'N' separator: an invalid base resets the rolling
    # window (kmer.rs:272-274), so no k-mer spans two reads and one vectorized pass
    # handles an arbitrary number of short reads.
    chunks = []
    batch: list[bytes] = []
    batch_len = 0
    for seq in list(seqs) + [b""]:
        if seq:
            batch.append(seq)
            batch_len += len(seq) + 1
        if batch and (batch_len >= 64 << 20 or not seq):
            km = seq_kmers(b"N".join(batch), ksize)
            if len(km):
                chunks.append(km)
            batch, batch_len = [], 0
    if not chunks:
        return np.zeros(0, dtype=_U64), np.zeros(0, dtype=np.int64)
    kmers = np.concatenate(chunks)
    hashes = yak_hash64(kmers, kmask) if ksize < 32 else kmers
    # conflate by stored identity: (hash >> 10, bin) == hash with pre==10
    ident = ((hashes >> _U64(YAK_COUNTER_BITS)) << _U64(YAK_COUNTER_BITS)) | (
        hashes & _U64((1 << 10) - 1)
    )
    uniq, cnt = np.unique(ident, return_counts=True)
    return uniq, cnt


def _blocks_from_paths(paths, block_bytes: int):
    """Yield ~block_bytes 'N'-joined base blobs streamed from FASTA/FASTQ
    files (no whole-file residency; an N separator resets the rolling window
    so no k-mer spans two reads, kmer.rs:272-274)."""
    from .fastx import read_fastx

    batch: list = []
    n = 0
    for path in paths:
        for _, seq in read_fastx(path):
            batch.append(seq)
            n += len(seq) + 1
            if n >= block_bytes:
                yield b"N".join(batch)
                batch, n = [], 0
    if batch:
        yield b"N".join(batch)


class _RestartRound(Exception):
    pass


def count_kmers_stream(paths, ksize: int, mem_mb: int = 4096,
                       rounds: int = 0, block_mb: int = 64,
                       log=None):
    """Bounded-memory k-mer counting over read FILES (VERDICT r4 item 8; the
    reference delegates this to yak's streaming counter, kmer.rs:132-170
    ethos). Yields (bin, entries u64) in ascending bin order for
    write_yak_bins.

    Strategy: stream blocks, reduce each to (ident, count), merge into a
    sorted per-round accumulator. A round covers a contiguous PRE-bin range;
    when the accumulator would exceed the memory budget the pass restarts
    with twice the rounds (re-reading input; geometric, so total I/O stays
    < 2x the final pass count). Identity/conflation semantics match
    count_kmers exactly.
    """
    kmask = (1 << (2 * ksize)) - 1
    budget = mem_mb << 20
    n_rounds = max(1, rounds)
    nbins = 1 << 10
    while True:
        try:
            for r in range(n_rounds):
                b_lo = nbins * r // n_rounds
                b_hi = nbins * (r + 1) // n_rounds
                chunks: list = []       # [(ident sorted, cnt)] pending merge
                chunk_entries = 0
                acc = (np.zeros(0, _U64), np.zeros(0, np.int64))

                def merge(acc, chunks):
                    idents = np.concatenate([acc[0]] + [c[0] for c in chunks])
                    cnts = np.concatenate([acc[1]] + [c[1] for c in chunks])
                    order = np.argsort(idents, kind="stable")
                    idents = idents[order]
                    cnts = cnts[order]
                    uniq, start = np.unique(idents, return_index=True)
                    summed = np.add.reduceat(cnts, start) if len(cnts) \
                        else cnts
                    return uniq, summed

                for blob in _blocks_from_paths(paths, block_mb << 20):
                    km = seq_kmers(blob, ksize)
                    if not len(km):
                        continue
                    hashes = yak_hash64(km, kmask) if ksize < 32 else km
                    del km
                    bins = hashes & _U64(nbins - 1)
                    if n_rounds > 1:
                        hashes = hashes[(bins >= b_lo) & (bins < b_hi)]
                    ident = ((hashes >> _U64(YAK_COUNTER_BITS))
                             << _U64(YAK_COUNTER_BITS)) | (
                        hashes & _U64(nbins - 1))
                    del hashes, bins
                    u, c = np.unique(ident, return_counts=True)
                    del ident
                    chunks.append((u, c))
                    chunk_entries += len(u)
                    if (chunk_entries + len(acc[0])) * 16 > budget // 2:
                        acc = merge(acc, chunks)
                        chunks, chunk_entries = [], 0
                        if len(acc[0]) * 16 > budget:
                            raise _RestartRound()
                if chunks:
                    acc = merge(acc, chunks)
                # emit per bin, ascending: sort by (bin, ident)
                uniq, cnt = acc
                bins = (uniq & _U64(nbins - 1)).astype(np.int64)
                order = np.argsort(bins, kind="stable")
                bins_sorted = bins[order]
                entries = ((uniq >> _U64(YAK_COUNTER_BITS))
                           << _U64(YAK_COUNTER_BITS)) | np.minimum(
                    cnt, YAK_MAX_COUNT).astype(_U64)
                entries = entries[order]
                bounds = np.searchsorted(bins_sorted, np.arange(b_lo, b_hi + 1))
                for b in range(b_lo, b_hi):
                    yield b, entries[bounds[b - b_lo] : bounds[b - b_lo + 1]]
            return
        except _RestartRound:
            n_rounds *= 2
            if n_rounds > nbins:
                raise MemoryError(
                    f"count_kmers_stream: budget {mem_mb} MB too small even "
                    f"at {nbins} rounds")
            if log:
                log(f"accumulator over {mem_mb} MB budget; restarting with "
                    f"{n_rounds} rounds")


def write_yak_bins(path: str, ksize: int, bin_entries, pre: int = 10) -> None:
    """Write a .yak dump from an ascending (bin, entries u64) iterator —
    the streaming counterpart of write_yak (constant memory)."""
    with open(path, "wb") as f:
        f.write(YAK_MAGIC)
        f.write(struct.pack("<3I", ksize, pre, YAK_COUNTER_BITS))
        expect = 0
        for b, seg in bin_entries:
            assert b == expect, f"bins must ascend densely: got {b}, want {expect}"
            expect += 1
            f.write(struct.pack("<2I", len(seg), len(seg)))
            np.asarray(seg, dtype="<u8").tofile(f)
        assert expect == 1 << pre, f"missing bins: wrote {expect}/{1 << pre}"
