"""Device-resident k-mer count table: open addressing on the card, batched
lookups.

Each yak table (io/yak.py) is packed ONCE into a power-of-two
open-addressing table of 16-byte slot entries, an int32 [S, 4] tensor
{key_hi = hash >> 32, key_lo = hash & 0xFFFFFFFF bit-cast, count, 0}, so
that a probe on the card reads key and count from one 32 B sector. Its
first three columns, the views key_hi, key_lo and counts, are the JAX
package's three planes (ops/kmer_table.py), bit for bit its build.
DeviceKmerTable.build is the numpy build, copied; build_torch is the same
cascade in torch ops, so that a table bound for the card is packed there.

kmer_lookup replaces the jitted XLA function lookup / lookup_jit
(nextpolish2_tpu/ops/kmer_table.py:120-154). For CUDA tensors it launches
the hand-written kernel csrc/kmer_lookup.cu (one 16-byte load a probe,
several chains a thread in flight, stopping at the hit or the first empty
slot, which is exact: csrc/kmer_common.cuh); for CPU tensors it runs the
plain twin kmer_lookup_plain. It never falls back, and every launch adds
one to consensus_cuda.LAUNCHES["kmer_lookup"].

kmer_lookup_sharded is one 'kmer' position's part of the sharded lookup
that replaces the jitted XLA make_sharded_lookup
(nextpolish2_tpu/parallel/sharded_kmer.py:84-106; the mesh side is
parallel/sharded_kmer.py): the same walk on one shard's entries for the
queries that shard owns, 0 for the others, which are not probed. Its plain
twin is kmer_lookup_sharded_plain; its launches count under
"kmer_lookup_sharded".
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Union

import numpy as np
import torch

from ..utils.torchcfg import bucket_pow2
from .consensus_cuda import _check, _count, _fn, _launch

MAX_PROBES = 32
# Probe scheme: DOUBLE HASHING -- probe i lands at (slot + i*stride) & mask
# with stride = ((hash >> 10) | 1) & mask (odd, so the cycle covers every
# slot of the power-of-two table); the longest chain is ~log2(n) at load
# 0.5. The stride is derived from the query planes inside the lookup, so
# call sites ship only (hi, lo, slot).
# Empty sentinel = hash 0xFFFFFFFF_FFFFFFFE. For k < 32 real hashes are
# < 2^(2k) and can never collide; for k >= 32 a collision has probability
# 2^-64 per key.
EMPTY_HI = np.int32(-1)          # 0xFFFFFFFF
EMPTY_LO = np.int32(-2)          # 0xFFFFFFFE
# the kernels take the slot mask as a 32-bit int and start slots as int32
MAX_SLOTS = 1 << 31
# build_torch's device peak: per slot, the 16-byte entry and a byte of
# occupancy; per key, the int64 hashes, slots, order, pending keys, slots
# and strides and the int32 counts it keeps, and one placement round's
# temporaries (sorts included); chip_smoke.py measures it (PERF.md)
BUILD_BYTES_PER_SLOT = 17
BUILD_BYTES_PER_KEY = 192

Planes = Union[np.ndarray, torch.Tensor]


@dataclass
class DeviceKmerTable:
    """A packed table: numpy (build) or torch on the device it was packed
    on (build_torch). key_hi, key_lo and counts are columns 0-2 of
    `entries`."""

    ksize: int
    size: int            # power of two
    key_hi: Planes       # i32 [size]  (hash >> 32)
    key_lo: Planes       # i32 [size]  (hash & 0xFFFFFFFF, bit-cast)
    counts: Planes       # i32 [size]
    kmask: int
    # longest probe chain used at build time: lookups stop there (probes
    # past it can never hit)
    n_probes: int = MAX_PROBES
    entries: Planes = None  # i32 [size, 4]: {key_hi, key_lo, count, 0}

    @staticmethod
    def _first_size(n: int, load_factor: float) -> int:
        return 1 << max(10, int(np.ceil(np.log2(max(n, 1) / load_factor))))

    @staticmethod
    def _kmask(ksize: int) -> int:
        return (1 << (2 * ksize)) - 1 if ksize < 32 else (1 << 64) - 1

    @classmethod
    def device_bytes(cls, n_keys: int,
                     load_factor: float = 0.5) -> tuple[int, int]:
        """(slots, peak device bytes) of build_torch on n_keys keys, at the
        first size it tries."""
        size = cls._first_size(n_keys, load_factor)
        return size, (BUILD_BYTES_PER_SLOT * size
                      + BUILD_BYTES_PER_KEY * n_keys)

    @classmethod
    def build(cls, hashes: np.ndarray, counts: np.ndarray, ksize: int,
              load_factor: float = 0.5) -> "DeviceKmerTable":
        """Pack (hash, count) pairs; grows until every key probes <= MAX_PROBES."""
        hashes = np.asarray(hashes, dtype=np.uint64)
        counts = np.asarray(counts, dtype=np.int32)
        size = cls._first_size(len(hashes), load_factor)
        while True:
            ok, entries, n_probes = cls._try_pack(hashes, counts, size)
            if ok:
                break
            size *= 2
        return cls._of_entries(entries, ksize, n_probes)

    @classmethod
    def _of_entries(cls, entries, ksize: int, n_probes: int):
        return cls(ksize=ksize, size=entries.shape[0], key_hi=entries[:, 0],
                   key_lo=entries[:, 1], counts=entries[:, 2],
                   kmask=cls._kmask(ksize), n_probes=n_probes,
                   entries=entries)

    @staticmethod
    def _try_pack(hashes, counts, size):
        mask = np.uint64(size - 1)
        entries = np.zeros((size, 4), dtype=np.int32)
        entries[:, 0] = EMPTY_HI
        entries[:, 1] = EMPTY_LO
        hi, lo, cnt = entries[:, 0], entries[:, 1], entries[:, 2]
        # mix so slot bits differ from the yak prefix-bin bits
        slot = ((hashes >> np.uint64(10)) ^ (hashes << np.uint64(7))) & mask
        order = np.argsort(slot, kind="stable")
        occupied = np.zeros(size, dtype=bool)
        pending = hashes[order]
        pcnts = counts[order]
        pslots = slot[order].astype(np.int64)
        # double-hashing stride (see MAX_PROBES comment); odd -> full cycle
        pstride = (((hashes[order] >> np.uint64(10)) | np.uint64(1))
                   & mask).astype(np.int64)
        # vectorized cascade: place keys; collisions retry at +stride
        for probe in range(MAX_PROBES):
            if len(pending) == 0:
                return True, entries, probe
            s = (pslots + probe * pstride) & (size - 1)
            # first pending key per free slot wins this round
            free = ~occupied[s]
            idx_sorted = np.argsort(s[free], kind="stable")
            sf = s[free][idx_sorted]
            first = np.ones(len(sf), dtype=bool)
            first[1:] = sf[1:] != sf[:-1]
            winners_local = np.nonzero(free)[0][idx_sorted[first]]
            win_slots = s[winners_local]
            occupied[win_slots] = True
            h = pending[winners_local]
            hi[win_slots] = (h >> np.uint64(32)).astype(np.uint32).view(np.int32)
            lo[win_slots] = (h & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
            cnt[win_slots] = pcnts[winners_local]
            keep = np.ones(len(pending), dtype=bool)
            keep[winners_local] = False
            pending, pcnts = pending[keep], pcnts[keep]
            pslots, pstride = pslots[keep], pstride[keep]
        return len(pending) == 0, entries, MAX_PROBES

    @classmethod
    def build_torch(cls, hashes: np.ndarray, counts: np.ndarray, ksize: int,
                    device, load_factor: float = 0.5) -> "DeviceKmerTable":
        """build, as torch ops on `device`: the same cascade, so the same
        entries bit for bit (a stable sort is one permutation in numpy and
        in torch), left on the device. The entries are written in place
        through their column views, so no plane is packed afterwards."""
        h = torch.from_numpy(np.ascontiguousarray(
            hashes, dtype=np.uint64).view(np.int64)).to(device)
        c = torch.from_numpy(np.ascontiguousarray(counts, dtype=np.int32)) \
            .to(device)
        size = cls._first_size(len(hashes), load_factor)
        while True:
            ok, entries, n_probes = cls._try_pack_torch(h, c, size)
            if ok:
                break
            del entries  # freed before the next size is allocated
            size *= 2
        return cls._of_entries(entries, ksize, n_probes)

    @staticmethod
    def _try_pack_torch(h: torch.Tensor, counts: torch.Tensor, size: int):
        """_try_pack on int64 bit patterns of the u64 hashes. Only bits
        below log2(size) <= 62 of each shift survive the mask, so torch's
        arithmetic right shift gives the same slots and strides."""
        dev = h.device
        mask = size - 1
        entries = torch.zeros((size, 4), dtype=torch.int32, device=dev)
        entries[:, 0] = int(EMPTY_HI)
        entries[:, 1] = int(EMPTY_LO)
        hi, lo, cnt = entries[:, 0], entries[:, 1], entries[:, 2]
        slot = ((h >> 10) ^ (h << 7)) & mask
        order = torch.sort(slot, stable=True).indices
        occupied = torch.zeros(size, dtype=torch.bool, device=dev)
        pending = h[order]
        pcnts = counts[order]
        pslots = slot[order]
        pstride = ((pending >> 10) | 1) & mask
        for probe in range(MAX_PROBES):
            if pending.numel() == 0:
                return True, entries, probe
            s = (pslots + probe * pstride) & mask
            free_idx = torch.nonzero(~occupied[s]).squeeze(1)
            sf, idx_sorted = torch.sort(s[free_idx], stable=True)
            first = torch.ones(sf.numel(), dtype=torch.bool, device=dev)
            first[1:] = sf[1:] != sf[:-1]
            winners = free_idx[idx_sorted[first]]
            win_slots = s[winners]
            occupied[win_slots] = True
            w = pending[winners]
            hi[win_slots] = (w >> 32).to(torch.int32)
            lo[win_slots] = _low32(w)
            cnt[win_slots] = pcnts[winners]
            keep = torch.ones(pending.numel(), dtype=torch.bool, device=dev)
            keep[winners] = False
            pending, pcnts = pending[keep], pcnts[keep]
            pslots, pstride = pslots[keep], pstride[keep]
        return pending.numel() == 0, entries, MAX_PROBES

    def query_host_arrays(self, hashes: np.ndarray):
        """Split u64 query hashes into int32 planes + start slots."""
        hashes = np.asarray(hashes, dtype=np.uint64)
        q_hi = (hashes >> np.uint64(32)).astype(np.uint32).view(np.int32)
        q_lo = (hashes & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
        slot = (((hashes >> np.uint64(10)) ^ (hashes << np.uint64(7)))
                & np.uint64(self.size - 1)).astype(np.int32)
        return q_hi, q_lo, slot


def _low32(x: torch.Tensor) -> torch.Tensor:
    """Low 32 bits of int64 values, bit-cast to int32."""
    lo = x & 0xFFFFFFFF
    return torch.where(lo >= 1 << 31, lo - (1 << 32), lo).to(torch.int32)


def probe_plain(key_hi, key_lo, counts, q_hi, q_lo, q_slot, n_probes: int):
    """The probe of the kernels, vectorized: (count int32 [Q], 0 where
    absent; probes int64 [Q], the slots each query reads before its hit or
    the first empty slot)."""
    size = key_hi.shape[0]
    mask = size - 1
    qh = q_hi.long() & 0xFFFFFFFF
    ql = q_lo.long() & 0xFFFFFFFF
    # double-hashing stride from the query planes: low 32 bits of
    # (hash >> 10), forced odd
    stride = (((ql >> 10) | (qh << 22)) | 1) & mask
    slot = q_slot.long()
    out = torch.zeros(q_hi.shape, dtype=torch.int32, device=q_hi.device)
    probes = torch.zeros(q_hi.shape, dtype=torch.int64, device=q_hi.device)
    live = torch.ones(q_hi.shape, dtype=torch.bool, device=q_hi.device)
    for p in range(n_probes):
        idx = (slot + p * stride) & mask
        khi, klo = key_hi[idx], key_lo[idx]
        hit = live & (khi == q_hi) & (klo == q_lo)
        out = torch.where(hit, counts[idx], out)
        probes += live
        live = live & ~hit & ~((khi == int(EMPTY_HI)) & (klo == int(EMPTY_LO)))
        if not bool(live.any()):
            break
    return out, probes


def kmer_lookup_plain(key_hi, key_lo, counts, q_hi, q_lo, q_slot,
                      min_count: int, n_probes: int = MAX_PROBES):
    """Plain twin of the kmer_lookup kernel."""
    _count("kmer_lookup_plain")
    out, _ = probe_plain(key_hi, key_lo, counts, q_hi, q_lo, q_slot, n_probes)
    return torch.where(out >= min_count, out, 0)


def entries_ptr(name: str, key_hi, key_lo, counts) -> int:
    """Address of the [S, 4] slot entries whose columns 0-2 the three
    planes are (DeviceKmerTable's layout); raises where they are not."""
    p = key_hi.data_ptr()
    if (key_hi.dtype != torch.int32 or key_lo.dtype != torch.int32
            or counts.dtype != torch.int32
            or key_lo.shape != key_hi.shape or counts.shape != key_hi.shape
            or key_hi.stride() != (4,)
            or key_lo.stride() != (4,) or counts.stride() != (4,)
            or key_lo.data_ptr() != p + 4 or counts.data_ptr() != p + 8
            or p % 16):
        raise ValueError(f"{name}: the table planes are not the columns of "
                         "one int32 [S, 4] slot-entry tensor")
    return p


def kmer_lookup_call(key_hi, key_lo, counts, q_hi, q_lo, q_slot,
                     min_count: int, n_probes: int = MAX_PROBES):
    """The checked C call of kmer_lookup on CUDA tensors, not made: (C
    function, its arguments, output tensor)."""
    dev, entries, S, Q = _lookup_args(
        "kmer_lookup", key_hi, key_lo, counts,
        ((q_hi, "q_hi"), (q_lo, "q_lo"), (q_slot, "q_slot")))
    out = torch.empty(Q, dtype=torch.int32, device=dev)
    return (_fn("kmer_lookup"),
            (entries, q_hi.data_ptr(), q_lo.data_ptr(), q_slot.data_ptr(),
             out.data_ptr(), Q, S - 1, int(min_count), int(n_probes),
             torch.cuda.current_stream(dev).cuda_stream), out)


def kmer_lookup_sharded_plain(key_hi, key_lo, counts, q_hi, q_lo, q_slot,
                              q_shard, shard: int, min_count: int,
                              n_probes: int = MAX_PROBES):
    """Plain twin of the kmer_lookup_sharded kernel: kmer_lookup_plain's
    counts where q_shard == shard, 0 elsewhere."""
    _count("kmer_lookup_sharded_plain")
    out, _ = probe_plain(key_hi, key_lo, counts, q_hi, q_lo, q_slot, n_probes)
    out = torch.where(out >= min_count, out, 0)
    return torch.where(q_shard == shard, out, 0)


def _lookup_args(name: str, key_hi, key_lo, counts, queries):
    """Checks shared by the lookup wrappers on CUDA tensors: (device,
    entries address, table size, query count)."""
    dev = key_hi.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    S = key_hi.shape[0]
    if S < 1 or S & (S - 1) or S > MAX_SLOTS:
        raise ValueError(f"{name}: table size {S} is not a power of two")
    entries = entries_ptr(name, key_hi, key_lo, counts)
    Q = queries[0][0].shape[0]
    for t, qname in queries:
        _check(t, qname, torch.int32, (Q,), dev)
    return dev, entries, S, Q


def kmer_lookup_sharded_call(key_hi, key_lo, counts, q_hi, q_lo, q_slot,
                             q_shard, shard: int, min_count: int,
                             n_probes: int = MAX_PROBES):
    """The checked C call of kmer_lookup_sharded on CUDA tensors, not made:
    (C function, its arguments, output tensor)."""
    dev, entries, S, Q = _lookup_args(
        "kmer_lookup_sharded", key_hi, key_lo, counts,
        ((q_hi, "q_hi"), (q_lo, "q_lo"), (q_slot, "q_slot"),
         (q_shard, "q_shard")))
    if int(shard) < 0:
        raise ValueError(f"kmer_lookup_sharded: shard {shard} < 0")
    out = torch.empty(Q, dtype=torch.int32, device=dev)
    return (_fn("kmer_lookup_sharded"),
            (entries, q_hi.data_ptr(), q_lo.data_ptr(), q_slot.data_ptr(),
             q_shard.data_ptr(), out.data_ptr(), Q, S - 1, int(min_count),
             int(n_probes), int(shard),
             torch.cuda.current_stream(dev).cuda_stream), out)


def kmer_lookup_sharded(key_hi, key_lo, counts, q_hi, q_lo, q_slot, q_shard,
                        shard: int, min_count: int,
                        n_probes: int = MAX_PROBES):
    """One shard's part of a sharded lookup: [Q] queries -> [Q] counts of
    the queries whose q_shard (int32 [Q]) is `shard`, 0 for the others (not
    probed). Table planes as for kmer_lookup, of that shard. CPU tensors:
    the plain twin; CUDA tensors: the kernel."""
    if key_hi.device.type == "cpu":
        return kmer_lookup_sharded_plain(key_hi, key_lo, counts, q_hi, q_lo,
                                         q_slot, q_shard, shard, min_count,
                                         n_probes)
    fn, args, out = kmer_lookup_sharded_call(key_hi, key_lo, counts, q_hi,
                                             q_lo, q_slot, q_shard, shard,
                                             min_count, n_probes)
    launch_on(key_hi.device, "kmer_lookup_sharded",
              (bucket_pow2(out.shape[0], 1 << 12),), fn, *args)
    return out


def kmer_lookup(key_hi, key_lo, counts, q_hi, q_lo, q_slot, min_count: int,
                n_probes: int = MAX_PROBES):
    """[Q] queries -> [Q] counts (0 if absent or < min_count). Table planes
    int32 [S] (S a power of two; on the card the columns of a
    DeviceKmerTable's entries), queries int32 [Q] x 3. CPU tensors: the
    plain twin; CUDA tensors: the kernel."""
    if key_hi.device.type == "cpu":
        return kmer_lookup_plain(key_hi, key_lo, counts, q_hi, q_lo, q_slot,
                                 min_count, n_probes)
    fn, args, out = kmer_lookup_call(key_hi, key_lo, counts, q_hi, q_lo,
                                     q_slot, min_count, n_probes)
    launch_on(key_hi.device, "kmer_lookup",
              (bucket_pow2(out.shape[0], 1 << 12),), fn, *args)
    return out


def launch_on(dev, name: str, shape, fn, *args) -> None:
    """_launch with `dev` the current device."""
    with torch.cuda.device(dev):
        _launch(name, shape, fn, *args)
