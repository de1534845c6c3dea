"""Sharded k-mer table: independent open-addressing shards, one on each
position of a mesh's 'kmer' axis.

Keys go to shards by hash bits ((hash >> 21) % n_shards), so a table too
large for one device (a human short-read table of 2-4 G keys) sits in the
memory of several. A lookup hands every position all the queries; each
position probes its own shard for the queries it owns (the kernel
kmer_lookup_sharded, ops/kmer_table.py, which skips the others) and the
positions' disjoint counts are summed on the first one, the counterpart of
the JAX package's psum (nextpolish2_tpu/parallel/sharded_kmer.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.kmer_table import MAX_PROBES, DeviceKmerTable, kmer_lookup_sharded
from .mesh import Mesh, axis_devices, count_position

SHARD_BITS_SHIFT = 21  # shard id bits: (hash >> 21), away from slot-index bits


@dataclass
class ShardedKmerTable:
    ksize: int
    n_shards: int
    shard_size: int
    # stacked slot entries [n_shards, shard_size, 4] (int32 {key_hi, key_lo,
    # count, 0}); key_hi, key_lo and counts are its column views, the JAX
    # build's stacked planes [n_shards, shard_size] bit for bit
    entries: np.ndarray
    # longest probe chain over the shards: lookups stop there
    n_probes: int = MAX_PROBES

    @property
    def key_hi(self) -> np.ndarray:
        return self.entries[:, :, 0]

    @property
    def key_lo(self) -> np.ndarray:
        return self.entries[:, :, 1]

    @property
    def counts(self) -> np.ndarray:
        return self.entries[:, :, 2]

    @classmethod
    def build(cls, hashes: np.ndarray, counts: np.ndarray, ksize: int,
              n_shards: int) -> "ShardedKmerTable":
        hashes = np.asarray(hashes, dtype=np.uint64)
        counts = np.asarray(counts, dtype=np.int64)
        shard_of = ((hashes >> np.uint64(SHARD_BITS_SHIFT))
                    % np.uint64(n_shards)).astype(np.int64)
        subtables = []
        for s in range(n_shards):
            sel = shard_of == s
            subtables.append(DeviceKmerTable.build(hashes[sel], counts[sel],
                                                   ksize))
        size = max(t.size for t in subtables)
        # rebuild smaller shards at the common size for a rectangular stack
        for i, t in enumerate(subtables):
            if t.size != size:
                sel = shard_of == i
                ok, entries, n_probes = DeviceKmerTable._try_pack(
                    hashes[sel], counts[sel].astype(np.int32), size)
                assert ok
                subtables[i] = DeviceKmerTable._of_entries(entries, ksize,
                                                           n_probes)
        return cls(ksize=ksize, n_shards=n_shards, shard_size=size,
                   entries=np.stack([t.entries for t in subtables]),
                   n_probes=max(t.n_probes for t in subtables))

    def query_host_arrays(self, hashes: np.ndarray):
        """Split u64 query hashes into int32 planes, start slots and the
        owning shard."""
        hashes = np.asarray(hashes, dtype=np.uint64)
        q_hi = (hashes >> np.uint64(32)).astype(np.uint32).view(np.int32)
        q_lo = (hashes & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
        slot = (((hashes >> np.uint64(10)) ^ (hashes << np.uint64(7)))
                & np.uint64(self.shard_size - 1)).astype(np.int32)
        shard = ((hashes >> np.uint64(SHARD_BITS_SHIFT))
                 % np.uint64(self.n_shards)).astype(np.int32)
        return q_hi, q_lo, slot, shard

    def put(self, mesh: Mesh, axis: str = "kmer") -> tuple:
        """Each shard's entries on the device of its position along `axis`
        (one int32 [S, 4] tensor a shard): the planes (key_hi, key_lo,
        counts), one list each, that a make_sharded_lookup function takes."""
        devs = axis_devices(mesh, axis)
        if len(devs) != self.n_shards:
            raise ValueError(f"{self.n_shards} shards for {len(devs)} "
                             f"positions of the {axis!r} axis")
        ent = [torch.from_numpy(np.ascontiguousarray(e)).to(d)
               for e, d in zip(self.entries, devs)]
        return ([e[:, 0] for e in ent], [e[:, 1] for e in ent],
                [e[:, 2] for e in ent])


def make_sharded_lookup(mesh: Mesh, axis: str = "kmer", min_count: int = 5,
                        n_probes: int = MAX_PROBES):
    """A lookup fn(key_hi, key_lo, counts, q_hi, q_lo, q_slot, q_shard) ->
    int32 [Q] counts on the first position's device.

    key_hi, key_lo, counts: one plane a position of `axis`, on its device
    (ShardedKmerTable.put); queries int32 [Q] on any device. Each position
    launches kmer_lookup_sharded once, on the devices of the first row of
    the other axis (replicas there would compute the same values); the sum
    of the disjoint results is the JAX psum."""
    devs = axis_devices(mesh, axis)

    def fn(key_hi, key_lo, counts, q_hi, q_lo, q_slot, q_shard):
        if not len(key_hi) == len(key_lo) == len(counts) == len(devs):
            raise ValueError(f"planes of {len(key_hi)} shards for "
                             f"{len(devs)} positions of the {axis!r} axis")
        out = None
        for s, dev in enumerate(devs):
            q = [t.to(dev) for t in (q_hi, q_lo, q_slot, q_shard)]
            part = kmer_lookup_sharded(key_hi[s], key_lo[s], counts[s], *q, s,
                                       min_count, n_probes)
            count_position(axis, s)
            part = part.to(devs[0])
            out = part if out is None else out + part
        return out

    return fn
