"""Carry the polisher's state across packages.

The polisher has no weights: the state two implementations must share is
the configuration and the loaded yak k-mer tables. carry_state rebuilds both
in this package from plain values and numpy arrays, so a table loaded once
by any loader can drive this package from the same state;
carry_sharded_table does the same for a table already split into the
shards of a mesh's 'kmer' axis.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from .config import PolishConfig
from .io.yak import KmerTable


def carry_state(cfg_fields: dict, tables: List[Dict[str, np.ndarray]]
                ) -> Tuple[PolishConfig, List[KmerTable]]:
    """cfg_fields: PolishConfig field values; tables: one dict per yak table
    with ksize, pre, bin_off, keys and counts."""
    cfg = PolishConfig(**cfg_fields)
    return cfg, [KmerTable.from_arrays(t["ksize"], t["pre"], t["bin_off"],
                                       t["keys"], t["counts"])
                 for t in tables]


def carry_sharded_table(tab) -> "ShardedKmerTable":
    """A k-mer-sharded table from another package's build (ksize, n_shards,
    shard_size and the stacked planes key_hi, key_lo, counts
    [n_shards, shard_size], as numpy arrays): the same shards as this
    package's ShardedKmerTable, in its slot-entry layout. Its lookups probe
    up to MAX_PROBES (the other build keeps no probe bound), which gives the
    same counts."""
    from .parallel.sharded_kmer import ShardedKmerTable

    planes = [np.asarray(p, dtype=np.int32)
              for p in (tab.key_hi, tab.key_lo, tab.counts)]
    entries = np.zeros(planes[0].shape + (4,), dtype=np.int32)
    for i, p in enumerate(planes):
        entries[..., i] = p
    return ShardedKmerTable(ksize=int(tab.ksize), n_shards=int(tab.n_shards),
                            shard_size=int(tab.shard_size), entries=entries)
