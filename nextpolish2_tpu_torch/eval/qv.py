"""Merqury-style QV estimation from short-read k-mer tables.

The reference validates externally with merqury/yak (doc/benchmark1.md:80-89);
this makes the same estimate a built-in: an assembly k-mer absent from the
short-read set marks an error; per-base error rate E = 1 - (1 - M/T)^(1/k)
(M = missing assembly k-mers, T = total), QV = -10 log10(E).

Each contig's k-mers go to KmerTable.get in one batch. A table marked for a
device (use_device, device; tools/qv.py marks it) sends a batch of
NP2_KMER_DEVICE_MIN queries or more to its device-resident copy and the
kmer_lookup kernel: a bacterial contig is one launch of millions of queries.
Every route gives the same counts, so the same result.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from ..io.yak import KmerTable, seq_kmers


@dataclass
class QvResult:
    total_kmers: int
    missing_kmers: int
    error_rate: float
    qv: float

    def __str__(self) -> str:
        return (f"kmers={self.total_kmers} missing={self.missing_kmers} "
                f"err={self.error_rate:.3e} QV={self.qv:.2f}")


def estimate_qv(seqs: list[bytes], table: KmerTable, min_count: int = 5,
                qv_cap: float = 99.0) -> QvResult:
    k = table.ksize
    total = 0
    missing = 0
    for seq in seqs:
        km = seq_kmers(seq, k)
        if not len(km):
            continue
        counts = table.get(table.to_hash(km), min_count)
        total += len(km)
        missing += int((counts == 0).sum())
    if total == 0:
        return QvResult(0, 0, 0.0, float(qv_cap))
    if missing == 0:
        return QvResult(total, 0, 0.0, float(qv_cap))
    err = 1.0 - (1.0 - missing / total) ** (1.0 / k)
    qv = min(qv_cap, -10.0 * math.log10(err))
    return QvResult(total, missing, err, qv)
