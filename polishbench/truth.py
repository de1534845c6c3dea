"""A witness independent of both polishers: the polished contigs against
the truth the generator drew (`truth.fa`, and haplotype 2 from `het.tsv`
where the traffic is diploid).

truth_kmers_missing: distinct canonical k-mers of the polished contigs that
no truth haplotype of that contig holds. A base left wrong adds up to k of
them; a contig polished to its truth reads 0. Passthrough contigs are left
out: they are written unpolished.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, Iterable

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "gen"))
from seqio import canonical_kmers  # noqa: E402

K = 21


def read_truth(d: str) -> Dict[str, list]:
    """name -> [truth bases, haplotype 2 bases (diploid only)]."""
    out: Dict[str, list] = {}
    with open(os.path.join(d, "truth.fa"), "rb") as f:
        lines = f.read().split(b"\n")
    for i in range(0, len(lines) - 1, 2):
        out[lines[i][1:].decode()] = [lines[i + 1]]
    het = os.path.join(d, "het.tsv")
    if os.path.exists(het):
        alts: Dict[str, list] = {}
        with open(het) as f:
            for row in f:
                name, pos, _, alt = row.split("\t")
                alts.setdefault(name, []).append((int(pos), alt.strip()))
        for name, sites in alts.items():
            hap2 = bytearray(out[name][0])
            for p, a in sites:
                hap2[p] = ord(a)
            out[name].append(bytes(hap2))
    return out


def kmers_missing(polished: Dict[str, bytes], truth: Dict[str, list],
                  names: Iterable[str], k: int = K) -> int:
    """Distinct k-mers of polished[name] absent from every haplotype of
    truth[name], summed over `names`."""
    missing = 0
    for n in names:
        got = np.unique(canonical_kmers(polished.get(n, b""), k))
        have = np.unique(np.concatenate(
            [canonical_kmers(h, k) for h in truth[n]]))
        missing += int(len(got) - np.count_nonzero(np.isin(
            got, have, assume_unique=True)))
    return missing
