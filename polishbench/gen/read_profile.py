"""Measure a HiFi read-error profile, and the het SNP density, from a
sorted BAM of real reads against their assembly; prints the
`read_errors` object that a traffic file gives the generator.

    python3 polishbench/gen/read_profile.py READS.bam

Works from the reads alone (no assembly sequence is needed): a column of
the pileup is one assembly position with 20 reads or more. A read's
substitution, insertion or deletion counts as a read error where fewer
than 30% of the reads at that column share the event; columns where 70%
or more agree on the majority base and no second base reaches 25% give
the substitution rate's bases. A het SNP column has a second base in 25%
of its reads or more. Rates are events per aligned read base. An indel is
in homopolymer context where its bases are all one base and equal a
neighbour of it (for deletions, on the column majority).
"""

from __future__ import annotations

import collections
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
from polishbench.reference.bamio import BamReader  # noqa: E402

CODE = {65: 0, 67: 1, 71: 2, 84: 3}


def profile(path: str) -> dict:
    recs = [r for r in BamReader(path) if not (
        r.is_unmapped or r.is_secondary or r.is_supplementary)]
    n = max(r.reference_end() for r in recs) + 2
    cnt = np.zeros((n, 5), np.int64)  # A C G T, deleted
    ins_at = collections.Counter()
    for r in recs:
        rp = qp = 0
        rp = r.pos
        for op, ln in r.cigar:
            if op in (0, 7, 8):
                for i in range(ln):
                    c = CODE.get(r.seq[qp + i])
                    if c is not None:
                        cnt[rp + i, c] += 1
                rp, qp = rp + ln, qp + ln
            elif op == 1:
                ins_at[rp] += 1
                qp += ln
            elif op == 2:
                cnt[rp:rp + ln, 4] += 1
                rp += ln
            elif op == 4:
                qp += ln
    dep = cnt.sum(1)
    covered = dep >= 20
    top2 = np.sort(cnt[:, :4], 1)[:, -2:]
    het = covered & (top2[:, 0] >= 0.25 * dep) & (cnt[:, 4] < 0.25 * dep)
    clean = covered & (top2[:, 1] >= 0.7 * dep) & ~het
    subs = int((cnt[:, :4].sum(1) - top2[:, 1])[clean].sum())
    bases = int(dep[clean].sum())
    cons = cnt[:, :4].argmax(1)
    lens = {1: collections.Counter(), 2: collections.Counter()}
    hp = {1: 0, 2: 0}
    for r in recs:
        rp, qp = r.pos, 0
        for op, ln in r.cigar:
            if op in (0, 7, 8):
                rp, qp = rp + ln, qp + ln
            elif op == 4:
                qp += ln
            elif op == 1:
                if covered[rp] and ins_at[rp] < 0.3 * dep[rp]:
                    lens[1][ln] += 1
                    s = r.seq[qp:qp + ln]
                    near = {r.seq[qp - 1] if qp else None,
                            r.seq[qp + ln] if qp + ln < len(r.seq) else None}
                    hp[1] += len(set(s)) == 1 and s[0] in near
                qp += ln
            elif op == 2:
                if covered[rp] and cnt[rp, 4] < 0.3 * dep[rp]:
                    lens[2][ln] += 1
                    run = cons[rp:rp + ln]
                    hp[2] += bool((run == run[0]).all() and (
                        cons[rp - 1] == run[0] or cons[rp + ln] == run[0]))
                rp += ln
    n_ins, n_del = sum(lens[1].values()), sum(lens[2].values())
    return {
        "sub": subs / bases, "ins": n_ins / bases, "del": n_del / bases,
        "ins_hp": hp[1] / n_ins, "del_hp": hp[2] / n_del,
        "ins_len": sorted([k, v] for k, v in lens[1].items()),
        "del_len": sorted([k, v] for k, v in lens[2].items()),
        "measured": {"reads": len(recs), "columns": int(covered.sum()),
                     "mean_depth": float(dep[covered].mean()),
                     "read_bases": bases, "het_snp_columns": int(het.sum()),
                     "het_snp_per_kb": 1000 * int(het.sum())
                     / int(covered.sum())},
    }


if __name__ == "__main__":
    print(json.dumps(profile(sys.argv[1])))
