"""Emit assembly regions with read depth >= threshold as FASTA.

Equivalent of the reference utility other/remove_low_depth_in_fasta.py (pysam
depth filter) built on this package's own BAM reader.

Usage: python -m nextpolish2_tpu_torch.tools.remove_low_depth \\
           genome.fa[.gz] sorted.bam [-d MIN_DEPTH] [-l MIN_LEN]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..io.bam import BamReader
from ..io.fastx import read_fastx


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("fa")
    p.add_argument("bam")
    p.add_argument("-d", "--min_depth", type=int, default=3)
    p.add_argument("-l", "--min_len", type=int, default=1000)
    a = p.parse_args(argv)

    reader = BamReader(a.bam)
    names = {n: i for i, (n, _) in enumerate(reader.references)}
    lens = {i: l for i, (_, l) in enumerate(reader.references)}
    depth = {}
    for tid, recs in reader.by_contig():
        d = np.zeros(lens[tid] + 1, dtype=np.int32)
        for r in recs:
            if r.flag & 0x904:  # unmapped/secondary/supplementary excluded
                continue
            d[r.pos] += 1
            d[min(r.reference_end(), lens[tid])] -= 1
        depth[tid] = np.cumsum(d[:-1])

    out = sys.stdout.buffer
    for name, seq in read_fastx(a.fa):
        tid = names.get(name)
        d = depth.get(tid)
        if d is None:
            continue
        ok = d >= a.min_depth
        # contiguous runs
        edges = np.flatnonzero(np.diff(np.concatenate([[0], ok.view(np.int8), [0]])))
        for s, e in zip(edges[0::2], edges[1::2]):
            if e - s >= a.min_len:
                out.write(f">{name}:{s}-{e}\n".encode())
                out.write(seq[s:e] + b"\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
