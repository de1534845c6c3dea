"""HiFi read aligner: reads + assembly -> coordinate-sorted BAM.

Usage: python -m nextpolish2_tpu_torch.tools.align asm.fa[.gz] \\
           hifi.fa[.gz] out.bam [-k SEED_K]
Data-prep equivalent of `minimap2 -ax map-hifi | samtools sort` (reference
README.md:55-77, test/hh.sh:8-9), on the host (pipeline/hifi_align.py).
"""

from __future__ import annotations

import argparse
import sys

from ..io.fastx import read_fastx
from ..pipeline.hifi_align import align_to_bam


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("fa", help="assembly FASTA[.gz]")
    p.add_argument("reads", help="HiFi reads FASTA/FASTQ[.gz]")
    p.add_argument("out", help="output BAM path")
    p.add_argument("-k", type=int, default=15, help="seed k-mer size")
    a = p.parse_args(argv)
    targets = list(read_fastx(a.fa))
    reads = list(read_fastx(a.reads))
    n = align_to_bam(targets, reads, a.out, k=a.k)
    print(f"mapped {n}/{len(reads)} reads -> {a.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
