"""yak-equivalent k-mer counter: FASTQ/FASTA -> .yak dump.

Usage: python -m nextpolish2_tpu_torch.tools.kmer_count -k 21 [-k 31 ...] \\
           -o PREFIX reads1.fq.gz [reads2.fq.gz ...]
Writes PREFIX.k{K}.yak per requested K (data-prep; reference README.md:74-77
uses the external `yak count`), on the host.
"""

from __future__ import annotations

import argparse
import sys

from ..io.yak import count_kmers_stream, write_yak_bins


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-k", type=int, action="append", required=True,
                   help="k-mer size (repeatable)")
    p.add_argument("-o", required=True, help="output prefix")
    p.add_argument("--mem-mb", type=int, default=4096,
                   help="accumulator memory budget; read sets whose distinct "
                        "k-mers exceed it are counted in multiple input "
                        "passes over PRE-bin ranges (yak's streaming ethos, "
                        "kmer.rs:132-170)")
    p.add_argument("--rounds", type=int, default=0,
                   help="force the input-pass count (0 = adaptive)")
    p.add_argument("reads", nargs="+", help="FASTA/FASTQ[.gz] read files")
    a = p.parse_args(argv)
    for k in a.k:
        out = f"{a.o}.k{k}.yak"
        n = 0

        def count_bins():
            nonlocal n
            for b, seg in count_kmers_stream(
                    a.reads, k, mem_mb=a.mem_mb, rounds=a.rounds,
                    log=lambda m: print(f"[kmer_count] {m}", file=sys.stderr)):
                n += len(seg)
                yield b, seg

        write_yak_bins(out, k, count_bins())
        print(f"{out}: {n:,} distinct {k}-mers", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
