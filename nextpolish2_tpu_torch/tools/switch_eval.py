"""Switch-error evaluation for diploid fixtures (BASELINE 'S. cerevisiae
diploid' config; the reference evaluates this with `yak trioeval`,
doc/benchmark1.md:80-89).

For each het site (PREFIX.het.tsv from make_fixture --het-rate), build the
41 bp haplotype-1 and haplotype-2 contexts from the truth and test which one
occurs in the polished output — indel-robust, no coordinate mapping needed.
Reports hap1 (kept, correct: the assembly was haplotype 1), hap2 (switch
error), neither (lost site).

Usage: python -m nextpolish2_tpu_torch.tools.switch_eval polished.fa \\
           truth.fa het.tsv
"""

from __future__ import annotations

import sys

from ..io.fastx import read_fastx


def main(argv=None) -> int:
    argv = argv or sys.argv[1:]
    if len(argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    polished = dict(read_fastx(argv[0]))
    truth = dict(read_fastx(argv[1]))
    FLANK = 20
    n_h1 = n_h2 = n_lost = 0
    with open(argv[2]) as f:
        for line in f:
            name, pos, a1, a2 = line.split()
            pos = int(pos)
            t = truth[name]
            out = polished[name]
            ctx1 = t[pos - FLANK : pos + FLANK + 1]
            ctx2 = bytearray(ctx1)
            ctx2[FLANK] = ord(a2)
            ctx2 = bytes(ctx2)
            if ctx1[FLANK] != ord(a1):
                raise ValueError(f"het.tsv/truth mismatch: {name} {pos}")
            in1 = ctx1 in out
            in2 = ctx2 in out
            if in1 and not in2:
                n_h1 += 1
            elif in2 and not in1:
                n_h2 += 1
            elif in1 and in2:
                n_h1 += 1  # both present (duplication) — count as kept
            else:
                n_lost += 1
    total = n_h1 + n_h2 + n_lost
    print(f"het sites: {total}  hap1 kept: {n_h1}  "
          f"switch errors (hap2): {n_h2}  lost: {n_lost}  "
          f"switch rate: {n_h2 / max(1, total):.2%}")
    return 1 if n_h2 or n_lost else 0


if __name__ == "__main__":
    raise SystemExit(main())
