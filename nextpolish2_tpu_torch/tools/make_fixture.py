"""Synthetic polishing fixture generator: truth genome -> erroneous assembly,
simulated HiFi reads, coordinate-sorted BAM (the port's own aligner,
pipeline/hifi_align.py) and a yak table. All on the host.

Produces the same artifact set as the bundled testdata/ecoli.* fixture but
for arbitrary contig counts/sizes — used to validate and bench the
cross-contig batcher on many-small-contig assemblies (the reference balances
those with its contig worker pool, main.rs:1717-1843; the port packs windows
across contigs into full device chunks, pipeline/batcher.py). The same
arguments and seed give the same files, byte for byte, as the repository's
tools/make_fixture.py.

Usage:
  python -m nextpolish2_tpu_torch.tools.make_fixture OUTDIR/PREFIX
      [--contigs 20] [--size 200000] [--cov 30] [--errors-per-contig 20]
      [--read-len 12000] [--seed 7] [-k 21] [--het-rate RATE]

Writes PREFIX.truth.fa, PREFIX.fa (assembly with injected errors),
PREFIX.bam, PREFIX.k21.yak (and PREFIX.het.tsv with --het-rate).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ..io.yak import count_kmers, write_yak
from ..pipeline.hifi_align import align_to_bam


def rand_seq(rng, n: int) -> bytes:
    return bytes(rng.choice(list(b"ACGT"), size=n).astype(np.uint8))


def inject_errors(rng, seq: bytes, n_errors: int):
    """Random sub/ins/del errors, uniformly placed (min 100 bp apart)."""
    s = bytearray(seq)
    pos = np.sort(rng.choice(np.arange(200, len(s) - 200, 100),
                             size=min(n_errors, (len(s) - 400) // 100),
                             replace=False))[::-1]
    bases = b"ACGT"
    for p in pos.tolist():
        kind = int(rng.integers(3))
        if kind == 0:  # substitution
            old = s[p]
            s[p] = next(b for b in bases if b != old)
        elif kind == 1:  # insertion into the assembly
            s[p:p] = bytes([bases[int(rng.integers(4))]])
        else:  # deletion from the assembly
            del s[p]
    return bytes(s), len(pos)


def sim_reads(rng, truth: bytes, cov: float, read_len: int, err: float = 0.001):
    """HiFi-like reads from the truth strand with rare random errors."""
    reads = []
    n_reads = max(2, int(len(truth) * cov / read_len))
    # starts may be negative (clipped to 0) so contig heads get full coverage
    lo = -(read_len - 2000)
    starts = rng.integers(lo, max(lo + 1, len(truth) - 2000), size=n_reads)
    bases = b"ACGT"
    for i, st in enumerate(np.sort(starts).tolist()):
        r = bytearray(truth[max(0, st):st + read_len])
        if len(r) < 1500:
            continue
        n_err = rng.poisson(err * len(r))
        for p in rng.integers(0, len(r), size=n_err).tolist():
            r[p] = bases[int(rng.integers(4))]
        reads.append((f"sim{i}_{st}", bytes(r)))
    return reads


def make_hap2(rng, hap1: bytes, het_rate: float):
    """Second haplotype: het SNPs at ~1/het_rate bp spacing. Returns
    (hap2, het positions, hap2 alleles)."""
    s = bytearray(hap1)
    n_het = max(1, int(len(s) * het_rate))
    pos = np.sort(rng.choice(np.arange(300, len(s) - 300, 50),
                             size=min(n_het, (len(s) - 600) // 50),
                             replace=False))
    bases = b"ACGT"
    alleles = []
    for p in pos.tolist():
        old = s[p]
        new = next(b for b in bases if b != old)
        s[p] = new
        alleles.append(new)
    return bytes(s), pos, alleles


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("prefix", help="output path prefix")
    p.add_argument("--contigs", type=int, default=20)
    p.add_argument("--size", type=int, default=200_000)
    p.add_argument("--cov", type=float, default=30.0)
    p.add_argument("--errors-per-contig", type=int, default=20)
    p.add_argument("--read-len", type=int, default=12_000)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("-k", type=int, default=21, help="yak k-mer size")
    p.add_argument("--het-rate", type=float, default=0.0,
                   help="diploid mode: het SNPs per bp on haplotype 2 (e.g. "
                        "0.001); reads are drawn 50/50 from both haplotypes, "
                        "the assembly (and .truth.fa) stays haplotype 1, and "
                        ".het.tsv records the het sites for switch-error "
                        "evaluation (BASELINE 'S. cerevisiae diploid' config)")
    a = p.parse_args(argv)

    rng = np.random.default_rng(a.seed)
    os.makedirs(os.path.dirname(os.path.abspath(a.prefix)), exist_ok=True)

    truths, asms, all_reads = [], [], []
    het_rows = []
    total_err = 0
    for c in range(a.contigs):
        size = int(a.size * (0.5 + rng.random()))  # vary contig sizes
        t = rand_seq(rng, size)
        asm, n_err = inject_errors(rng, t, a.errors_per_contig)
        total_err += n_err
        name = f"ctg{c:03d}"
        truths.append((name, t))
        asms.append((name, asm))
        if a.het_rate > 0:
            hap2, hpos, halle = make_hap2(rng, t, a.het_rate)
            for hp, hb in zip(hpos.tolist(), halle):
                het_rows.append((name, hp, chr(t[hp]), chr(hb)))
            # half coverage from each haplotype
            all_reads.extend((f"{name}_h1_{qn}", r)
                             for qn, r in sim_reads(rng, t, a.cov / 2,
                                                    a.read_len))
            all_reads.extend((f"{name}_h2_{qn}", r)
                             for qn, r in sim_reads(rng, hap2, a.cov / 2,
                                                    a.read_len))
        else:
            all_reads.extend((f"{name}_{qn}", r)
                             for qn, r in sim_reads(rng, t, a.cov, a.read_len))

    def write_fa(path, recs):
        with open(path, "wb") as f:
            for n, s in recs:
                f.write(b">" + n.encode() + b"\n" + s + b"\n")

    write_fa(a.prefix + ".truth.fa", truths)
    write_fa(a.prefix + ".fa", asms)
    print(f"{a.contigs} contigs, {sum(len(s) for _, s in asms)} bp, "
          f"{total_err} injected errors, {len(all_reads)} reads",
          file=sys.stderr, flush=True)

    n = align_to_bam(asms, all_reads, a.prefix + ".bam")
    print(f"mapped {n}/{len(all_reads)} reads -> {a.prefix}.bam",
          file=sys.stderr, flush=True)

    if het_rows:
        with open(a.prefix + ".het.tsv", "w") as f:
            for name, hp, a1, a2 in het_rows:
                f.write(f"{name}\t{hp}\t{a1}\t{a2}\n")
        print(f"{len(het_rows)} het sites -> {a.prefix}.het.tsv",
              file=sys.stderr)

    # k-mer table from the simulated reads (stands in for short-read data)
    h, c = count_kmers([r for _, r in all_reads], a.k)
    write_yak(a.prefix + f".k{a.k}.yak", a.k, h, c)
    print(f"yak: {len(h)} distinct {a.k}-mers", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
