"""Large-scale polishing fixture generator: direct BAM synthesis, no aligner.

make_fixture aligns every simulated read with the repository's own aligner —
fine at ~1 Mb but O(hours) and memory-hungry at tens of Mb. This tool
scales to 100 Mb+ by *composing* each read's CIGAR analytically from the known
assembly edit list instead of aligning:

  truth contig  --inject edits (known positions)-->  assembly contig
  read = truth[a:b) + substitution-only sequencing errors

Because every assembly edit (sub/ins/del, >=100 bp apart) is known in truth
coordinates, the read-vs-assembly alignment is exact by construction:
  sub             -> M (mismatch column)
  assembly ins    -> D 1 between the flanking truth bases
  assembly del    -> I 1 (the read carries the base the assembly lost)
Boundary dels become soft-clips. POS = assembly coordinate of the first
aligned truth base. Streams one contig at a time (bounded memory).

The yak table is counted from the TRUTH genome with counts scaled to
--kmer-cov (error-free short reads at that coverage would produce the same
table), so candidate-allele scoring behaves exactly like the real pipeline:
truth alleles score ~kmer-cov, error alleles score 0.

Usage:
  python -m nextpolish2_tpu_torch.tools.make_big_fixture OUTDIR/PREFIX
      [--contigs 16] [--size 6000000] [--cov 30] [--err-bp 5000]
      [--read-len 12000] [--small 2] [--small-size 300000] [--seed 11]
      [-k 21] [--kmer-cov 30] [--het-bp BP] [--repeats N]

A copy of the repository's tools/make_big_fixture.py on the port's io/bam
and io/yak: the same arguments and seed give the same files, byte for byte.
The port's chromosome-scale run makes its fixture with it:
  python3 -m nextpolish2_tpu_torch.tools.make_big_fixture /tmp/np2big/chr \\
      --contigs 1 --size 80000000 --small 0 --cov 30 --seed 11

Writes PREFIX.truth.fa, PREFIX.fa, PREFIX.bam, PREFIX.k21.yak.
--small N adds N small contigs (for cheap oracle spot-checks at scale).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from ..io.bam import BamRecord, BamWriter
from ..io.yak import count_kmers, write_yak

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def rand_seq(rng, n: int) -> np.ndarray:
    return BASES[rng.integers(0, 4, size=n)]


def make_edits(rng, n_pos: int, err_bp: int):
    """Random sub/ins/del edit list in truth coordinates, >=100 bp apart and
    >=300 bp from the ends. Returns (pos i64 asc, kind u8, base u8)."""
    n = max(1, (n_pos - 600) // max(err_bp, 100))
    cand = np.arange(300, n_pos - 300, 100)
    pos = np.sort(rng.choice(cand, size=min(n, len(cand)), replace=False))
    kind = rng.integers(0, 3, size=len(pos)).astype(np.uint8)
    base = BASES[rng.integers(0, 4, size=len(pos))]
    return pos.astype(np.int64), kind, base


def apply_edits(truth: np.ndarray, pos, kind, base) -> np.ndarray:
    """Build the assembly from the edit list (the single source of truth for
    coordinate mapping — compose_cigar derives from the same list)."""
    out = []
    t = 0
    for p, k, b in zip(pos.tolist(), kind.tolist(), base.tolist()):
        out.append(truth[t:p])
        if k == 0:  # substitution (force a real change)
            nb = b if b != truth[p] else BASES[(np.searchsorted(BASES, truth[p]) + 1) % 4]
            out.append(np.array([nb], dtype=np.uint8))
            t = p + 1
        elif k == 1:  # insertion into the assembly, before truth[p]
            out.append(np.array([b], dtype=np.uint8))
            t = p
        else:  # deletion from the assembly
            t = p + 1
    out.append(truth[t:])
    return np.concatenate(out)


def asm_coord_fn(pos, kind):
    """truth position -> assembly coordinate (for non-deleted positions):
    q + #ins(p <= q) - #del(p < q)."""
    ins_pos = pos[kind == 1]
    del_pos = pos[kind == 2]

    def f(q: int) -> int:
        return int(q + np.searchsorted(ins_pos, q, "right")
                   - np.searchsorted(del_pos, q, "left"))
    return f


def compose_cigar(a: int, b: int, pos, kind):
    """Exact read-vs-assembly CIGAR for a read covering truth [a, b).
    Returns (cigar ops list, a', head_clip, tail_clip) where a' is the first
    aligned truth base (head/tail deleted-base runs become soft clips)."""
    del_set_lo = pos[kind == 2]
    head = 0
    while np.searchsorted(del_set_lo, a) < len(del_set_lo) and \
            del_set_lo[np.searchsorted(del_set_lo, a)] == a:
        a += 1
        head += 1
    tail = 0
    while b - 1 > a and np.searchsorted(del_set_lo, b - 1) < len(del_set_lo) \
            and del_set_lo[np.searchsorted(del_set_lo, b - 1)] == b - 1:
        b -= 1
        tail += 1
    lo = int(np.searchsorted(pos, a, "left"))
    hi = int(np.searchsorted(pos, b, "left"))
    ops = []
    if head:
        ops.append((4, head))  # S
    cur = a
    mrun = 0
    for i in range(lo, hi):
        p = int(pos[i]); k = int(kind[i])
        if k == 0:
            continue  # substitution: M continues
        if k == 1:  # assembly insertion: read deletes it (D 1)
            if p <= a:      # upstream of the alignment: POS absorbs it
                continue
            mrun += p - cur
            if mrun:
                ops.append((0, mrun)); mrun = 0
            ops.append((2, 1))  # D
            cur = p
        else:  # assembly deletion: read inserts the lost base (I 1)
            mrun += p - cur
            if mrun:
                ops.append((0, mrun)); mrun = 0
            ops.append((1, 1))  # I
            cur = p + 1
    mrun += b - cur
    if mrun:
        ops.append((0, mrun))
    if tail:
        ops.append((4, tail))
    return ops, a, head, tail


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("prefix")
    p.add_argument("--contigs", type=int, default=16)
    p.add_argument("--size", type=int, default=6_000_000)
    p.add_argument("--small", type=int, default=2,
                   help="extra small contigs for oracle spot-checks")
    p.add_argument("--small-size", type=int, default=300_000)
    p.add_argument("--cov", type=float, default=30.0)
    p.add_argument("--err-bp", type=int, default=5000,
                   help="one assembly error per this many bp")
    p.add_argument("--read-len", type=int, default=12_000)
    p.add_argument("--read-err", type=float, default=0.001)
    p.add_argument("--seed", type=int, default=11)
    p.add_argument("-k", type=int, default=21)
    p.add_argument("--kmer-cov", type=int, default=30)
    p.add_argument("--het-bp", type=int, default=0,
                   help="diploid mode: one het SNP per ~INT truth bp (0 = "
                        "haploid). Reads draw 50/50 from the two haplotypes; "
                        "the assembly is haplotype 1 + errors; the yak table "
                        "counts BOTH haplotypes at --kmer-cov/2 each. "
                        "Writes PREFIX.het.tsv (switch_eval.py format).")
    p.add_argument("--repeats", type=int, default=0,
                   help="inject INT repeat-block copies per contig (truth "
                        "block of --repeat-len bp duplicated elsewhere in "
                        "the contig BEFORE edits; stresses repeat k-mer "
                        "counts and the consensus graph, BASELINE config 4)")
    p.add_argument("--repeat-len", type=int, default=30_000)
    a = p.parse_args(argv)

    rng = np.random.default_rng(a.seed)
    d = os.path.dirname(os.path.abspath(a.prefix))
    if d:
        os.makedirs(d, exist_ok=True)

    sizes = [int(a.size * (0.7 + 0.6 * rng.random())) for _ in range(a.contigs)]
    sizes += [int(a.small_size * (0.7 + 0.6 * rng.random()))
              for _ in range(a.small)]
    names = [f"ctg{c:03d}" for c in range(len(sizes))]

    # pass 1: per-contig truth/assembly generation, streamed to disk
    t0 = time.time()
    truth_f = open(a.prefix + ".truth.fa", "wb")
    asm_f = open(a.prefix + ".fa", "wb")
    edit_lists = []
    truth_list = []
    refs = []
    total_err = 0
    het_lists = []  # (hpos asc, hbase) per contig; empty when haploid
    het_f = open(a.prefix + ".het.tsv", "w") if a.het_bp else None
    n_het = 0
    for name, size in zip(names, sizes):
        truth = rand_seq(rng, size)
        for _ in range(a.repeats):
            # duplicate a truth block elsewhere (same contig) pre-edits
            L = min(a.repeat_len, size // 4)
            if L < 1000:
                break
            x = int(rng.integers(0, size - L))
            y = int(rng.integers(0, size - L))
            truth[y : y + L] = truth[x : x + L]
        pos, kind, base = make_edits(rng, size, a.err_bp)
        asm = apply_edits(truth, pos, kind, base)
        total_err += len(pos)
        if a.het_bp:
            # het SNP sites >= 50 bp from every assembly edit: hap2 reads
            # carry a substitution there (CIGARs are unchanged by subs)
            cand = np.arange(300, size - 300, 50)
            near = np.zeros(len(cand), dtype=bool)
            j = np.searchsorted(pos, cand)
            for d in (-1, 0):
                k2 = np.clip(j + d, 0, len(pos) - 1)
                if len(pos):
                    near |= np.abs(pos[k2] - cand) < 50
            cand = cand[~near]
            want = max(1, (size - 600) // max(a.het_bp, 100))
            hpos = np.sort(rng.choice(cand, size=min(want, len(cand)),
                                      replace=False)).astype(np.int64)
            shift = rng.integers(1, 4, size=len(hpos))
            hbase = BASES[(np.searchsorted(BASES, truth[hpos]) + shift) % 4]
            het_lists.append((hpos, hbase))
            n_het += len(hpos)
            for hp, hb in zip(hpos.tolist(), hbase.tolist()):
                het_f.write(f"{name}\t{hp}\t{chr(truth[hp])}\t{chr(hb)}\n")
        else:
            het_lists.append((np.zeros(0, np.int64), np.zeros(0, np.uint8)))
        truth_f.write(b">" + name.encode() + b"\n" + truth.tobytes() + b"\n")
        asm_f.write(b">" + name.encode() + b"\n" + asm.tobytes() + b"\n")
        edit_lists.append((pos, kind))
        truth_list.append(truth)
        refs.append((name, len(asm)))
    if het_f:
        het_f.close()
        print(f"{n_het} het sites -> {a.prefix}.het.tsv", file=sys.stderr)
    truth_f.close()
    asm_f.close()
    total_bp = sum(l for _, l in refs)
    print(f"{len(refs)} contigs, {total_bp} bp assembly, {total_err} injected "
          f"errors ({time.time()-t0:.0f}s)", file=sys.stderr, flush=True)

    # pass 2: reads + exact CIGARs, streamed into the BAM contig by contig
    t0 = time.time()
    n_reads = 0
    with BamWriter(a.prefix + ".bam", refs) as w:
        for tid, (name, _) in enumerate(refs):
            truth = truth_list[tid]
            pos, kind = edit_lists[tid]
            coord = asm_coord_fn(pos, kind)
            n = max(2, int(len(truth) * a.cov / a.read_len))
            lo = -(a.read_len - 2000)
            starts = np.sort(rng.integers(
                lo, max(lo + 1, len(truth) - 2000), size=n))
            hpos, hbase = het_lists[tid]
            for i, st in enumerate(starts.tolist()):
                ra = max(0, st)
                rb = min(len(truth), st + a.read_len)
                if rb - ra < 1500:
                    continue
                r = truth[ra:rb].copy()
                if len(hpos) and rng.random() < 0.5:
                    # haplotype-2 read: substitute the het alleles in range
                    lo2 = int(np.searchsorted(hpos, ra))
                    hi2 = int(np.searchsorted(hpos, rb))
                    r[hpos[lo2:hi2] - ra] = hbase[lo2:hi2]
                n_err = rng.poisson(a.read_err * len(r))
                if n_err:
                    at = rng.integers(0, len(r), size=n_err)
                    r[at] = BASES[rng.integers(0, 4, size=n_err)]
                ops, a2, head, tail = compose_cigar(ra, rb, pos, kind)
                w.write(BamRecord(
                    qname=f"{name}_r{i}_{ra}", flag=0, tid=tid,
                    pos=coord(a2), mapq=60, cigar=ops, seq=r.tobytes(),
                    qual=b""))
                n_reads += 1
    print(f"{n_reads} reads -> {a.prefix}.bam ({time.time()-t0:.0f}s)",
          file=sys.stderr, flush=True)

    # yak table from the truth genome, scaled to --kmer-cov (see module doc).
    # Diploid: count BOTH haplotypes — shared k-mers appear twice and land at
    # kmer-cov after the /2 scale; haplotype-specific ones at kmer-cov/2,
    # exactly what error-free diploid short reads would produce.
    t0 = time.time()
    seqs = [t.tobytes() for t in truth_list]
    scale = a.kmer_cov
    if a.het_bp:
        for t, (hpos, hbase) in zip(truth_list, het_lists):
            h2 = t.copy()
            h2[hpos] = hbase
            seqs.append(h2.tobytes())
        scale = max(1, a.kmer_cov // 2)
    h, c = count_kmers(seqs, a.k)
    c = np.minimum(c * scale, 1023)
    write_yak(a.prefix + f".k{a.k}.yak", a.k, h, c)
    print(f"yak: {len(h)} distinct {a.k}-mers ({time.time()-t0:.0f}s)",
          file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
