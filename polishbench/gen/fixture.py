"""Seeded polishing inputs with a known truth: assembly, HiFi-like reads
in a BAM with exact CIGARs, and one yak table per k-mer size.

    python3 polishbench/gen/fixture.py --traffic FILE.json --ks 21,31 \\
        --seed N --out DIR

A truth contig gets `repeats` blocks of `repeat_len` bases, each present
`repeat_copies` times (2 unless set), before any edit; then one assembly
error (substitution, insertion or deletion of one base, at least 100 bp
apart) per `err_bp`. Diploid traffic (`het_bp` > 0) marks one het SNP per
`het_bp`, at least 50 bp from every assembly error; half the reads come
from haplotype 2. Reads of `read_len` bases at `cov`x carry the errors of
`read_errors`: substitutions, insertions and deletions at per-base rates
`sub`, `ins` and `del`, indel lengths drawn from the measured
`ins_len` / `del_len` histograms ([length, count] pairs), and a share
`ins_hp` / `del_hp` of indels in homopolymer context (an insertion that
repeats the base before it; a deletion that starts at a run of two or more
equal bases). Read errors keep 3 bases from a read's ends and from every
assembly error, and do not overlap. Because every edit is known in truth
coordinates, each read's CIGAR against the assembly is exact by
construction: a substitution is a mismatch column, an assembly insertion a
1-base D, an assembly deletion a 1-base I, a read insertion an I and a read
deletion a D. The yak tables count the truth (both haplotypes, each at half
weight, when diploid) scaled to `kmer_cov`, as error-free short reads at
that coverage would.

Every seed gets the same contig sizes, in the same order, and the same
numbers of errors, het sites, repeats and reads per contig; the seed draws
the sequence, the positions and the read errors. The lengths come from
the traffic file: `contigs` (polished under the configuration's -L) and
`passthrough` (shorter than -L).

Writes DIR/{asm.fa, truth.fa, reads.bam, k<K>.yak..., het.tsv, meta.json}.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from seqio import BamWriter, count_kmers, write_yak  # noqa: E402

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def make_edits(rng, n_pos: int, err_bp: int):
    """Edit list in truth coordinates: positions (ascending, >= 100 bp
    apart, >= 300 bp from the ends), kind 0 sub / 1 ins / 2 del, base."""
    n = max(1, (n_pos - 600) // max(err_bp, 100))
    cand = np.arange(300, n_pos - 300, 100)
    pos = np.sort(rng.choice(cand, size=min(n, len(cand)), replace=False))
    kind = rng.integers(0, 3, size=len(pos)).astype(np.uint8)
    base = BASES[rng.integers(0, 4, size=len(pos))]
    return pos.astype(np.int64), kind, base


def apply_edits(truth: np.ndarray, pos, kind, base) -> np.ndarray:
    out = []
    t = 0
    for p, k, b in zip(pos.tolist(), kind.tolist(), base.tolist()):
        out.append(truth[t:p])
        if k == 0:  # substitution by another base
            nb = b if b != truth[p] else BASES[
                (int(np.searchsorted(BASES, truth[p])) + 1) % 4]
            out.append(np.array([nb], dtype=np.uint8))
            t = p + 1
        elif k == 1:  # a base inserted into the assembly before truth[p]
            out.append(np.array([b], dtype=np.uint8))
            t = p
        else:  # truth[p] deleted from the assembly
            t = p + 1
    out.append(truth[t:])
    return np.concatenate(out)


def error_model(traffic: dict) -> dict:
    """The traffic's `read_errors`, with the length histograms as arrays
    and their draw probabilities."""
    model = dict(traffic["read_errors"])
    for key in ("ins_len", "del_len"):
        hist = np.asarray(model[key], dtype=np.float64)
        model[key] = (hist[:, 0].astype(np.int64), hist[:, 1] /
                      hist[:, 1].sum())
    return model


def draw_read_errors(rng, model: dict, a: int, b: int, runs, blocked):
    """Read-error events inside truth [a, b), sorted and apart: (pos, kind,
    length, in homopolymer context, substitution shift) with kind 0 sub,
    1 insertion before pos, 2 deletion of [pos, pos + length). `model` is
    error_model's, `runs` the starts of runs of two or more equal truth
    bases, `blocked` the assembly errors' positions."""
    lo, hi = a + 3, b - 3
    if hi - lo < 10:
        return []
    n = hi - lo
    parts = []
    for kind, rate in ((0, model["sub"]), (1, model["ins"]),
                       (2, model["del"])):
        k = int(rng.poisson(rate * n))
        if not k:
            continue
        pos = rng.integers(lo, hi, size=k)
        if kind == 0:
            ln = np.ones(k, dtype=np.int64)
        else:
            lens, prob = model["ins_len" if kind == 1 else "del_len"]
            ln = lens[rng.choice(len(lens), size=k, p=prob)]
        hp = rng.random(k) < (model["ins_hp"] if kind == 1 else
                              model["del_hp"] if kind == 2 else 0.0)
        if kind == 2 and hp.any():
            r0, r1 = np.searchsorted(runs, [lo, hi])
            if r1 > r0:
                pos[hp] = runs[rng.integers(r0, r1, size=int(hp.sum()))]
        shift = rng.integers(1, 4, size=k)
        parts.append((pos, np.full(k, kind), ln, hp, shift))
    if not parts:
        return []
    p, kind, ln, hp, sft = (np.concatenate(x) for x in zip(*parts))
    order = np.lexsort((sft, hp, ln, kind, p))
    p, kind, ln, hp, sft = p[order], kind[order], ln[order], hp[order], \
        sft[order]
    last = p + np.where(kind == 2, ln, np.where(kind == 0, 1, 0))
    j = np.searchsorted(blocked, p - 3)
    near = (j < len(blocked)) & (blocked[np.minimum(j, len(blocked) - 1)]
                                 <= last + 3) if len(blocked) else False
    keep = ~near & (last <= hi)
    out, end = [], lo
    for e in zip(p[keep].tolist(), kind[keep].tolist(), ln[keep].tolist(),
                 hp[keep].tolist(), sft[keep].tolist(), last[keep].tolist()):
        if e[0] < end:
            continue
        out.append(e[:5])
        end = e[5] + 1
    return out


def compose_read(src: np.ndarray, ra: int, rb: int, pos, kind, events,
                 rng):
    """Bases and CIGAR of a read drawn from `src` over truth [ra, rb) with
    the read errors `events`, against the assembly made by the edits
    (`pos`, `kind`). Returns (bases, ops, first aligned truth base);
    assembly-deleted bases at either end become soft clips."""
    dels = pos[kind == 2]

    def deleted(q: int) -> bool:
        i = int(np.searchsorted(dels, q))
        return i < len(dels) and dels[i] == q

    a, b = ra, rb
    head = 0
    while deleted(a):
        a += 1
        head += 1
    tail = 0
    while b - 1 > a and deleted(b - 1):
        b -= 1
        tail += 1
    lo = int(np.searchsorted(pos, a, "left"))
    hi = int(np.searchsorted(pos, b, "left"))
    # (truth position, order at that position, what): assembly insertions
    # sit before their truth base, as read insertions do
    todo = [(int(pos[i]), 0, "ai", 0, 0) for i in range(lo, hi)
            if kind[i] == 1 and int(pos[i]) > a]
    todo += [(int(pos[i]), 1, "ad", 0, 0) for i in range(lo, hi)
             if kind[i] == 2]
    todo += [(p, 0 if k == 1 else 1, ("s", "i", "d")[k], l, (h, s))
             for p, k, l, h, s in events]
    todo.sort(key=lambda t: (t[0], t[1]))
    seq = [src[ra:a]]
    ops = [(4, head)] if head else []
    cur, mrun = a, 0

    def flush():
        nonlocal mrun
        if mrun:
            ops.append((0, mrun))
            mrun = 0

    for p, _, what, ln, extra in todo:
        if p > cur:
            seq.append(src[cur:p])
            mrun += p - cur
            cur = p
        if what == "ai":  # a base of the assembly the read lacks
            flush()
            ops.append((2, 1))
        elif what == "ad":  # a truth base the assembly lacks
            flush()
            ops.append((1, 1))
            seq.append(src[p:p + 1])
            cur = p + 1
        elif what == "s":  # a read substitution: a mismatch column
            _, sft = extra
            b0 = int(np.searchsorted(BASES, src[p]))
            seq.append(BASES[[(b0 + sft) % 4]])
            mrun += 1
            cur = p + 1
        elif what == "i":  # read insertion before truth base p
            flush()
            ops.append((1, ln))
            h, _ = extra
            seq.append(np.full(ln, src[p - 1], dtype=np.uint8) if h else
                       BASES[rng.integers(0, 4, size=ln)])
        else:  # read deletion of truth [p, p + ln)
            flush()
            ops.append((2, ln))
            cur = p + ln
    seq.append(src[cur:b])
    mrun += b - cur
    flush()
    if tail:
        ops.append((4, tail))
    seq.append(src[b:rb])
    return np.concatenate(seq), ops, a


def generate(traffic: dict, ks, seed: int, out: str) -> dict:
    """Write one seed's inputs into `out` (replaced whole); returns meta."""
    rng = np.random.default_rng(seed)
    tmp = out + ".part"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    sizes = [int(s) for s in traffic["contigs"]] + \
        [int(s) for s in traffic.get("passthrough", [])]
    err_bp = int(traffic["err_bp"])
    het_bp = int(traffic.get("het_bp", 0))
    repeats = int(traffic.get("repeats", 0))
    repeat_len = int(traffic.get("repeat_len", 30000))
    repeat_copies = int(traffic.get("repeat_copies", 2))
    cov = float(traffic["cov"])
    read_len = int(traffic["read_len"])
    model = error_model(traffic)
    kmer_cov = int(traffic["kmer_cov"])
    t0 = time.time()

    truths, haps2, edits, refs = [], [], [], []
    het_rows = []
    with open(os.path.join(tmp, "truth.fa"), "wb") as tf, \
            open(os.path.join(tmp, "asm.fa"), "wb") as af:
        for c, size in enumerate(sizes):
            name = f"ctg{c:03d}"
            truth = BASES[rng.integers(0, 4, size=size)]
            L = min(repeat_len, size // 4)
            for _ in range(repeats if L >= 1000 else 0):
                x, *ys = (int(v) for v in rng.integers(0, size - L,
                                                       size=repeat_copies))
                for y in ys:
                    truth[y: y + L] = truth[x: x + L]
            pos, kind, base = make_edits(rng, size, err_bp)
            asm = apply_edits(truth, pos, kind, base)
            hap2 = None
            if het_bp:
                cand = np.arange(300, size - 300, 50)
                j = np.searchsorted(pos, cand)
                near = np.zeros(len(cand), dtype=bool)
                for d in (-1, 0):
                    near |= np.abs(pos[np.clip(j + d, 0, len(pos) - 1)]
                                   - cand) < 50
                cand = cand[~near]
                want = max(1, (size - 600) // max(het_bp, 100))
                hpos = np.sort(rng.choice(cand, size=min(want, len(cand)),
                                          replace=False)).astype(np.int64)
                shift = rng.integers(1, 4, size=len(hpos))
                hap2 = truth.copy()
                hap2[hpos] = BASES[(np.searchsorted(BASES, truth[hpos])
                                    + shift) % 4]
                het_rows += [f"{name}\t{p}\t{chr(truth[p])}\t{chr(hap2[p])}\n"
                             for p in hpos.tolist()]
            tf.write(b">" + name.encode() + b"\n" + truth.tobytes() + b"\n")
            af.write(b">" + name.encode() + b"\n" + asm.tobytes() + b"\n")
            truths.append(truth)
            haps2.append(hap2)
            edits.append((pos, kind))
            refs.append((name, len(asm)))
    if het_rows:
        with open(os.path.join(tmp, "het.tsv"), "w") as f:
            f.writelines(het_rows)

    n_reads = 0
    with BamWriter(os.path.join(tmp, "reads.bam"), refs) as w:
        for tid, (name, _) in enumerate(refs):
            truth, hap2 = truths[tid], haps2[tid]
            pos, kind = edits[tid]
            ins = pos[kind == 1]
            dels = pos[kind == 2]
            same = np.flatnonzero(truth[1:] == truth[:-1])
            runs = same[np.r_[True, np.diff(same) > 1]] if len(same) else same
            n = max(2, int(len(truth) * cov / read_len))
            lo = -(read_len - 2000)
            starts = np.sort(rng.integers(lo, max(lo + 1, len(truth) - 2000),
                                          size=n))
            for i, st in enumerate(starts.tolist()):
                ra, rb = max(0, st), min(len(truth), st + read_len)
                if rb - ra < 1500:
                    continue
                src = hap2 if hap2 is not None and rng.random() < 0.5 \
                    else truth
                events = draw_read_errors(rng, model, ra, rb, runs, pos)
                r, ops, a2 = compose_read(src, ra, rb, pos, kind, events, rng)
                # assembly coordinate of truth base a2
                apos = (a2 + int(np.searchsorted(ins, a2, "right"))
                        - int(np.searchsorted(dels, a2, "left")))
                w.write(f"{name}_r{i}_{ra}", tid, apos, ops, r.tobytes())
                n_reads += 1

    seqs = [t.tobytes() for t in truths]
    scale = kmer_cov
    if het_bp:
        seqs += [h.tobytes() for h in haps2 if h is not None]
        scale = max(1, kmer_cov // 2)
    n_kmers = {}
    for k in ks:
        h, c = count_kmers(seqs, int(k))
        write_yak(os.path.join(tmp, f"k{k}.yak"), int(k), h,
                  np.minimum(c * scale, 1023))
        n_kmers[str(k)] = int(len(h))
    meta = {"seed": int(seed), "contigs": [n for n, _ in refs],
            "asm_lengths": [l for _, l in refs],
            "asm_bases": int(sum(l for _, l in refs)),
            "errors": int(sum(len(p) for p, _ in edits)),
            "het_sites": len(het_rows), "reads": n_reads,
            "distinct_kmers": n_kmers, "ks": [int(k) for k in ks],
            "seconds": time.time() - t0}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    shutil.rmtree(out, ignore_errors=True)
    os.replace(tmp, out)
    return meta


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--traffic", required=True, help="traffic JSON file")
    p.add_argument("--ks", required=True, help="k-mer sizes, e.g. 21,31")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--out", required=True, help="output directory")
    a = p.parse_args(argv)
    with open(a.traffic) as f:
        traffic = json.load(f)
    meta = generate(traffic, [int(k) for k in a.ks.split(",")], a.seed, a.out)
    print(json.dumps(meta))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
