"""Compare a polished FASTA against the fixture truth genome, per contig.

Usage: python -m nextpolish2_tpu_torch.tools.check_against_truth OUT.fa \\
           TRUTH.fa [--oracle-spot BAM ASM YAK N]

Reports per-contig byte-identity (polished sequence == truth sequence) and a
summary. With --oracle-spot, additionally re-polishes the N SHORTEST contigs
through the pure-Python oracle (models.oracle.polish_contig — the executable
spec, on the host) and byte-compares the production output against it: the
independent engine-vs-spec check at scale."""

from __future__ import annotations

import argparse

from ..io.fastx import read_fastx


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("out_fa")
    ap.add_argument("truth_fa")
    ap.add_argument("--oracle-spot", nargs=4, metavar=("BAM", "ASM", "YAK", "N"),
                    help="oracle re-polish of the N shortest contigs")
    a = ap.parse_args(argv)

    out = {}
    for name, seq in read_fastx(a.out_fa):
        out[name.split(":")[0]] = seq.upper()
    truth = dict(read_fastx(a.truth_fa))
    n_ok = 0
    for name, tseq in truth.items():
        o = out.get(name)
        ok = o == tseq.upper()
        n_ok += ok
        if not ok:
            got = len(o) if o is not None else "MISSING"
            print(f"  MISMATCH {name}: truth {len(tseq)} bp, polished {got}")
    print(f"truth check: {n_ok}/{len(truth)} contigs byte-identical")
    rc = 0 if n_ok == len(truth) else 1

    if a.oracle_spot:
        bam_p, asm_p, yak_p, n = a.oracle_spot
        from ..config import PolishConfig
        from ..io.bam import BamReader
        from ..io.yak import load_yak
        from ..models.oracle import consensus_to_bytes, polish_contig

        asm = dict(read_fastx(asm_p))
        names = sorted(asm, key=lambda k: len(asm[k]))[: int(n)]
        tables = [load_yak(yak_p)]
        cfg = PolishConfig(min_ctg_len=1000)
        reader = BamReader(bam_p)
        tid_of = {nm: i for i, (nm, _) in enumerate(reader.references)}
        by_tid = {}
        for tid, recs in reader.by_contig():
            if tid in {tid_of[nm] for nm in names}:
                by_tid[tid] = recs
        for nm in names:
            cb = polish_contig(asm[nm], by_tid.get(tid_of[nm], []), tables, cfg)
            ob = consensus_to_bytes(cb).upper()
            ok = out.get(nm) == ob
            print(f"oracle spot {nm} ({len(asm[nm])} bp): "
                  f"{'byte-identical' if ok else 'MISMATCH'}")
            rc |= 0 if ok else 2
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
