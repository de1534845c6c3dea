"""Audit the phasing module: per-read community assignment + drop decisions.

Equivalent of the reference's other/phasing.debug.py audit flow: run the
heterozygous-site detection + Louvain phasing for one contig and print, per read,
its order, qname, het-interval agreements, and whether phasing dropped it.
Host only (the oracle modules).

Usage: python -m nextpolish2_tpu_torch.tools.phasing_debug sorted.bam \\
           genome.fa[.gz] short.read.yak [-L MIN_CTG_LEN]
"""

from __future__ import annotations

import argparse
import sys

from ..config import PolishConfig
from ..io.bam import BamReader
from ..io.fastx import read_fastx
from ..io.yak import load_yak
from ..models.oracle import build_alignseqs
from ..models.oracle_lq import (L_HETE, extract_alleles, mark_hete_lqseqs,
                                phase_reads_by_lqseqs, retrieve_kmer_count)
from ..models.oracle_msa import backtrack_lq, build_msas, consensus_dp


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("bam")
    p.add_argument("fa")
    p.add_argument("yak")
    p.add_argument("-L", "--min_ctg_len", type=int, default=1)
    a = p.parse_args(argv)
    cfg = PolishConfig(min_ctg_len=a.min_ctg_len)
    table = load_yak(a.yak)
    reader = BamReader(a.bam)
    by_tid = dict(reader.by_contig())
    names = {n: i for i, (n, _) in enumerate(reader.references)}
    for name, seq in read_fastx(a.fa):
        if len(seq) < cfg.min_ctg_len:
            continue
        recs = by_tid.get(names.get(name), [])
        aligns = build_alignseqs(seq, recs, cfg)
        qnames = {0: b"<reference>"}
        order = 1
        for r in recs:
            qnames.setdefault(order, r.qname)
            order += 1
        msas = build_msas(aligns, len(seq))
        _, bestis, gb = consensus_dp(msas)
        _, lqseqs = backtrack_lq(msas, bestis, gb)
        if not lqseqs:
            print(f"{name}: no LQ regions", file=sys.stderr)
            continue
        extract_alleles(aligns, lqseqs, table, cfg.lqseq_max_can_count)
        retrieve_kmer_count(lqseqs, table, cfg.min_kmer_count)
        mark_hete_lqseqs(lqseqs, cfg.lqseq_max_can_count)
        het = [l for l in lqseqs if l.label & L_HETE]
        print(f"{name}: {len(lqseqs)} LQ regions, {len(het)} heterozygous",
              file=sys.stderr)
        for l in het:
            alleles = {}
            for s in l.seqs:
                alleles.setdefault(s.seq, []).append(s.order)
            print(f"H\t{name}\t{l.start}\t{l.end}\t" + "\t".join(
                f"{al.decode()}:{','.join(map(str, orders))}"
                for al, orders in alleles.items()))
        dropped = set(phase_reads_by_lqseqs(het, cfg.model == "ref",
                                            cfg.use_all_reads))
        for o in sorted(dropped):
            print(f"D\t{name}\t{o}\t{qnames.get(o, b'?').decode()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
