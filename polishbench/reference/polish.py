"""The plain reference: per-contig polishing as NextPolish2's worker loop
does it (src/main.rs:1726-1837), in NumPy and Python alone.

Build the alignments, then iter_count rounds of MSA -> consensus DP -> LQ
detection, with read phasing on the rounds before the last and seed and
recheck splicing on the last. A frozen copy of the polisher's pure-Python
specification, with every native and device route taken out: it imports
nothing of the program under test, and the benchmark holds the program's
output to it byte for byte.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

import numpy as np

from .config import PolishConfig
from .bamio import BamRecord
from .yak import KmerTable
from .seqcodes import ASCII2CODE
from .align import AlignTags, filter_by_clip, record_to_tags, ref_as_tags
from .lq import (
    L_SUCC,
    extract_alleles,
    fill_seed_lqseqs,
    mark_hete_lqseqs,
    phase_reads_by_lqseqs,
    retrieve_kmer_count,
    reupdate_consensus_with_lqseqs,
    update_consensus_with_lqseqs,
)
from .msa import Consensus, backtrack_lq, build_msas, consensus_dp


def passthrough_consensus(tseq: bytes) -> Consensus:
    """seq2consensusbase_vec (main.rs:598-605): identity consensus."""
    return Consensus(pos=np.arange(len(tseq), dtype=np.int64),
                     base=np.frombuffer(tseq, dtype=np.uint8).copy())


def build_alignseqs(tseq: bytes, records: Iterable[BamRecord],
                    cfg: PolishConfig) -> List[AlignTags]:
    """Reference pseudo-alignment + filtered/trimmed reads + clip filter
    (main.rs:1732-1817)."""
    tseq_codes = ASCII2CODE[np.frombuffer(tseq, dtype=np.uint8)]
    alignseqs: List[AlignTags] = [ref_as_tags(tseq_codes)]
    for rec in records:
        tags = record_to_tags(rec, tseq_codes, len(tseq), cfg)
        if tags is not None:
            alignseqs.append(tags)
    filter_by_clip(alignseqs, cfg)
    return alignseqs


def polish_contig(tseq: bytes, records: Sequence[BamRecord],
                  tables: Sequence[KmerTable],
                  cfg: Optional[PolishConfig] = None) -> Consensus:
    """Polish one contig; returns the consensus base list (pos, ascii base)."""
    cfg = cfg or PolishConfig()
    if len(tseq) < cfg.min_ctg_len:
        return passthrough_consensus(tseq)

    tables = sorted(tables, key=lambda t: t.ksize)  # option.rs:238
    alignseqs = build_alignseqs(tseq, records, cfg)

    for i in range(cfg.iter_count):
        out_cns = i + 1 == cfg.iter_count
        msas = build_msas(alignseqs, len(tseq))
        _, bestis, gb = consensus_dp(msas)
        cb, lqseqs = backtrack_lq(msas, bestis, gb, cfg.hq_min_qv, cfg.lq_min_length)
        del msas
        if not lqseqs:
            if out_cns:
                return cb
            continue  # no LQ regions -> nothing to phase (main.rs:1638-1639)

        extract_alleles(alignseqs, lqseqs, tables[0], cfg.lqseq_max_can_count)
        retrieve_kmer_count(lqseqs, tables[0], cfg.min_kmer_count)
        if out_cns:
            fill_seed_lqseqs(lqseqs, cfg.max_indel_len, cfg.lqseq_max_can_count)
            consensus = update_consensus_with_lqseqs(lqseqs, cb, L_SUCC)
            for p, table in enumerate(tables):
                consensus = reupdate_consensus_with_lqseqs(
                    lqseqs, consensus, table, cfg.min_kmer_count, p + 1,
                    cfg.lqseq_max_can_count)
            return consensus
        mark_hete_lqseqs(lqseqs, cfg.lqseq_max_can_count)
        invalid = phase_reads_by_lqseqs(lqseqs, cfg.model == "ref", cfg.use_all_reads)
        for order in invalid:
            alignseqs[order].dropped = True

    raise AssertionError("unreachable: iter_count >= 1 required")


def consensus_to_bytes(cb: Consensus) -> bytes:
    return cb.to_bytes()
