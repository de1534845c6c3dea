"""Thread-seconds of LQ detection, allele extraction and read phasing per
Mbp (models/oracle_lq.py, models/louvain.py): `lq_detect`,
`extract_alleles` (extract_native and extract_materialize nest inside)
and `phasing`."""

from polishbench.readers import stage_seconds_per_mbp

LAYER = "LQ detection and phasing"
UNIT = "s/Mbp"
MOVES = "polish_rate"
STAGES = ("lq_detect", "extract_alleles", "phasing")


def read(ctx):
    return stage_seconds_per_mbp(ctx, STAGES)
