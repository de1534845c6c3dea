"""Thread-seconds of the k-mer tables' load, allele scoring and the
splice with its recheck per Mbp (io/yak.py, ops/kmer_table.py,
ops/kmer_score.py, models/oracle_lq.py): `load_yak_tables`,
`kmer_scoring` and `splice_recheck`. The kscore_*, kmer_table_build and
kmer_get_device stages nest inside the last two and are not counted
again."""

from polishbench.readers import stage_seconds_per_mbp

LAYER = "k-mer scoring and splice"
UNIT = "s/Mbp"
MOVES = "polish_rate"
STAGES = ("load_yak_tables", "kmer_scoring", "splice_recheck")


def read(ctx):
    return stage_seconds_per_mbp(ctx, STAGES)
