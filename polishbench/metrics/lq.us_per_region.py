"""Thread-microseconds of LQ detection, allele extraction and read phasing
per LQ region made (models/oracle_msa.py, models/oracle_lq.py,
models/louvain.py): the program's `lq_detect`, `extract_alleles` and
`phasing` spans (extract_native and extract_materialize nest inside and
are not counted again) over its `lq.regions` counter, which counts the
regions of every phasing iteration. Nothing to read where the program
records no spans or made no region."""

from polishbench.program import recording

LAYER = "LQ detection and phasing"
UNIT = "us"
MOVES = "polish_rate"
STAGES = ("lq_detect", "extract_alleles", "phasing")


def read(ctx):
    prog = recording(ctx)
    if not prog or not prog["counters"].get("lq.regions"):
        return None
    s = sum(r[3] - r[2] for r in prog["spans"]
            if r[0] in STAGES and r[3] is not None)
    return 1e6 * s / prog["counters"]["lq.regions"]
