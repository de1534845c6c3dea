"""Thread-microseconds of read phasing per heterozygous LQ region: the
program's `phasing` spans (models/oracle_lq.py: mark_hete_lqseqs, the
read graph and Louvain, models/louvain.py) over its `lq.het_regions`
counter (the regions mark_hete_lqseqs labels heterozygous). Nothing to
read where the program records no spans or labelled no region
heterozygous (a haploid assembly)."""

from polishbench.program import recording

LAYER = "LQ detection and phasing"
UNIT = "us"
MOVES = "polish_rate"


def read(ctx):
    prog = recording(ctx)
    if not prog or not prog["counters"].get("lq.het_regions"):
        return None
    s = sum(r[3] - r[2] for r in prog["spans"]
            if r[0] == "phasing" and r[3] is not None)
    return 1e6 * s / prog["counters"]["lq.het_regions"]
