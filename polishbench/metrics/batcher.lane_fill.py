"""Share of the cross-contig batcher's dispatched lanes that carry a
window, in %: the program's `batcher.lanes_real` counter over
`batcher.lanes_dispatched` (each batch's padded lanes; both counted where
pipeline/batcher.py's BatchStats counts them). Lanes past the real ones
are padding the DP and backtrack kernels compute for nothing. Nothing to
read where the program keeps no counters or dispatched no batch (-t 1, or
a single contig to polish)."""

from polishbench.program import recording

LAYER = "chunk engine"
UNIT = "%"
MOVES = "polish_rate"


def read(ctx):
    prog = recording(ctx)
    if not prog or not prog["counters"].get("batcher.lanes_dispatched"):
        return None
    c = prog["counters"]
    return 100.0 * c.get("batcher.lanes_real", 0) / c["batcher.lanes_dispatched"]
