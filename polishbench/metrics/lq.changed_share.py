"""Share of LQ regions whose splice changed the consensus, in %: the
program's `lq.regions_changed` counter (splices of the last iteration
whose seed differs from the bytes it replaces, the recheck's included;
models/oracle_lq.py::update_consensus_with_lqseqs) over `lq.regions` (the
regions of every iteration): useful outcomes per attempt. 0 where no
splice changed a byte; nothing to read where the program keeps no
counters or made no region."""

from polishbench.program import recording

LAYER = "LQ detection and phasing"
UNIT = "%"
MOVES = "polish_rate"


def read(ctx):
    prog = recording(ctx)
    if not prog or not prog["counters"].get("lq.regions"):
        return None
    c = prog["counters"]
    return 100.0 * c.get("lq.regions_changed", 0) / c["lq.regions"]
