"""Thread-seconds the chunk engine spends handing chunks to the device
and waiting for their packed results, per Mbp (pipeline/engine.py,
pipeline/batcher.py, ops/consensus.py): `device_submit` (upload and
launch of a chunk's program) and `device_dp_backtrack` (waiting for and
decoding its result)."""

from polishbench.readers import stage_seconds_per_mbp

LAYER = "chunk engine"
UNIT = "s/Mbp"
MOVES = "polish_rate"
STAGES = ("device_submit", "device_dp_backtrack")


def read(ctx):
    return stage_seconds_per_mbp(ctx, STAGES)
