"""Thread-seconds of the window plan and the pileup per Mbp
(pipeline/windows.py, pipeline/engine.py): `plan_windows` wraps the
stream sort and filters, find_anchors and the greedy plan (stream_*,
find_anchors and plan_windows_greedy nest inside it and are not counted
again); `plan_ktiers` picks each window's slot tier; `aggregate_pileup`
aggregates a chunk's windows into the upload."""

from polishbench.readers import stage_seconds_per_mbp

LAYER = "window plan and pileup"
UNIT = "s/Mbp"
MOVES = "polish_rate"
STAGES = ("plan_windows", "plan_ktiers", "aggregate_pileup")


def read(ctx):
    return stage_seconds_per_mbp(ctx, STAGES)
