"""Idle share of the device over the traced window, in %: 1 - (the union
of the intervals of its kernels, copies and sets) / (the window between
the two marker kernels), from the profiler's timeline."""

LAYER = "the device"
UNIT = "%"
MOVES = "polish_rate"


def read(ctx):
    w = ctx["trace"]["window_s"]
    if w <= 0:
        return None
    return 100.0 * (1.0 - ctx["trace"]["busy_s"] / w)
