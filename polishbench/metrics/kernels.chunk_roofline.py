"""Share of the chunk kernels' roofline, in %: the least time to move the
chunk program's problem bytes (every chunk's upload and packed output,
counted by the probes around ChunkRunner.put and .finish) at the peak HBM
bandwidth, over the device time the profiler gives the DP and backtrack
kernels (csrc/consensus_dp*.cu, csrc/backtrack.cu) in the window."""

from polishbench import roofline

LAYER = "DP and backtrack kernels"
UNIT = "%"
MOVES = "polish_rate"


def read(ctx):
    b = ctx["bytes"].get("chunk_in", 0) + ctx["bytes"].get("chunk_out", 0)
    return roofline.share_percent(b, ctx["chunk_kernel_s"])
