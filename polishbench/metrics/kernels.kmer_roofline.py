"""Share of the k-mer kernels' roofline, in %: the least time to move the
problem bytes of every device k-mer lookup and scoring batch (queries and
counts, allele bases, starts and minima; counted by the probes around
KmerTable.get_device and kmer_score.device_min_kscores) at the peak HBM
bandwidth, over the device time the profiler gives kmer_lookup_kernel and
kmer_score_kernel (csrc/kmer_lookup.cu, csrc/kmer_score.cu) in the window.
Nothing to read where no batch took a device route."""

from polishbench import roofline

LAYER = "k-mer kernels"
UNIT = "%"
MOVES = "polish_rate"


def read(ctx):
    return roofline.share_percent(ctx["bytes"].get("kmer", 0),
                                  ctx.get("kmer_kernel_s", 0.0))
