"""Helpers the per-layer metric readers share.

A reader gets `ctx`, built by run.py after a traced window:
- bases: assembly bases of all passes in the window (PolishStats.in_bases,
  passthrough contigs included), the same bases as polish_rate's;
- stages: stage name -> seconds summed over all threads (the program's
  utils/timing totals; at -t N these are thread-seconds, not wall);
- stats: the PolishStats of each pass;
- trace: the reduced profiler window (trace.reduce_window);
- chunk_kernel_s: device seconds of the DP and backtrack kernels in the
  window (roofline.is_chunk_kernel);
- kmer_kernel_s: the same of the k-mer kernels (roofline.is_kmer_kernel);
- bytes: the problem bytes of the chunk program (chunk_in, chunk_out) and
  of the device k-mer routes (kmer) (probes.py).
"""

from __future__ import annotations


def stage_seconds_per_mbp(ctx, stages):
    """Summed seconds of `stages` per Mbp polished, or None where none of
    them ran. The stages listed must not nest in one another."""
    found = [ctx["stages"][s] for s in stages if s in ctx["stages"]]
    if not found or ctx["bases"] <= 0:
        return None
    return sum(found) / (ctx["bases"] / 1e6)
