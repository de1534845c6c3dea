"""Least time of the kernels' work, from the bytes of the problem they
solve, and the card's published peak.

The bytes are those of the problem's inputs and outputs, never a kernel's
intermediates or its probes, so that any implementation of the same work
is held to the same yardstick. Chunk kernels: the blob (or tables)
uploaded for a chunk and the packed output downloaded. k-mer kernels: a
lookup's 64-bit query hashes in and 32-bit counts out; a scoring batch's
allele bases (a byte each) and 32-bit allele starts in and 32-bit minima
out. Memory bound: least time = bytes / the peak HBM bandwidth.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, at its 700 W power limit
PEAK_HBM_BYTES_PER_S = 3.35e12

# the DP and backtrack kernels' names in the profiler's trace (substrings)
CHUNK_KERNELS = ("dp_v2_kernel", "dp_reduce_kernel", "backtrack_kernel")
# the k-mer kernels' (csrc/kmer_lookup.cu, csrc/kmer_score.cu)
KMER_KERNELS = ("kmer_lookup_kernel", "kmer_score_kernel")


def chunk_bytes_in(arrays) -> int:
    return sum(int(a.nbytes) for a in arrays)


def chunk_bytes_out(out) -> int:
    return int(out.numel()) * int(out.element_size())


def kmer_lookup_bytes(n_queries: int) -> int:
    return 12 * int(n_queries)


def kmer_score_bytes(seqs) -> int:
    return sum(len(x) for x in seqs) + 8 * len(seqs)


def least_seconds(n_bytes: int) -> float:
    return n_bytes / PEAK_HBM_BYTES_PER_S


def is_chunk_kernel(kernel_name: str) -> bool:
    return any(k in kernel_name for k in CHUNK_KERNELS)


def is_kmer_kernel(kernel_name: str) -> bool:
    return any(k in kernel_name for k in KMER_KERNELS)


def share_percent(n_bytes: int, device_seconds: float):
    """The least time as a share of the measured device time, in %, or
    None where the kernels did not run."""
    if device_seconds <= 0 or n_bytes <= 0:
        return None
    return 100.0 * least_seconds(n_bytes) / device_seconds
