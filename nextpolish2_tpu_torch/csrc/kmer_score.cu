// Fused allele scorer for Hopper (sm_90a), plain C interface: the minimum
// k-mer count of each allele of a batch, from the raw base codes.
//
// Replaces the jitted XLA function nextpolish2_tpu/ops/kmer_score.py::
// device_min_kscores_jit: codes uint8 [L] (the alleles joined, separated
// and padded by codes >= 4), starts int32 [S] (each allele's first offset,
// ascending; padding repeats L) -> int32 [S]. For every end position j
// whose k codes c[j-k+1 .. j] are all below 4 (k < 32): the canonical
// 2k-bit k-mer min(forward, reverse complement), its yak hash, the count
// that the table holds for it (0 if absent or below min_count). Each
// allele gets the minimum over its valid end positions, 0 where it has
// none. Where JAX works on two uint32 planes (the TPU has no 64-bit
// words), this kernel uses native unsigned 64-bit arithmetic, so the
// hash's shifts are logical and its sums wrap as yak's do.
//
// Bound: by bytes: 1 B a base and 4 B an allele, streamed, plus the random
// 32 B sectors of the probes. XLA needs k passes for the rolling k-mer and
// n_probes gathers over L; here one thread per end position builds its
// k-mer from the k bytes that end there (neighbouring threads read
// neighbouring bytes, from L1), hashes it in registers and probes until its
// hit or the first empty slot (kmer_common.cuh). The allele of a position
// is found by binary search in `starts` (no scatter, no scan); the lanes
// of a warp that share an allele take their minimum in one
// __reduce_min_sync, and one of them does the atomicMin.

#include <limits.h>

#include "kmer_common.cuh"

namespace {

using namespace np2t_kmer;

__global__ void fill_kernel(int* __restrict__ out, int S, int value) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < S) out[i] = value;
}

__global__ void __launch_bounds__(256)
kmer_score_kernel(const int* __restrict__ key_hi,
                  const int* __restrict__ key_lo,
                  const int* __restrict__ counts,
                  const uint8_t* __restrict__ codes,
                  const int* __restrict__ starts, int* __restrict__ mins,
                  int L, int S, int ksize, uint32_t mask, int min_count,
                  int n_probes) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  // every lane stays to the warp-wide match below; lanes past L and
  // positions without a valid k-mer carry INT_MAX
  int value = INT_MAX;
  int sid = -1;
  if (j < L) {
    bool valid = j >= ksize - 1;
    uint64_t fwd = 0, rev = 0;
    for (int t = 0; valid && t < ksize; ++t) {
      const uint32_t c = __ldg(codes + (j - ksize + 1 + t));
      valid = c < 4;
      fwd |= (uint64_t)(c & 3u) << (2 * (ksize - 1 - t));
      rev |= (uint64_t)((c & 3u) ^ 3u) << (2 * t);
    }
    // allele of position j: #{i >= 1 : starts[i] <= j}
    int lo = 1, hi = S;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (__ldg(starts + mid) <= j) lo = mid + 1;
      else hi = mid;
    }
    sid = lo - 1;
    if (valid) {
      const uint64_t kmask = (1ull << (2 * ksize)) - 1;
      const uint64_t h = yak_hash64(fwd < rev ? fwd : rev, kmask);
      const uint32_t s10 = (uint32_t)(h >> 10);
      const uint32_t slot = (s10 ^ ((uint32_t)h << 7)) & mask;
      const int c = probe_table(key_hi, key_lo, counts, (int)(h >> 32),
                                (int)(uint32_t)h, slot, (s10 | 1u) & mask,
                                mask, n_probes);
      value = c >= min_count ? c : 0;
    }
  }
  const unsigned group = __match_any_sync(0xffffffffu, sid);
  const int m = __reduce_min_sync(group, value);
  const int lane = threadIdx.x & 31;
  if (lane == __ffs(group) - 1 && m != INT_MAX) atomicMin(mins + sid, m);
}

__global__ void finish_kernel(int* __restrict__ out, int S) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < S && out[i] == INT_MAX) out[i] = 0;
}

}  // namespace

// mask = table size - 1 (a power of two minus one); out int32 [S]
extern "C" int np2t_kmer_score(const void* key_hi, const void* key_lo,
                               const void* counts, const void* codes,
                               const void* starts, void* out, int L, int S,
                               int ksize, int mask, int min_count,
                               int n_probes, void* stream) {
  if (L < 0 || S < 0 || ksize < 1 || ksize > 31 || mask < 0 || n_probes < 0)
    return (int)cudaErrorInvalidValue;
  if (S == 0) return 0;
  const int threads = 256;
  cudaStream_t st = (cudaStream_t)stream;
  fill_kernel<<<(S + threads - 1) / threads, threads, 0, st>>>(
      (int*)out, S, INT_MAX);
  if (L > 0)
    kmer_score_kernel<<<(L + threads - 1) / threads, threads, 0, st>>>(
        (const int*)key_hi, (const int*)key_lo, (const int*)counts,
        (const uint8_t*)codes, (const int*)starts, (int*)out, L, S, ksize,
        (uint32_t)mask, min_count, n_probes);
  finish_kernel<<<(S + threads - 1) / threads, threads, 0, st>>>((int*)out,
                                                                 S);
  return (int)cudaGetLastError();
}
