// Batched k-mer count lookup in the device table for Hopper (sm_90a), plain
// C interface.
//
// Replaces the jitted XLA function nextpolish2_tpu/ops/kmer_table.py::
// lookup / lookup_jit: queries (q_hi, q_lo, q_slot) int32 [Q] against the
// table planes key_hi, key_lo, counts int32 [S] -> int32 [Q], the stored
// count, 0 where the key is absent or its count is below min_count. The
// stride comes from the query planes as in JAX: low 32 bits of
// (hash >> 10), forced odd, masked.
//
// Bound: by bytes, and those are random: 12 B of query planes and a 4 B
// result per query, streamed, plus a 32 B sector of key_hi and one of
// key_lo per probe, from anywhere in a table far larger than L2. XLA runs
// n_probes full gathers over Q; here each query is one thread that stops
// at its hit or at the first empty slot (exact, see kmer_common.cuh), so
// a present key costs its own chain and an absent one usually one or two
// probes at load 0.5.

#include "kmer_common.cuh"

namespace {

using namespace np2t_kmer;

__global__ void __launch_bounds__(256)
kmer_lookup_kernel(const int* __restrict__ key_hi,
                   const int* __restrict__ key_lo,
                   const int* __restrict__ counts,
                   const int* __restrict__ q_hi, const int* __restrict__ q_lo,
                   const int* __restrict__ q_slot, int* __restrict__ out,
                   int Q, uint32_t mask, int min_count, int n_probes) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Q) return;
  const int qh = q_hi[i], ql = q_lo[i];
  const uint32_t stride =
      ((((uint32_t)ql >> 10) | ((uint32_t)qh << 22)) | 1u) & mask;
  const int c = probe_table(key_hi, key_lo, counts, qh, ql,
                            (uint32_t)q_slot[i], stride, mask, n_probes);
  out[i] = c >= min_count ? c : 0;
}

}  // namespace

// mask = S - 1 (S a power of two)
extern "C" int np2t_kmer_lookup(const void* key_hi, const void* key_lo,
                                const void* counts, const void* q_hi,
                                const void* q_lo, const void* q_slot,
                                void* out, int Q, int mask, int min_count,
                                int n_probes, void* stream) {
  if (Q < 0 || mask < 0 || n_probes < 0) return (int)cudaErrorInvalidValue;
  if (Q == 0) return 0;
  const int threads = 256;
  kmer_lookup_kernel<<<(Q + threads - 1) / threads, threads, 0,
                       (cudaStream_t)stream>>>(
      (const int*)key_hi, (const int*)key_lo, (const int*)counts,
      (const int*)q_hi, (const int*)q_lo, (const int*)q_slot, (int*)out, Q,
      (uint32_t)mask, min_count, n_probes);
  return (int)cudaGetLastError();
}
