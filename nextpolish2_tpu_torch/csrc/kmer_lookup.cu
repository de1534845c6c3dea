// Batched k-mer count lookup in the device table for Hopper (sm_90a), plain
// C interface.
//
// Replaces the jitted XLA function nextpolish2_tpu/ops/kmer_table.py::
// lookup / lookup_jit: queries (q_hi, q_lo, q_slot) int32 [Q] against the
// table's 16-byte slot entries int32 [S, 4] (kmer_common.cuh) -> int32 [Q],
// the stored count, 0 where the key is absent or its count is below
// min_count. The stride comes from the query planes as in JAX: low 32 bits
// of (hash >> 10), forced odd, masked.
//
// Bound: by bytes, and those are random: 12 B of query planes and a 4 B
// result per query, streamed, plus one 32 B sector per probe, from anywhere
// in a table far larger than L2. XLA runs n_probes full gathers over Q;
// here a query stops at its hit or at the first empty slot (exact, see
// kmer_common.cuh), and a probe is one 16-byte load that brings key and
// count together. The pace is set by how many random sectors are in flight:
// each thread walks kChains queries' chains at once (their loads issued
// before any is waited on), and a persistent grid of the card's resident
// blocks strides over the queries, so a long chain holds one thread's
// slot, not a whole block's tail.
//
// The sharded lookup (np2t_kmer_lookup_sharded) replaces the jitted XLA
// function nextpolish2_tpu/parallel/sharded_kmer.py::make_sharded_lookup,
// one launch per position of the mesh's 'kmer' axis: the same walk on one
// shard's entries, where q_shard (int32 [Q], (hash >> 21) % n_shards) names
// the shard that owns each query. A query of another shard writes 0 without
// a probe, so a position walks about 1/n_shards of the chains (the JAX body
// probes every query and masks afterwards); the positions' outputs are
// disjoint, and their sum is the JAX psum. Stopping at the first empty slot
// stays exact: each shard was packed by the same rounds (kmer_common.cuh).

#include "kmer_common.cuh"

namespace {

using namespace np2t_kmer;

constexpr int kChains = 4;  // queries a thread walks at once

// kSharded: only the queries whose q_shard equals `shard` are probed; the
// others write 0
template <bool kSharded>
__global__ void __launch_bounds__(kThreads)
kmer_lookup_kernel(const int4* __restrict__ tab,
                   const int* __restrict__ q_hi, const int* __restrict__ q_lo,
                   const int* __restrict__ q_slot,
                   const int* __restrict__ q_shard, int shard,
                   int* __restrict__ out, int Q, uint32_t mask, int min_count,
                   int n_probes) {
  // thread t of T takes queries r*T*kChains + g*T + t (g < kChains) in
  // round r: neighbouring threads read and write neighbouring queries
  const long long T = (long long)gridDim.x * blockDim.x;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long base = t; base < Q; base += T * kChains) {
    int qh[kChains], ql[kChains], count[kChains];
    uint32_t idx[kChains], stride[kChains];
    bool live[kChains];
#pragma unroll
    for (int g = 0; g < kChains; ++g) {
      const long long i = base + g * T;
      live[g] = i < Q && n_probes > 0;
      if (kSharded) live[g] = live[g] && q_shard[i] == shard;
      qh[g] = i < Q ? q_hi[i] : 0;
      ql[g] = i < Q ? q_lo[i] : 0;
      idx[g] = (i < Q ? (uint32_t)q_slot[i] : 0u) & mask;
      stride[g] =
          ((((uint32_t)ql[g] >> 10) | ((uint32_t)qh[g] << 22)) | 1u) & mask;
    }
    // a chain that is not live is not probed, and counts 0
    probe_chains<kChains>(tab, qh, ql, idx, stride, live, count, mask,
                          n_probes);
#pragma unroll
    for (int g = 0; g < kChains; ++g) {
      const long long i = base + g * T;
      if (i < Q) out[i] = count[g] >= min_count ? count[g] : 0;
    }
  }
}

template <bool kSharded>
int launch_lookup(const void* entries, const void* q_hi, const void* q_lo,
                  const void* q_slot, const void* q_shard, int shard,
                  void* out, int Q, int mask, int min_count, int n_probes,
                  void* stream) {
  if (Q < 0 || mask < 0 || n_probes < 0 || shard < 0 ||
      ((uintptr_t)entries & 15) != 0)
    return (int)cudaErrorInvalidValue;
  if (Q == 0) return 0;
  static const int resident = resident_blocks(kmer_lookup_kernel<kSharded>);
  NP2T_KMER_LAUNCH(kmer_lookup_kernel<kSharded>,
                   persistent_blocks(Q, (long long)kThreads * kChains,
                                     resident),
                   stream, (const int4*)entries, (const int*)q_hi,
                   (const int*)q_lo, (const int*)q_slot, (const int*)q_shard,
                   shard, (int*)out, Q, (uint32_t)mask, min_count, n_probes);
  return (int)cudaGetLastError();
}

}  // namespace

// entries: int32 [S, 4], 16-byte aligned; mask = S - 1 (S a power of two)
extern "C" int np2t_kmer_lookup(const void* entries, const void* q_hi,
                                const void* q_lo, const void* q_slot,
                                void* out, int Q, int mask, int min_count,
                                int n_probes, void* stream) {
  return launch_lookup<false>(entries, q_hi, q_lo, q_slot, nullptr, 0, out,
                              Q, mask, min_count, n_probes, stream);
}

// one shard's entries (int32 [S, 4], as above) and the index of that shard;
// q_shard: int32 [Q]
extern "C" int np2t_kmer_lookup_sharded(const void* entries, const void* q_hi,
                                        const void* q_lo, const void* q_slot,
                                        const void* q_shard, void* out, int Q,
                                        int mask, int min_count, int n_probes,
                                        int shard, void* stream) {
  return launch_lookup<true>(entries, q_hi, q_lo, q_slot, q_shard, shard,
                             out, Q, mask, min_count, n_probes, stream);
}
