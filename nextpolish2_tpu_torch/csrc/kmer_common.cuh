// Shared pieces of the k-mer table kernels (kmer_lookup.cu, kmer_score.cu):
// the slot entry of the device table, the open-addressing probe with several
// chains in flight, the yak hash, and the launch geometry.
//
// Table layout (nextpolish2_tpu_torch/ops/kmer_table.py::DeviceKmerTable):
// one int32 [S, 4] tensor of 16-byte slot entries {key_hi, key_lo, count,
// 0}, S a power of two, key_hi = hash >> 32, key_lo = hash & 0xFFFFFFFF
// (bit-cast). Its columns are bit for bit the three planes of the JAX
// package's ops/kmer_table.py build. An empty slot holds the key
// 0xFFFFFFFF_FFFFFFFE and count 0. A probe is one 16-byte load, so the key
// and its count come from one 32 B sector. A key's probe i lands on
//     (slot + i * stride) & (S - 1),
//     slot   = ((hash >> 10) ^ (hash << 7)) & (S - 1),
//     stride = (low 32 bits of (hash >> 10) | 1) & (S - 1),
// for i below n_probes, the longest chain the build used.
//
// Stopping at the first EMPTY slot is exact. The build (_try_pack) places
// keys in rounds: in round r every pending key looks at its probe-r slot;
// where that slot is free, the first pending key that wants it takes it.
// So when a key is placed in round r, each of its slots of rounds 0..r-1
// was occupied by the end of that round (it was taken before, or another
// key won it), and a slot once occupied stays so. No empty slot precedes
// a stored key on its probe chain: a lookup that meets one before the key
// has no key to find. (A query equal to the empty sentinel itself matches
// the empty slot first, count 0, as the JAX lookup gives.)

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace np2t_kmer {

constexpr int kEmptyHi = -1;  // 0xFFFFFFFF
constexpr int kEmptyLo = -2;  // 0xFFFFFFFE
// threads a block: one warp, so that a small batch spreads over the SMs
// (an SM holds 32 such blocks; registers, not blocks, bound residency)
constexpr int kThreads = 32;

// G independent probe chains, walked together: in each round every chain
// still live issues its 16-byte load before any result is looked at, so G
// random sectors are in flight per thread. On return count[g] holds the
// stored count of key (qh[g], ql[g]), 0 when absent; chains with live[g]
// false on entry are not probed and get 0.
template <int G>
__device__ __forceinline__ void probe_chains(const int4* __restrict__ tab,
                                             const int (&qh)[G],
                                             const int (&ql)[G],
                                             uint32_t (&idx)[G],
                                             const uint32_t (&stride)[G],
                                             bool (&live)[G], int (&count)[G],
                                             uint32_t mask, int n_probes) {
#pragma unroll
  for (int g = 0; g < G; ++g) count[g] = 0;
  for (int p = 0; p < n_probes; ++p) {
    int4 e[G];
#pragma unroll
    for (int g = 0; g < G; ++g)
      if (live[g]) e[g] = __ldg(tab + idx[g]);
    bool any = false;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (!live[g]) continue;
      if (e[g].x == qh[g] && e[g].y == ql[g]) {
        count[g] = e[g].z;
        live[g] = false;
      } else if (e[g].x == kEmptyHi && e[g].y == kEmptyLo) {
        live[g] = false;
      } else {
        idx[g] = (idx[g] + stride[g]) & mask;
      }
      any |= live[g];
    }
    if (!any) break;
  }
}

// yak_hash64(key, mask) (io/yak.py; reference kmer.rs:223-233) in native
// 64-bit arithmetic: unsigned, so shifts are logical and sums wrap
__device__ __forceinline__ uint64_t yak_hash64(uint64_t key, uint64_t mask) {
  key = (~key + (key << 21)) & mask;
  key = key ^ (key >> 24);
  key = ((key + (key << 3)) + (key << 8)) & mask;
  key = key ^ (key >> 14);
  key = ((key + (key << 2)) + (key << 4)) & mask;
  key = key ^ (key >> 28);
  key = (key + (key << 31)) & mask;
  return key;
}

// The blocks of `kernel` the card holds at once (SMs times the blocks an
// SM holds at kThreads threads), asked once per kernel by its launcher.
template <typename Kernel>
inline int resident_blocks(Kernel kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  return (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
}

// A persistent grid: enough blocks for `work` items of `per_block` each,
// at most `resident`, so that each block strides over the rest.
inline int persistent_blocks(long long work, long long per_block,
                             int resident) {
  const long long need = (work + per_block - 1) / per_block;
  return (int)(need < resident ? (need > 0 ? need : 1) : resident);
}

}  // namespace np2t_kmer

#ifdef NP2T_EMULATE
// the CPU rehearsal (csrc/emu/) runs blocks of one warp; the kernels use
// only global warp and lane numbers, so they would not tell larger blocks
// apart either
#define NP2T_KMER_LAUNCH(kernel, blocks, stream, ...)                 \
  NP2T_LAUNCH_WARPS(kernel, (blocks) * (np2t_kmer::kThreads / 32), 0, \
                    stream, __VA_ARGS__)
#else
#define NP2T_KMER_LAUNCH(kernel, blocks, stream, ...)            \
  kernel<<<(blocks), np2t_kmer::kThreads, 0, (cudaStream_t)(stream)>>>( \
      __VA_ARGS__)
#endif
