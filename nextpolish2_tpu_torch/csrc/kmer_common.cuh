// Shared pieces of the k-mer table kernels (kmer_lookup.cu, kmer_score.cu):
// the open-addressing probe of the device table and the yak hash.
//
// Table layout (nextpolish2_tpu_torch/ops/kmer_table.py::DeviceKmerTable,
// bit for bit the JAX package's ops/kmer_table.py build): three int32
// planes of a power-of-two size S, key_hi = hash >> 32, key_lo = hash &
// 0xFFFFFFFF (bit-cast), counts. An empty slot holds the key
// 0xFFFFFFFF_FFFFFFFE. A key's probe i lands on
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

// count of the key (qh, ql) whose chain starts at `slot` with `stride`, 0
// when absent; *probes gets the number of slots read
__device__ __forceinline__ int probe_table(const int* __restrict__ key_hi,
                                           const int* __restrict__ key_lo,
                                           const int* __restrict__ counts,
                                           int qh, int ql, uint32_t slot,
                                           uint32_t stride, uint32_t mask,
                                           int n_probes) {
  uint32_t idx = slot & mask;
  for (int p = 0; p < n_probes; ++p) {
    const int kh = __ldg(key_hi + idx);
    const int kl = __ldg(key_lo + idx);
    if (kh == qh && kl == ql) return __ldg(counts + idx);
    if (kh == kEmptyHi && kl == kEmptyLo) return 0;
    idx = (idx + stride) & mask;
  }
  return 0;
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

}  // namespace np2t_kmer
