// Stand-in for <cuda_runtime.h> in the CPU rehearsal of the kernels
// (warp_emu.cc, built with -DNP2T_EMULATE and this directory first on the
// include path): just what consensus_dp.cu, consensus_dp_base.cu,
// consensus_dp_dynk.cu, dp_common.cuh, kmer_lookup.cu, kmer_score.cu and
// kmer_common.cuh use. A block is one warp; its 32 lanes run as fibers in
// lockstep, and every warp-wide intrinsic is a rendezvous: each lane
// deposits its value, all lanes switch once around, each reads what it
// needs, all switch around again. A lane that reaches a different intrinsic
// than the others, or ends while others still wait, aborts the run: on the
// card that is a hang or garbage. Blocks run one after another, so atomics
// are plain read-modify-writes and __threadfence is empty. The card has
// NP2T_EMU_SMS streaming multiprocessors (default 1) of one resident block
// each, so the persistent k-mer kernels stride over their work.

#pragma once

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#include <algorithm>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__
#define __launch_bounds__(x)

struct int4 {
  int x, y, z, w;
} __attribute__((aligned(16)));
inline int4 make_int4(int x, int y, int z, int w) { return {x, y, z, w}; }

namespace np2t_emu {
extern int lane;   // the running fiber
extern int block;  // the running block
extern int grid;   // the blocks of the running launch
extern const int warp_size;
enum Op { kShfl, kBallot, kOr, kMax, kSync, kMatch, kMin };
// kMin: the unsigned minimum over the lanes of `mask`
int exchange(Op op, int value, int src, unsigned mask = 0xFFFFFFFFu);
void run_blocks(int blocks, void (*body)(void*), void* arg);
struct Index {
  const int& ref;
  operator int() const { return ref; }
};
struct Dim {
  Index x;
};
}  // namespace np2t_emu

static const np2t_emu::Dim threadIdx{{np2t_emu::lane}};
static const np2t_emu::Dim blockIdx{{np2t_emu::block}};
static const np2t_emu::Dim blockDim{{np2t_emu::warp_size}};
static const np2t_emu::Dim gridDim{{np2t_emu::grid}};

using std::max;
using std::min;
inline int __ffs(int v) { return v ? __builtin_ctz((unsigned)v) + 1 : 0; }
inline int __ffsll(long long v) {
  return v ? __builtin_ctzll((unsigned long long)v) + 1 : 0;
}
inline int __popc(unsigned v) { return __builtin_popcount(v); }
inline int __shfl_sync(unsigned, int v, int src) {
  return np2t_emu::exchange(np2t_emu::kShfl, v, src);
}
inline unsigned __ballot_sync(unsigned, bool p) {
  return (unsigned)np2t_emu::exchange(np2t_emu::kBallot, p, 0);
}
inline bool __any_sync(unsigned, bool p) {
  return np2t_emu::exchange(np2t_emu::kBallot, p, 0) != 0;
}
inline unsigned __reduce_or_sync(unsigned, unsigned v) {
  return (unsigned)np2t_emu::exchange(np2t_emu::kOr, (int)v, 0);
}
inline unsigned __reduce_max_sync(unsigned, unsigned v) {
  return (unsigned)np2t_emu::exchange(np2t_emu::kMax, (int)v, 0);
}
inline void __syncwarp() { np2t_emu::exchange(np2t_emu::kSync, 0, 0); }
inline unsigned __match_any_sync(unsigned, int v) {
  return (unsigned)np2t_emu::exchange(np2t_emu::kMatch, v, 0);
}
inline unsigned __reduce_min_sync(unsigned mask, unsigned v) {
  return (unsigned)np2t_emu::exchange(np2t_emu::kMin, (int)v, 0, mask);
}
inline int __clz(int v) { return v ? __builtin_clz((unsigned)v) : 32; }
template <typename T>
inline T __ldg(const T* p) {
  return *p;
}
template <typename T>
inline T __ldcg(const T* p) {
  return *p;
}
inline unsigned atomicMin(unsigned* p, unsigned v) {
  const unsigned old = *p;
  *p = std::min(old, v);
  return old;
}
inline unsigned atomicAdd(unsigned* p, unsigned v) {
  const unsigned old = *p;
  *p = old + v;
  return old;
}
inline void __threadfence() {}

// the runtime calls of the launchers: one device, every request granted
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum { cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaGetDevice(int* dev) {
  *dev = 0;
  return cudaSuccess;
}
template <typename Kernel>
cudaError_t cudaFuncSetAttribute(Kernel, int, int) {
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* value, int, int) {
  const char* env = getenv("NP2T_EMU_SMS");
  *value = env ? atoi(env) : 1;
  return cudaSuccess;
}
template <typename Kernel>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, Kernel, int,
                                                          size_t) {
  *n = 1;
  return cudaSuccess;
}
inline cudaError_t cudaMemsetAsync(void* p, int value, size_t n,
                                   cudaStream_t) {
  memset(p, value, n);
  return cudaSuccess;
}

// a launch runs the blocks one after another, each as 32 lockstep fibers
#define NP2T_LAUNCH_WARPS(kernel, blocks, smem, stream, ...)               \
  do {                                                                     \
    auto body = [&]() { kernel(__VA_ARGS__); };                            \
    np2t_emu::run_blocks(                                                  \
        (blocks), [](void* f) { (*static_cast<decltype(body)*>(f))(); },   \
        &body);                                                            \
  } while (0)

// cp.async: the copy happens at once, so commit and wait are empty
namespace np2t {
inline void cp_async_16(void* smem, const void* gmem) { memcpy(smem, gmem, 16); }
inline void cp_async_4(void* smem, const void* gmem) { memcpy(smem, gmem, 4); }
inline void cp_async_commit() {}
template <int N>
inline void cp_async_wait() {}
}  // namespace np2t
