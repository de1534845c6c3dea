// Stand-in for <cuda_runtime.h> in the CPU rehearsal of the DP kernels
// (warp_emu.cc, built with -DNP2T_EMULATE and this directory first on the
// include path): just what consensus_dp.cu, consensus_dp_base.cu,
// consensus_dp_dynk.cu and dp_common.cuh use. A block is one warp; its 32
// lanes run as fibers in lockstep, and every warp-wide intrinsic is a
// rendezvous: each lane deposits its value, all lanes switch once around,
// each reads what it needs, all switch around again. A lane that reaches a
// different intrinsic than the others, or ends while others still wait,
// aborts the run: on the card that is a hang or garbage.

#pragma once

#include <stdint.h>
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
enum Op { kShfl, kBallot, kOr, kMax, kSync };
int exchange(Op op, int value, int src);
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

// the runtime calls of the launchers: one device, every request granted
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline cudaError_t cudaGetDevice(int* dev) {
  *dev = 0;
  return cudaSuccess;
}
template <typename Kernel>
cudaError_t cudaFuncSetAttribute(Kernel, int, int) {
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

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
