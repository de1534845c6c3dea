// Windowed consensus Viterbi DP, base formulation, for Hopper (sm_90a),
// plain C interface.
//
// Replaces the Pallas TPU kernel nextpolish2_tpu/ops/consensus_pallas.py::
// _dp_kernel (the reference formulation: per slot, a _pick reduction over the
// predecessor pool). Outputs are bit-identical to it: scores and besti on
// every slot of every column, valid or not. It has no span bound: all W
// columns are scanned, and pad columns carry the state forward with
// all-invalid slots (scores NEG_INF, besti 0).
//
// It differs from the running pick of consensus_dp.cu where every matching
// predecessor scores below NEG_INF-1: the reduction floors the max at
// NEG_INF-1 through the non-matching rows and then finds no maximal match
// (has = 0, score NEG_INF), while the running pick reports a match.
//
// Design: dp_common.cuh::dp_reduce_window without a slot bound, one thread
// per window. Rows that cannot match are skipped through the valid-target
// bit mask (pick_reduce).
//
// Bound: by bytes (13 B per slot; a column holds one or two live slots, so
// the compare/select work stays far below the card's integer rate). In
// practice it waits on the per-thread column chain: a B=128 chunk is 4 warps
// of one SM. The slot-parallel mapping of consensus_dp.cu (dp_common.cuh)
// is the way out.

#include "dp_common.cuh"

namespace {

template <int KT>
__global__ void __launch_bounds__(128)
dp_base_kernel(const int* __restrict__ key, const int* __restrict__ cnt,
               const int* __restrict__ cov, const int* __restrict__ lead,
               const uint8_t* __restrict__ seed, int* __restrict__ scores,
               int8_t* __restrict__ besti, int B, int W, int K) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  np2t::dp_reduce_window<KT>(key, cnt, cov, nullptr, lead, seed, scores,
                             besti, b, W, K);
}

}  // namespace

// key/cnt int32 [B,W,K], cov int32 [B,W], lead int32 [B], seed u8 [B]
// -> scores int32 [B,W,K], besti int8 [B,W,K]. Returns the launch's
// cudaGetLastError() (0 on success); K must be in 1..64.
extern "C" int np2t_consensus_dp_base(const void* key, const void* cnt,
                                      const void* cov, const void* lead,
                                      const void* seed, void* scores,
                                      void* besti, int B, int W, int K,
                                      void* stream) {
  return np2t::launch_by_k(
      dp_base_kernel<8>, dp_base_kernel<48>, dp_base_kernel<0>, B, W, K,
      stream, (const int*)key, (const int*)cnt, (const int*)cov,
      (const int*)lead, (const uint8_t*)seed, (int*)scores, (int8_t*)besti,
      B, W, K);
}
