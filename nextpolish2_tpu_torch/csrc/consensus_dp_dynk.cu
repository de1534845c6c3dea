// Windowed consensus Viterbi DP, dynamic-K formulation, for Hopper (sm_90a),
// plain C interface.
//
// Replaces the Pallas TPU kernel nextpolish2_tpu/ops/consensus_pallas.py::
// _dp_kernel_dynk: the base formulation (a _pick reduction per slot) whose
// per-column slot loop stops at the column's slot count n_slots instead of
// K. Slots from the bound on keep their init, scores NEG_INF and besti 0
// (the anchor seeding still applies to every valid slot, as in Pallas). The
// match targets and the carry to the next column cover all K slots. No span
// bound: all W columns are scanned.
//
// The Pallas kernel bounds a column by the LARGEST n_slots of its 128-lane
// tile; here each window is bounded by its own n_slots[b, c]. Scores are
// identical everywhere, and besti on every slot below the window's own
// bound; on invalid slots between the window's bound and the tile's, Pallas
// holds a pick and this kernel 0. The backtrack never follows an invalid
// slot (its key of -1 decodes to a head, which ends the walk). n_slots is
// taken as given: a column whose n_slots is smaller than its count of valid
// keys leaves the slots past it at NEG_INF.
//
// Design and bound: as consensus_dp_base.cu (dp_common.cuh::
// dp_reduce_window, one thread per window), with sum(min(n_slots, K)) slot
// steps instead of K per column, and one more int32 read per column.

#include "dp_common.cuh"

namespace {

template <int KT>
__global__ void __launch_bounds__(128)
dp_dynk_kernel(const int* __restrict__ key, const int* __restrict__ cnt,
               const int* __restrict__ cov, const int* __restrict__ n_slots,
               const int* __restrict__ lead, const uint8_t* __restrict__ seed,
               int* __restrict__ scores, int8_t* __restrict__ besti, int B,
               int W, int K) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  np2t::dp_reduce_window<KT>(key, cnt, cov, n_slots, lead, seed, scores,
                             besti, b, W, K);
}

}  // namespace

// key/cnt int32 [B,W,K], cov/n_slots int32 [B,W], lead int32 [B], seed u8
// [B] -> scores int32 [B,W,K], besti int8 [B,W,K]. Returns the launch's
// cudaGetLastError() (0 on success); K must be in 1..64.
extern "C" int np2t_consensus_dp_dynk(const void* key, const void* cnt,
                                      const void* cov, const void* n_slots,
                                      const void* lead, const void* seed,
                                      void* scores, void* besti, int B, int W,
                                      int K, void* stream) {
  return np2t::launch_by_k(
      dp_dynk_kernel<8>, dp_dynk_kernel<48>, dp_dynk_kernel<0>, B, W, K,
      stream, (const int*)key, (const int*)cnt, (const int*)cov,
      (const int*)n_slots, (const int*)lead, (const uint8_t*)seed,
      (int*)scores, (int8_t*)besti, B, W, K);
}
