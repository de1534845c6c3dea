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
// Bound: by bytes, as consensus_dp_base.cu, with one more int32 read per
// column; in practice the W dependent column steps per window.
//
// Design: dp_common.cuh::dp_reduce_kernel with the slot bound, the mapping
// of consensus_dp.cu and consensus_dp_base.cu (lanes are slots, one warp per
// block, the carry in registers, 32-column tiles staged by cp.async two
// ahead, outputs flushed a tile at a time, all-empty columns filled and not
// scored). The bound is one more predicate on the lane that owns the slot:
// n_slots travels as a fourth tile beside cov, and the decode of a column
// clamps it to [0, K] and compares it with each lane's slot index.

#include "dp_common.cuh"

// key/cnt int32 [B,W,K], cov/n_slots int32 [B,W], lead int32 [B], seed u8
// [B] -> scores int32 [B,W,K], besti int8 [B,W,K]. Launches on `stream` and
// does not synchronise. Returns the launch's cudaGetLastError() (0 on
// success); K must be in 1..64.
extern "C" int np2t_consensus_dp_dynk(const void* key, const void* cnt,
                                      const void* cov, const void* n_slots,
                                      const void* lead, const void* seed,
                                      void* scores, void* besti, int B, int W,
                                      int K, void* stream) {
  return np2t::launch_reduce<true>(key, cnt, cov, n_slots, lead, seed, scores,
                                   besti, B, W, K, stream);
}
