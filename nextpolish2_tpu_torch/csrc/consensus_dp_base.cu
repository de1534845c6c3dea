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
// (has = 0, score NEG_INF), while the running pick reports a match. And its
// same-column pool is all K slots of the column, those from the query's own
// slot on at NEG_INF, where the running pick sees only the slots before it.
//
// Bound: by bytes (13 B per slot; a column holds one or two live slots, so
// the compare/select work stays far below the card's integer rate). What the
// kernel waits on is the column recurrence: W dependent steps per window in
// a chunk of 128-512 windows.
//
// Design: dp_common.cuh::dp_reduce_kernel without a slot bound, the mapping
// of consensus_dp.cu.
//  - lanes are slots: 8 lanes a window and 4 windows a warp at K = 8; one
//    warp a window, two slots a lane, at K = 48 and for any other K <= 64.
//    One warp per block, so a B = 512, K = 8 chunk is 128 blocks.
//  - the carry stays in the owning lane's registers, the per-window bit sets
//    are group ballots; no local memory.
//  - the _pick reduction runs lane-parallel in one ascending walk of the
//    pool slots that can match (dp_common.cuh::group_reduce): count of
//    matches, max, first maximal row and last non-gap maximal row, then the
//    NEG_INF-1 floor.
//  - key, cnt and cov arrive in tiles of 32 columns by cp.async, two tiles
//    ahead; the next column is decoded while the current one is picked;
//    scores and besti leave shared memory a tile at a time in 16-byte stores.
//  - columns (and whole tiles) that hold only the empty key -1 in every
//    window of the warp are found by a scan of the staged key tile and are
//    filled, not scored: on real chunks that is every column past the
//    windows' data.

#include "dp_common.cuh"

// key/cnt int32 [B,W,K], cov int32 [B,W], lead int32 [B], seed u8 [B]
// -> scores int32 [B,W,K], besti int8 [B,W,K]. Launches on `stream` and does
// not synchronise. Returns the launch's cudaGetLastError() (0 on success); K
// must be in 1..64.
extern "C" int np2t_consensus_dp_base(const void* key, const void* cnt,
                                      const void* cov, const void* lead,
                                      const void* seed, void* scores,
                                      void* besti, int B, int W, int K,
                                      void* stream) {
  return np2t::launch_reduce<false>(key, cnt, cov, nullptr, lead, seed, scores,
                                    besti, B, W, K, stream);
}
