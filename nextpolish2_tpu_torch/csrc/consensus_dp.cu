// Windowed consensus Viterbi DP for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel nextpolish2_tpu/ops/consensus_pallas.py::
// _dp_kernel_v2 with span bounding (the "v2" running-pick formulation).
// Outputs are bit-identical to it on every column below a window's span;
// columns at or past the span hold NEG_INF / 0 (the Pallas kernel's memset
// values; the backtrack reads scores only at last_col = span - 1 and besti
// only along its walk, which never leaves columns <= last_col).
//
// Bound: by bytes (13 B per slot: key, cnt, scores, besti; a column holds
// one or two live slots, so the compare/select work is far below the
// card's integer rate). What the kernel actually waits on is neither: the
// column recurrence is sequential, span dependent steps per window, and a
// chunk holds only 128-512 windows. The design therefore shortens the
// dependent step and spreads the windows over the SMs.
//
// Design:
//  - lanes are slots. A group of lanes owns a window and a lane owns a slot:
//    8 lanes a window and 4 windows a warp at K = 8; one warp a window, two
//    slots a lane, at K = 48 and for any other K <= 64. One warp per block,
//    so a B = 512, K = 8 chunk is 128 blocks and a B = 128 chunk 32.
//  - the carry (previous column's score, b2 and b3 keys per slot) stays in
//    the owning lane's registers; the per-window bit sets (head, non-gap,
//    valid-target, same-column) are group ballots, and the loops' trip
//    counts come out of the same ballots without a further exchange. No
//    local memory.
//  - per column every lane is a query. The group walks the predecessor
//    slots that can match in ascending order, fetches slot j's (score, b2,
//    b3) by shuffle and applies the running pick literally
//        take = match & (cand > best || (cand == best && pred_nongap))
//    from best = NEG_INF-1, j = 0: strict max, ties prefer the last non-gap
//    predecessor, else the first maximum (main.rs:1670).
//  - slots with the same-column flag pick over EARLIER slots of this column
//    at their final scores (slots are ordered by b3-delta, so in-column
//    predecessors always come first: any insertion depth, no level cap). The
//    valid ones are resolved one after another in slot order; the invalid
//    ones (every empty slot carries the flag) cannot feed a later score and
//    take their besti from one lane-parallel pass afterwards, which a 32-bit
//    set of key bits skips whenever no such slot can match.
//  - key, cnt and cov arrive in tiles of 32 columns by cp.async, two tiles
//    ahead of the column being scored; the next column is decoded while the
//    current one is picked; scores and besti of a tile are collected in
//    shared memory and leave with 16-byte stores. No load or store of the
//    column chain touches device memory.
//  - the tile ring, the one-column decode and the tile flush are
//    dp_common.cuh's, shared with the base and dynamic-K kernels.
//  - every window stops at its own span; a warp runs to the largest span of
//    its windows with the finished groups masked, and the columns past a
//    span are filled with NEG_INF / 0 by all lanes of the group.

#include "dp_common.cuh"

namespace {

using namespace np2t;

template <int KT>
__global__ void __launch_bounds__(32)
dp_v2_kernel(const int* __restrict__ key, const int* __restrict__ cnt,
             const int* __restrict__ cov, const int* __restrict__ lead,
             const uint8_t* __restrict__ seed, const int* __restrict__ span,
             int* __restrict__ scores, int8_t* __restrict__ besti,
             int B, int W, int k_rt) {
  using Map = SlotMap<KT>;
  constexpr int G = Map::G, S = Map::S, NW = Map::NW;
  using Group = LaneGroup<G, S>;
  using mask_t = typename Group::mask_t;
  using Col = ColumnLanes<S, mask_t>;
  const int K = KT > 0 ? KT : k_rt;
  extern __shared__ int4 smem4[];

  const Group g(threadIdx.x);
  const int grp = threadIdx.x / G;
  const int b = blockIdx.x * NW + grp;
  const bool live = b < B;  // a warp's last groups may own no window
  const size_t bw = live ? (size_t)b * W : 0;
  const WindowTiles<G, NW, 1> tiles(reinterpret_cast<int*>(smem4), grp, K, W);
  int* const out_sc = tiles.out_sc;
  int8_t* const out_bi = tiles.out_bi;

  int sp = 0, lead_b = 0;
  bool seed_b = false;
  if (live) {
    sp = span[b];
    sp = sp < 0 ? 0 : (sp > W ? W : sp);
    lead_b = lead[b];
    seed_b = seed[b] != 0;
  }
  const int sp_max = (int)warp_max((unsigned)sp);
  const int n_tiles = (sp_max + kTile - 1) / kTile;

  int slot[S], lim_all[S];
  bool exists[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    slot[s] = g.rank + 32 * s;
    exists[s] = slot[s] < K;
    lim_all[s] = kMaxK;
  }
  const mask_t all_k = Group::low_bits(K);

  auto prefetch = [&](int t) {
    tiles.prefetch(t < n_tiles && t * kTile < sp, t, g.rank, key, cnt, cov,
                   nullptr, bw, W, K);
  };

  int p_sc[S], p_b2[S], p_b3[S];
  mask_t p_head = 0, p_nongap = 0, p_vmask = 0;
  unsigned p_n_vmask = 0;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    p_sc[s] = kNegInf;
    p_b2[s] = -7;
    p_b3[s] = -8;
  }

  for (int t = 0; t < kStages - 1; ++t) prefetch(t);
  for (int t = 0; t < n_tiles; ++t) {
    prefetch(t + kStages - 1);
    cp_async_wait<kStages - 1>();
    __syncwarp();
    const int c0 = t * kTile;
    const int* tile = tiles.stage(t);

    // the decode does not depend on the carry, so it runs one column ahead
    // of the pick
    auto decode = [&](int cc) {
      return decode_column_lanes<false>(g, tile, tiles.tk, cc, c0 + cc,
                                        c0 + cc < sp, K, slot, exists);
    };

    // columns that some window of the warp still scans
    const int ncol_w = min(kTile, sp_max - c0);
    Col cur = decode(0);
    for (int cc = 0; cc < ncol_w; ++cc) {
      const int c = c0 + cc;
      Col nxt = cur;
      if (cc + 1 < ncol_w) nxt = decode(cc + 1);

      const bool colge3 = lead_b + c >= 3;
      const mask_t pv_guard = colge3 ? p_head : 0;
      const mask_t cur_guard = colge3 ? cur.head : 0;
      int best[S], rj[S], c_sc[S], bi[S];
      bool has[S];
      auto reset_pick = [&]() {
#pragma unroll
        for (int s = 0; s < S; ++s) {
          best[s] = kNeg1;
          rj[s] = 0;
          has[s] = false;
        }
      };
      auto score = [&](int s) {
        return cur.b2head[s]
                   ? cur.gain[s]
                   : (has[s] ? wrap_add(best[s], cur.gain[s]) : kNegInf);
      };

      // previous-column pool: every slot without the same-column flag
      reset_pick();
      group_pick(g, cur.neg7 ? all_k : p_vmask, p_sc, p_b2, p_b3, pv_guard,
                 p_nongap, cur.b1, cur.b2, lim_all,
                 cur.neg7 ? (unsigned)K : p_n_vmask, best, rj, has);
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const bool prev_pool = cur.on[s] && !cur.same[s];
        c_sc[s] = (prev_pool && cur.valid[s]) ? score(s) : kNegInf;
        bi[s] = (prev_pool && has[s]) ? rj[s] : 0;
      }

      // same-column pool, valid slots: in slot order, each over the earlier
      // slots of this column at their final (unseeded) scores
      const unsigned cur_trips = cur.neg7 ? (unsigned)K : cur.n_vmask;
      mask_t todo_i = cur.same_valid;
      for (unsigned it = 0; it < cur.n_same_valid; ++it) {
        const bool live_i = todo_i != 0;
        const int i = live_i ? mask_ffs(todo_i) : 0;
        todo_i &= todo_i - 1;
        const mask_t pool = live_i ? ((cur.neg7 ? all_k : cur.vmask) &
                                      Group::low_bits(i))
                                   : 0;
        reset_pick();
        group_pick(g, pool, c_sc, cur.b2m, cur.b3m, cur_guard, cur.nongap,
                   cur.b1, cur.b2, lim_all, cur_trips, best, rj, has);
#pragma unroll
        for (int s = 0; s < S; ++s) {
          if (live_i && slot[s] == i) {
            c_sc[s] = score(s);
            bi[s] = has[s] ? rj[s] : 0;
          }
        }
      }

      // same-column pool, invalid slots: they score NEG_INF whatever they
      // pick, so only their besti is left, for all of them at once
      if (cur.invalid_same_work) {
        reset_pick();
        group_pick(g, cur.neg7 ? all_k : cur.vmask, c_sc, cur.b2m, cur.b3m,
                   cur_guard, cur.nongap, cur.b1, cur.b2, slot, cur_trips,
                   best, rj, has);
#pragma unroll
        for (int s = 0; s < S; ++s) {
          if (cur.same[s] && !cur.valid[s]) bi[s] = has[s] ? rj[s] : 0;
        }
      }

      const bool anchor = seed_b && c == 2;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int out = (anchor && cur.valid[s]) ? 0 : c_sc[s];
        if (exists[s]) {
          out_sc[cc * K + slot[s]] = out;
          out_bi[cc * K + slot[s]] = (int8_t)bi[s];
        }
        p_sc[s] = out;
        p_b2[s] = cur.b2m[s];
        p_b3[s] = cur.b3m[s];
      }
      p_head = cur.head;
      p_nongap = cur.nongap;
      p_vmask = cur.vmask;
      p_n_vmask = cur.n_vmask;
      cur = nxt;
    }

    // the tile's columns past every span of the warp, then the flush
    const int ncol = min(kTile, W - c0);
    for (int e = ncol_w * K + g.rank; e < ncol * K; e += G) {
      out_sc[e] = kNegInf;
      out_bi[e] = 0;
    }
    __syncwarp();
    if (live) tiles.flush(scores, besti, bw, c0, ncol, g.rank, K);
    // the next tile overwrites the output buffer, and the next prefetch the
    // stage this tile was read from
    __syncwarp();
  }
  cp_async_wait<0>();

  // columns past the warp's last tile
  const int c1 = min(W, n_tiles * kTile);
  if (live && c1 < W) {
    fill_words(scores + (bw + c1) * K, (W - c1) * K, kNegInf, g.rank, G,
               tiles.vec_w);
    fill_bytes(besti + (bw + c1) * K, (W - c1) * K, 0, g.rank, G,
               tiles.vec_b);
  }
}

template <int KT>
int launch_v2(const void* key, const void* cnt, const void* cov,
              const void* lead, const void* seed, const void* span,
              void* scores, void* besti, int B, int W, int K, void* stream) {
  constexpr int NW = SlotMap<KT>::NW;
  static SmemLimit limit;
  auto* kernel = dp_v2_kernel<KT>;
  // the runtime-K instance asks once for what its widest K needs
  const int rc = limit.raise(kernel, smem_bytes(KT > 0 ? KT : kMaxK, NW, 1));
  if (rc != 0) return rc;
  NP2T_LAUNCH_WARPS(kernel, (B + NW - 1) / NW, smem_bytes(K, NW, 1), stream,
                    (const int*)key, (const int*)cnt, (const int*)cov,
                    (const int*)lead, (const uint8_t*)seed, (const int*)span,
                    (int*)scores, (int8_t*)besti, B, W, K);
  return (int)cudaGetLastError();
}

}  // namespace

// key/cnt int32 [B,W,K], cov int32 [B,W], lead/span int32 [B], seed u8 [B]
// -> scores int32 [B,W,K], besti int8 [B,W,K]. Launches on `stream` and does
// not synchronise. Returns the launch's cudaGetLastError() (0 on success); K
// must be in 1..64.
extern "C" int np2t_consensus_dp(const void* key, const void* cnt,
                                 const void* cov, const void* lead,
                                 const void* seed, const void* span,
                                 void* scores, void* besti, int B, int W,
                                 int K, void* stream) {
  if (K < 1 || K > kMaxK || B < 0 || W < 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || W == 0) return 0;
  auto* launch = K == 8 ? launch_v2<8> : (K == 48 ? launch_v2<48> : launch_v2<0>);
  return launch(key, cnt, cov, lead, seed, span, scores, besti, B, W, K,
                stream);
}
