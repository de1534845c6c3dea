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
//  - every window stops at its own span; a warp runs to the largest span of
//    its windows with the finished groups masked, and the columns past a
//    span are filled with NEG_INF / 0 by all lanes of the group.

#include "dp_common.cuh"

namespace {

using namespace np2t;

constexpr int kTile = 32;   // columns per staged tile; a multiple of 16, so
                            // every tile starts 16-byte aligned when the
                            // window's row does
constexpr int kStages = 3;  // tiles in flight
constexpr int kPad = 8;     // words between the buffers of a warp's windows:
                            // 4 groups reading slot s of their column then
                            // hit 4 different sets of banks

template <int KT>
struct V2Map {
  static constexpr int G = KT == 8 ? 8 : 32;  // lanes per window
  static constexpr int S = KT == 8 ? 1 : 2;   // slots per lane
  static constexpr int NW = 32 / G;           // windows per warp
};

// shared-memory layout per window, in words (besti: bytes)
__host__ __device__ constexpr int in_stride(int K) {
  return 2 * kTile * K + kTile + kPad;  // key tile, cnt tile, cov tile
}
__host__ __device__ constexpr int sc_stride(int K) { return kTile * K + kPad; }
__host__ __device__ constexpr int bi_stride(int K) {
  return kTile * K + 4 * kPad;
}
__host__ __device__ constexpr size_t smem_bytes(int K, int NW) {
  return 4 * (size_t)NW * (kStages * in_stride(K) + sc_stride(K)) +
         (size_t)NW * bi_stride(K);
}

// One column as the lanes of a group hold it: each lane its slots' keys,
// gain and predicates, every lane the group's bit sets.
template <int S, typename mask_t>
struct ColumnLanes {
  int b1[S], b2[S], b2m[S], b3m[S], gain[S];
  bool on[S];      // the slot exists and its column lies below the span
  bool valid[S];   // on, and key >= 0
  bool same[S];    // on, and the key carries the same-column flag
  bool b2head[S];
  mask_t head, nongap, vmask;
  mask_t same_valid;       // same-column slots that can score
  // warp-wide:
  bool neg7;               // some query is -7: pools widen to all K slots
  bool invalid_same_work;  // an invalid same-column slot may match a target
  unsigned n_vmask;        // largest count of vmask slots of a group
  unsigned n_same_valid;   // largest count of same_valid slots of a group
};

template <int KT>
__global__ void __launch_bounds__(32)
dp_v2_kernel(const int* __restrict__ key, const int* __restrict__ cnt,
             const int* __restrict__ cov, const int* __restrict__ lead,
             const uint8_t* __restrict__ seed, const int* __restrict__ span,
             int* __restrict__ scores, int8_t* __restrict__ besti,
             int B, int W, int k_rt) {
  using Map = V2Map<KT>;
  constexpr int G = Map::G, S = Map::S, NW = Map::NW;
  using Group = LaneGroup<G, S>;
  using mask_t = typename Group::mask_t;
  using Col = ColumnLanes<S, mask_t>;
  const int K = KT > 0 ? KT : k_rt;
  extern __shared__ int4 smem4[];
  int* const smem = reinterpret_cast<int*>(smem4);

  const Group g(threadIdx.x);
  const int grp = threadIdx.x / G;
  const int b = blockIdx.x * NW + grp;
  const bool live = b < B;  // a warp's last groups may own no window
  const size_t bw = live ? (size_t)b * W : 0;
  const int tk = kTile * K;
  const int stage_stride = NW * in_stride(K);
  int* const in_g = smem + grp * in_stride(K);
  int* const out_sc = smem + kStages * stage_stride + grp * sc_stride(K);
  int8_t* const out_bi =
      reinterpret_cast<int8_t*>(smem + kStages * stage_stride +
                                NW * sc_stride(K)) +
      grp * bi_stride(K);
  // 16-byte pieces need every window's row to start 16-byte aligned
  const bool vec_w = ((size_t)W * K) % 4 == 0;   // key, cnt, scores
  const bool vec_c = W % 4 == 0;                 // cov
  const bool vec_b = ((size_t)W * K) % 16 == 0;  // besti

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

  // tile t of this group's window -> stage t % kStages; every lane commits
  // one (possibly empty) group per call, so the wait counts stay uniform
  auto prefetch = [&](int t) {
    const int c0 = t * kTile;
    if (t < n_tiles && c0 < sp) {
      const int ncol = min(kTile, W - c0);
      int* dst = in_g + (t % kStages) * stage_stride;
      stage_words(dst, key + (bw + c0) * K, ncol * K, g.rank, G, vec_w);
      stage_words(dst + tk, cnt + (bw + c0) * K, ncol * K, g.rank, G, vec_w);
      stage_words(dst + 2 * tk, cov + bw + c0, ncol, g.rank, G, vec_c);
    }
    cp_async_commit();
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
    const int* key_s = in_g + (t % kStages) * stage_stride;
    const int* cnt_s = key_s + tk;
    const int* cov_s = key_s + 2 * tk;

    // decode column c0 + cc from the staged tile; it does not depend on the
    // carry, so it runs one column ahead of the pick
    auto decode = [&](int cc) {
      Col d;
      const int c = c0 + cc;
      const bool act = c < sp;
      const int cv = act ? cov_s[cc] : 0;
      bool head[S], nongap[S], vbit[S], sv[S];
      bool n7 = false, inv = false;
      unsigned targets = 0, queries = 0;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const bool on = act && exists[s];
        int k = -1, n = 0;
        if (on) {
          k = key_s[cc * K + slot[s]];
          n = cnt_s[cc * K + slot[s]];
        }
        const SlotDecode sd = decode_slot(k, c);
        d.b1[s] = sd.b1;
        d.b2[s] = sd.b2;
        d.b2m[s] = on ? sd.b2m : -7;
        d.b3m[s] = on ? sd.b3m : -8;
        d.gain[s] = 10 * n - 4 * cv;
        d.on[s] = on;
        d.valid[s] = on && sd.valid;
        d.same[s] = on && sd.same;
        d.b2head[s] = sd.b2head;
        head[s] = on && sd.head;
        nongap[s] = on && sd.nongap;
        vbit[s] = on && sd.vbit;
        sv[s] = d.valid[s] && d.same[s];
        n7 = n7 || (on && sd.b1 == -7);
        // an invalid same-column slot can only match a target whose b2 key
        // shares its b1 key's bits: 5 of them, one bit of a 32-bit set, tell
        // whether the besti pass can find anything (an empty slot's delta
        // field is 0xFFFF, a target's is an insertion depth)
        if (vbit[s]) targets |= 1u << ((sd.b2m >> 4) & 31);
        if (d.same[s] && !d.valid[s]) {
          inv = true;
          queries |= 1u << ((sd.b1 >> 4) & 31);
        }
      }
      unsigned raw[S];
      Group::ballots(head, raw);
      d.head = g.mask_of(raw);
      Group::ballots(nongap, raw);
      d.nongap = g.mask_of(raw);
      Group::ballots(sv, raw);
      d.same_valid = g.mask_of(raw);
      d.n_same_valid = Group::widest(raw);
      Group::ballots(vbit, raw);
      d.vmask = g.mask_of(raw);
      d.n_vmask = Group::widest(raw);
      // b1 == -7 needs a b1 column of -1 mod 2^14: columns 0 and 1, or far
      // beyond any chunk's width
      d.neg7 = ((c + 1) & 0x3FFF) <= 2 && __any_sync(kFullMask, n7);
      targets = __reduce_or_sync(kFullMask, targets);
      d.invalid_same_work =
          __any_sync(kFullMask, inv && (d.neg7 || (targets & queries) != 0));
      return d;
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
    if (live) {
      flush_words(scores + (bw + c0) * K, out_sc, ncol * K, g.rank, G, vec_w);
      flush_bytes(besti + (bw + c0) * K, out_bi, ncol * K, g.rank, G, vec_b);
    }
    // the next tile overwrites the output buffer, and the next prefetch the
    // stage this tile was read from
    __syncwarp();
  }
  cp_async_wait<0>();

  // columns past the warp's last tile
  const int c1 = min(W, n_tiles * kTile);
  if (live && c1 < W) {
    fill_words(scores + (bw + c1) * K, (W - c1) * K, kNegInf, g.rank, G,
               vec_w);
    fill_bytes(besti + (bw + c1) * K, (W - c1) * K, 0, g.rank, G, vec_b);
  }
}

template <int KT>
int launch_v2(const void* key, const void* cnt, const void* cov,
              const void* lead, const void* seed, const void* span,
              void* scores, void* besti, int B, int W, int K, void* stream) {
  constexpr int NW = V2Map<KT>::NW;
  static SmemLimit limit;
  const size_t smem = smem_bytes(K, NW);
  // the runtime-K instance asks once for what its widest K needs
  const int rc = limit.raise(dp_v2_kernel<KT>,
                             smem_bytes(KT > 0 ? KT : kMaxK, NW));
  if (rc != 0) return rc;
  dp_v2_kernel<KT><<<(B + NW - 1) / NW, 32, smem, (cudaStream_t)stream>>>(
      (const int*)key, (const int*)cnt, (const int*)cov, (const int*)lead,
      (const uint8_t*)seed, (const int*)span, (int*)scores, (int8_t*)besti, B,
      W, K);
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
