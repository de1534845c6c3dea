// Shared pieces of the consensus kernels (consensus_dp.cu,
// consensus_dp_base.cu, consensus_dp_dynk.cu, backtrack.cu): constants, the
// int32 key packing of nextpolish2_tpu/ops/consensus_pallas.py::_decode_tile
// and its one-slot decode; the slot-parallel mapping (a group of lanes owns a
// window, a lane owns a slot: group ballots, slot fetches by shuffle, the
// running pick and the _pick reduction over a pool of predecessor slots);
// asynchronous tile staging into shared memory, the one-column decode out of
// a staged tile and the wide output flush and fill; and the column scan of
// the base and dynamic-K formulations, which their two sources instantiate.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace np2t {

constexpr int kNegInf = -(1 << 30);
constexpr int kNeg1 = kNegInf - 1;
constexpr int kHeadQ = 15;
constexpr int kMaxK = 64;  // slot sets travel as uint64 bit masks

__device__ __forceinline__ int pack_bkey(int t, int d, int q) {
  return (int)(((unsigned)t << 18) | ((unsigned)d << 4) | (unsigned)q);
}

// JAX int32 addition wraps; signed overflow in C++ is undefined
__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

// One slot of one column, decoded: the query keys (b1, b2), the match
// targets (b2m, b3m: -7 / -8 on an invalid slot, so it never matches a valid
// query) and the slot's predicates.
struct SlotDecode {
  int b1, b2, b2m, b3m;
  bool head;     // q1 == HEAD_Q (b1 is the head marker)
  bool nongap;   // q1 != 4
  bool vbit;     // b2m != -7: the slot can match a query other than -7
  bool same;     // flag bit 0: the predecessor pool is this column
  bool valid;    // key >= 0
  bool b2head;   // q2 == HEAD_Q
};

__device__ __forceinline__ SlotDecode decode_slot(int k, int c) {
  const int flags = (k >> 12) & 0xF;
  const int delta = (k >> 16) & 0xFFFF;
  const int q1 = (k >> 8) & 0xF;
  const int q2 = (k >> 4) & 0xF;
  const int q3 = k & 0xF;
  const bool both = (flags & 0b0101) == 0b0101;
  const bool f23 = (flags & 0b0001) != 0;
  const bool f12 = (flags & 0b0100) != 0;
  const int b1_t = both ? c : ((f23 || f12) ? c - 1 : c - 2);
  const int b2_t = (both || f23) ? c : c - 1;
  const int b2_d = both ? delta + 1 : (f23 ? 0 : (f12 ? delta + 1 : 0));
  const int b3d = both ? delta + 2 : (f23 ? 1 : 0);
  SlotDecode d;
  d.valid = k >= 0;
  d.b1 = pack_bkey(b1_t, delta, q1);
  d.b2 = pack_bkey(b2_t, b2_d, q2);
  d.b2m = d.valid ? d.b2 : -7;
  d.b3m = d.valid ? pack_bkey(c, b3d, q3) : -8;
  d.head = q1 == kHeadQ;
  d.nongap = q1 != 4;
  d.vbit = d.b2m != -7;
  d.same = f23;
  d.b2head = q2 == kHeadQ;
  return d;
}

// ---------------------------------------------------------------------------
// The slot-parallel mapping: a group of G lanes of one warp owns one window
// and each lane owns S slots (slot = rank + 32 * s), so a column's K <= G * S
// slots are decoded, matched and scored by K lanes at once and the previous
// column's carry never leaves registers. Every function here is called by
// all 32 lanes of the warp together (full-mask shuffles and ballots): loops
// run to the warp's largest trip count with finished groups masked.

constexpr unsigned kFullMask = 0xFFFFFFFFu;

template <int S> struct SlotMask { using type = uint64_t; };
template <> struct SlotMask<1> { using type = uint32_t; };

__device__ __forceinline__ int mask_ffs(uint32_t m) { return __ffs((int)m) - 1; }
__device__ __forceinline__ int mask_ffs(uint64_t m) {
  return __ffsll((long long)m) - 1;
}

template <int G, int S>
struct LaneGroup {
  static_assert(S == 1 || G == 32, "two slots a lane only with a whole warp");
  using mask_t = typename SlotMask<S>::type;
  int base;  // the group's first lane
  int rank;  // this lane within the group: it owns slots rank + 32 * s

  __device__ __forceinline__ explicit LaneGroup(int lane)
      : base(lane / G * G), rank(lane % G) {}

  __device__ __forceinline__ static mask_t low_bits(int n) {
    return n >= (int)(8 * sizeof(mask_t)) ? ~(mask_t)0
                                          : (((mask_t)1 << n) - 1);
  }

  // p[s] of every lane of the warp, one ballot per slot index s
  __device__ __forceinline__ static void ballots(const bool (&p)[S],
                                                 unsigned (&raw)[S]) {
#pragma unroll
    for (int s = 0; s < S; ++s) raw[s] = __ballot_sync(kFullMask, p[s]);
  }

  // one bit per slot of this group's window, out of the warp's ballots
  __device__ __forceinline__ mask_t mask_of(const unsigned (&raw)[S]) const {
    if constexpr (S == 2) {
      return ((uint64_t)raw[1] << 32) | raw[0];
    } else if constexpr (G == 32) {
      return raw[0];
    } else {
      return (raw[0] >> base) & ((1u << G) - 1);
    }
  }

  // the largest count of set slots any group of the warp has in these
  // ballots: a trip count that needs no further exchange
  __device__ __forceinline__ static unsigned widest(const unsigned (&raw)[S]) {
    if constexpr (G == 32) {
      unsigned n = 0;
#pragma unroll
      for (int s = 0; s < S; ++s) n += __popc(raw[s]);
      return n;
    } else {
      unsigned n = 0;
#pragma unroll
      for (int w = 0; w < 32 / G; ++w)
        n = max(n, (unsigned)__popc((raw[0] >> (w * G)) & ((1u << G) - 1)));
      return n;
    }
  }

  // slot j's value from the lane of this group that owns it (j is uniform
  // within the group)
  __device__ __forceinline__ int fetch(const int (&v)[S], int j) const {
    int mine = v[0];
    if constexpr (S == 2) mine = (j >> 5) ? v[1] : v[0];
    return __shfl_sync(kFullMask, mine, base + (j & (G - 1)));
  }
};

// The largest of `n` over the warp: the trip count of a loop that every
// group must run together.
__device__ __forceinline__ unsigned warp_max(unsigned n) {
  return __reduce_max_sync(kFullMask, n);
}

// The running pick of the v2 formulation, lane-parallel: every lane holds
// the query (qb1, qb2) of each of its slots; the group walks the pool slots
// j in `todo` in ascending order, fetches pool slot j's (score, b2m, b3m)
// from its owner and applies, literally,
//     take = match & (cand > best || (cand == best && nongap_j))
// to each query, where a match also needs j < limit[s] and j outside
// `guard`. best / rj / has must come in as NEG_INF-1 / 0 / false. `trips` is
// warp-uniform and at least the size of every group's `todo`. A `todo` wider
// than the slots that can match changes nothing, nor do trips past its end:
// a slot that does not match is skipped.
template <int G, int S>
__device__ __forceinline__ void group_pick(
    const LaneGroup<G, S>& g, typename SlotMask<S>::type todo,
    const int (&pool_sc)[S], const int (&pool_b2m)[S],
    const int (&pool_b3m)[S], typename SlotMask<S>::type guard,
    typename SlotMask<S>::type nongap, const int (&qb1)[S],
    const int (&qb2)[S], const int (&limit)[S], unsigned trips, int (&best)[S],
    int (&rj)[S], bool (&has)[S]) {
  for (unsigned it = 0; it < trips; ++it) {
    const bool live_j = todo != 0;
    const int j = live_j ? mask_ffs(todo) : 0;
    todo &= todo - 1;
    const int cand = g.fetch(pool_sc, j);
    const int b2_j = g.fetch(pool_b2m, j);
    const int b3_j = g.fetch(pool_b3m, j);
    const bool open_j = live_j && !((guard >> j) & 1);
    const bool nongap_j = (nongap >> j) & 1;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (open_j && b2_j == qb1[s] && b3_j == qb2[s] && j < limit[s]) {
        if (cand > best[s] || (cand == best[s] && nongap_j)) {
          best[s] = cand;
          rj[s] = j;
        }
        has[s] = true;
      }
    }
  }
}

// The _pick reduction of consensus_pallas.py (:53-66), lane-parallel, in one
// ascending walk of the pool. The reduction takes the max over all K rows,
// rows that do not match entering as NEG_INF-1; ismax = match & (score ==
// max); the pick is the LAST maximal row whose predecessor is a non-gap, else
// the FIRST; has = any(ismax). Over the matching rows alone, in ascending
// order, the rule
//     take = first match || cand > best || (cand == best && nongap_j)
// leaves their max in `best` and that very row in `row`: the first maximal
// row, replaced by every later maximal row with a non-gap predecessor. Then,
// when some row of the K did not match and the max lies below NEG_INF-1, the
// floor NEG_INF-1 is the max and no row is maximal.
template <int S>
struct ReducePick {
  int best[S], rj[S], n_match[S];

  __device__ __forceinline__ void reset() {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      best[s] = INT32_MIN;
      rj[s] = 0;
      n_match[s] = 0;
    }
  }
  // has = any(ismax) over a pool of K rows
  __device__ __forceinline__ bool has(int s, int K) const {
    return !(n_match[s] < K && best[s] < kNeg1);
  }
  // the chosen row, 0 without one
  __device__ __forceinline__ int row(int s, int K) const {
    return has(s, K) ? rj[s] : 0;
  }
};

// Arguments as group_pick. A pool slot j matches on its keys alone; with
// LIMITED its score enters as pool_sc[j] when j < limit[s] and as NEG_INF
// otherwise (the same-column pool at step i holds final scores before slot i
// and NEG_INF from it on). `pick` must come in reset. The body is selects
// only, so that one trip's shuffles overlap the compares of the trip before.
template <bool LIMITED, int G, int S>
__device__ __forceinline__ void group_reduce(
    const LaneGroup<G, S>& g, typename SlotMask<S>::type todo,
    const int (&pool_sc)[S], const int (&pool_b2m)[S],
    const int (&pool_b3m)[S], typename SlotMask<S>::type guard,
    typename SlotMask<S>::type nongap, const int (&qb1)[S],
    const int (&qb2)[S], const int (&limit)[S], unsigned trips,
    ReducePick<S>& pick) {
  for (unsigned it = 0; it < trips; ++it) {
    const bool live_j = todo != 0;
    const int j = live_j ? mask_ffs(todo) : 0;
    todo &= todo - 1;
    const int sc_j = g.fetch(pool_sc, j);
    const int b2_j = g.fetch(pool_b2m, j);
    const int b3_j = g.fetch(pool_b3m, j);
    const bool open_j = live_j && !((guard >> j) & 1);
    const bool nongap_j = (nongap >> j) & 1;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const bool m = open_j & (b2_j == qb1[s]) & (b3_j == qb2[s]);
      const int cand = (!LIMITED || j < limit[s]) ? sc_j : kNegInf;
      const bool take = m & ((pick.n_match[s] == 0) | (cand > pick.best[s]) |
                             ((cand == pick.best[s]) & nongap_j));
      pick.best[s] = take ? cand : pick.best[s];
      pick.rj[s] = take ? j : pick.rj[s];
      pick.n_match[s] += m;
    }
  }
}

#ifndef NP2T_EMULATE  // the CPU rehearsal (csrc/emu/) brings its own
// Launch `kernel` (a function pointer) with one warp per block.
#define NP2T_LAUNCH_WARPS(kernel, blocks, smem, stream, ...) \
  kernel<<<(blocks), 32, (smem), (cudaStream_t)(stream)>>>(__VA_ARGS__)

// Asynchronous copies global -> shared (cp.async): started by a lane, made
// visible to the warp by cp_async_wait + __syncwarp.
__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(smem)),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(smem)),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this lane's committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
#endif  // NP2T_EMULATE

// Stage n int32 words global -> shared with `lanes` lanes (this one has rank
// r), in 16-byte pieces when `vec` (both addresses 16-byte aligned and n a
// multiple of 4), else word by word.
__device__ __forceinline__ void stage_words(int* smem, const int* gmem, int n,
                                            int r, int lanes, bool vec) {
  if (vec) {
    for (int i = r; i < n / 4; i += lanes)
      cp_async_16(smem + 4 * i, gmem + 4 * i);
  } else {
    for (int i = r; i < n; i += lanes) cp_async_4(smem + i, gmem + i);
  }
}

// Flush n int32 words (bytes) shared -> global, and fill n words (bytes) of
// global memory with one value, with `lanes` lanes; 16-byte stores when
// `vec` (addresses 16-byte aligned, n a multiple of 4 words / 16 bytes).
__device__ __forceinline__ void flush_words(int* gmem, const int* smem, int n,
                                            int r, int lanes, bool vec) {
  if (vec) {
    for (int i = r; i < n / 4; i += lanes)
      reinterpret_cast<int4*>(gmem)[i] = reinterpret_cast<const int4*>(smem)[i];
  } else {
    for (int i = r; i < n; i += lanes) gmem[i] = smem[i];
  }
}
__device__ __forceinline__ void flush_bytes(int8_t* gmem, const int8_t* smem,
                                            int n, int r, int lanes,
                                            bool vec) {
  if (vec) {
    for (int i = r; i < n / 16; i += lanes)
      reinterpret_cast<int4*>(gmem)[i] = reinterpret_cast<const int4*>(smem)[i];
  } else {
    for (int i = r; i < n; i += lanes) gmem[i] = smem[i];
  }
}
__device__ __forceinline__ void fill_words(int* gmem, int n, int v, int r,
                                           int lanes, bool vec) {
  if (vec) {
    const int4 v4 = make_int4(v, v, v, v);
    for (int i = r; i < n / 4; i += lanes) reinterpret_cast<int4*>(gmem)[i] = v4;
  } else {
    for (int i = r; i < n; i += lanes) gmem[i] = v;
  }
}
__device__ __forceinline__ void fill_bytes(int8_t* gmem, int n, int8_t v,
                                           int r, int lanes, bool vec) {
  if (vec) {
    const int w = (int)((uint8_t)v * 0x01010101u);
    const int4 v4 = make_int4(w, w, w, w);
    for (int i = r; i < n / 16; i += lanes)
      reinterpret_cast<int4*>(gmem)[i] = v4;
  } else {
    for (int i = r; i < n; i += lanes) gmem[i] = v;
  }
}

// ---------------------------------------------------------------------------
// Staged tiles. The DP kernels read their window's key, cnt and per-column
// words (cov; cov and n_slots) through a ring of kStages tiles of kTile
// columns in shared memory, collect a tile's scores and besti there, and hand
// the tile to device memory in wide stores.

constexpr int kTile = 32;   // columns per staged tile; a multiple of 16, so
                            // every tile starts 16-byte aligned when the
                            // window's row does
constexpr int kStages = 3;  // tiles in flight
constexpr int kPad = 8;     // words between the buffers of a warp's windows:
                            // 4 groups reading slot s of their column then
                            // hit 4 different sets of banks

// lanes are slots: 8 lanes a window and 4 windows a warp at K = 8; one warp a
// window with two slots a lane at K = 48 and for any other K <= 64
template <int KT>
struct SlotMap {
  static constexpr int G = KT == 8 ? 8 : 32;  // lanes per window
  static constexpr int S = KT == 8 ? 1 : 2;   // slots per lane
  static constexpr int NW = 32 / G;           // windows per warp
};

// shared-memory layout per window, in words (besti: bytes); NC per-column
// words ride behind the key and cnt tiles
__host__ __device__ constexpr int in_stride(int K, int NC) {
  return 2 * kTile * K + NC * kTile + kPad;
}
__host__ __device__ constexpr int sc_stride(int K) { return kTile * K + kPad; }
__host__ __device__ constexpr int bi_stride(int K) {
  return kTile * K + 4 * kPad;
}
__host__ __device__ constexpr size_t smem_bytes(int K, int NW, int NC) {
  return 4 * (size_t)NW * (kStages * in_stride(K, NC) + sc_stride(K)) +
         (size_t)NW * bi_stride(K);
}

// One window's view of its warp's shared memory: the input ring and the
// output tile of group `grp`. NC = 1: cov; NC = 2: cov and n_slots.
template <int G, int NW, int NC>
struct WindowTiles {
  int* in_g;
  int* out_sc;
  int8_t* out_bi;
  int tk;            // words of a key (or cnt) tile
  int stage_stride;  // words from one stage to the next
  // 16-byte pieces need every window's row to start 16-byte aligned
  bool vec_w;  // key, cnt, scores
  bool vec_c;  // cov, n_slots
  bool vec_b;  // besti

  __device__ __forceinline__ WindowTiles(int* smem, int grp, int K, int W)
      : in_g(smem + grp * in_stride(K, NC)),
        out_sc(smem + kStages * NW * in_stride(K, NC) + grp * sc_stride(K)),
        out_bi(reinterpret_cast<int8_t*>(smem +
                                         kStages * NW * in_stride(K, NC) +
                                         NW * sc_stride(K)) +
               grp * bi_stride(K)),
        tk(kTile * K),
        stage_stride(NW * in_stride(K, NC)),
        vec_w(((size_t)W * K) % 4 == 0),
        vec_c(W % 4 == 0),
        vec_b(((size_t)W * K) % 16 == 0) {}

  // the stage that holds tile t: key at 0, cnt at tk, cov at 2 * tk, n_slots
  // at 2 * tk + kTile
  __device__ __forceinline__ const int* stage(int t) const {
    return in_g + (t % kStages) * stage_stride;
  }

  // Start the copies of tile t of the window whose rows begin at word bw of
  // [B, W] (when `want`) with the group's lanes. Every lane commits one
  // (possibly empty) group per call, so the wait counts stay uniform.
  __device__ __forceinline__ void prefetch(
      bool want, int t, int rank, const int* __restrict__ key,
      const int* __restrict__ cnt, const int* __restrict__ cov,
      const int* __restrict__ n_slots, size_t bw, int W, int K) const {
    if (want) {
      const int c0 = t * kTile;
      const int ncol = min(kTile, W - c0);
      int* dst = in_g + (t % kStages) * stage_stride;
      stage_words(dst, key + (bw + c0) * K, ncol * K, rank, G, vec_w);
      stage_words(dst + tk, cnt + (bw + c0) * K, ncol * K, rank, G, vec_w);
      stage_words(dst + 2 * tk, cov + bw + c0, ncol, rank, G, vec_c);
      if constexpr (NC == 2)
        stage_words(dst + 2 * tk + kTile, n_slots + bw + c0, ncol, rank, G,
                    vec_c);
    }
    cp_async_commit();
  }

  // the collected tile (ncol columns from c0) to device memory
  __device__ __forceinline__ void flush(int* __restrict__ scores,
                                        int8_t* __restrict__ besti, size_t bw,
                                        int c0, int ncol, int rank,
                                        int K) const {
    flush_words(scores + (bw + c0) * K, out_sc, ncol * K, rank, G, vec_w);
    flush_bytes(besti + (bw + c0) * K, out_bi, ncol * K, rank, G, vec_b);
  }
};

// One column as the lanes of a group hold it: each lane its slots' keys,
// gain and predicates, every lane the group's bit sets.
template <int S, typename mask_t>
struct ColumnLanes {
  int b1[S], b2[S], b2m[S], b3m[S], gain[S];
  bool on[S];      // the slot exists and its column is scanned
  bool comp[S];    // on, and below the column's slot bound: it is computed
  bool valid[S];   // on, and key >= 0
  bool same[S];    // on, and the key carries the same-column flag
  bool b2head[S];
  mask_t head, nongap, vmask;
  mask_t same_valid;       // computed same-column slots that can score
  // warp-wide:
  bool neg7;               // some query is -7: pools widen to all K slots
  bool invalid_same_work;  // an invalid same-column slot may match a target
  unsigned n_vmask;        // largest count of vmask slots of a group
  unsigned n_same_valid;   // largest count of same_valid slots of a group
};

// Decode column c (column cc of the staged tile `tile`, whose key tile holds
// tk words) as the group's lanes hold it; `act`: this group scans the column.
// It does not depend on the carry, so callers run it one column ahead of the
// pick. With BOUNDED the column's slot bound is its n_slots word clamped to
// [0, K]; without, every slot is computed. Called by all lanes of the warp.
template <bool BOUNDED, int G, int S>
__device__ __forceinline__ ColumnLanes<S, typename SlotMask<S>::type>
decode_column_lanes(const LaneGroup<G, S>& g, const int* tile, int tk, int cc,
                    int c, bool act, int K, const int (&slot)[S],
                    const bool (&exists)[S]) {
  using Group = LaneGroup<G, S>;
  ColumnLanes<S, typename SlotMask<S>::type> d;
  const int cv = act ? tile[2 * tk + cc] : 0;
  int kmax = K;
  if constexpr (BOUNDED) {
    const int ns = act ? tile[2 * tk + kTile + cc] : 0;
    kmax = ns < 0 ? 0 : (ns > K ? K : ns);
  }
  bool head[S], nongap[S], vbit[S], sv[S];
  bool n7 = false, inv = false;
  unsigned targets = 0, queries = 0;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const bool on = act && exists[s];
    int k = -1, n = 0;
    if (on) {
      k = tile[cc * K + slot[s]];
      n = tile[tk + cc * K + slot[s]];
    }
    const SlotDecode sd = decode_slot(k, c);
    d.b1[s] = sd.b1;
    d.b2[s] = sd.b2;
    d.b2m[s] = on ? sd.b2m : -7;
    d.b3m[s] = on ? sd.b3m : -8;
    d.gain[s] = 10 * n - 4 * cv;
    d.on[s] = on;
    d.comp[s] = BOUNDED ? (on && slot[s] < kmax) : on;
    d.valid[s] = on && sd.valid;
    d.same[s] = on && sd.same;
    d.b2head[s] = sd.b2head;
    head[s] = on && sd.head;
    nongap[s] = on && sd.nongap;
    vbit[s] = on && sd.vbit;
    sv[s] = d.valid[s] && d.same[s] && d.comp[s];
    n7 = n7 || (on && sd.b1 == -7);
    // an invalid same-column slot can only match a target whose b2 key
    // shares its b1 key's bits: 5 of them, one bit of a 32-bit set, tell
    // whether the besti pass can find anything (an empty slot's delta field
    // is 0xFFFF, a target's is an insertion depth)
    if (vbit[s]) targets |= 1u << ((sd.b2m >> 4) & 31);
    if (d.same[s] && !d.valid[s] && d.comp[s]) {
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
}

// A kernel that takes more than 48 KB of dynamic shared memory must be
// allowed to, once per device: raise() does it before the first launch there
// and returns the CUDA error (0 on success).
struct SmemLimit {
  std::atomic<uint64_t> done{0};  // one bit per device ordinal (mod 64)

  template <typename Kernel>
  int raise(Kernel kernel, size_t bytes) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    const uint64_t bit = 1ull << (dev & 63);
    if (done.load() & bit) return 0;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
    if (e != cudaSuccess) return (int)e;
    done.fetch_or(bit);
    return 0;
  }
};

// ---------------------------------------------------------------------------
// The column scan of the base and dynamic-K formulations (Pallas _dp_kernel
// and _dp_kernel_dynk), on the slot-parallel mapping: lanes are slots, one
// warp per block, the carry in registers, tiles staged two ahead, the next
// column decoded while the current one is picked.
//
// Per column, slot i reduces (group_reduce) the previous column's K slots or,
// with the same-column flag, ALL K slots of this column at their scores as of
// step i: final before i, NEG_INF from i on, so a target at j >= i does match,
// at NEG_INF. The previous-column picks do not depend on the step and go for
// all slots in one pass; the valid same-column slots go one after another in
// slot order; the invalid same-column slots (every empty slot carries the
// flag) cannot feed a later score and take their besti from one lane-parallel
// pass at the end, each over the pool as of its own step. All W columns are
// scanned, and every slot is computed, valid or not. With DYNK the slots of
// column c from clamp(n_slots[b, c], 0, K) on keep NEG_INF / 0: they stay
// match targets and stay in the carry, and the anchor seeding still zeroes
// every valid slot.
//
// A column whose keys are all the empty key -1 in every window of the warp
// only hands on a constant carry: a key of -1 has the same-column flag and a
// query (q1 = 15) that no target of -7 equals, so every pick there is empty
// and the outputs are NEG_INF / 0. A scan of the staged key tile finds such
// columns, or a whole such tile, and they are not scored; any other key, a
// negative one too, takes the full path.
template <int KT, bool DYNK>
__global__ void __launch_bounds__(32)
dp_reduce_kernel(const int* __restrict__ key, const int* __restrict__ cnt,
                 const int* __restrict__ cov, const int* __restrict__ n_slots,
                 const int* __restrict__ lead, const uint8_t* __restrict__ seed,
                 int* __restrict__ scores, int8_t* __restrict__ besti, int B,
                 int W, int k_rt) {
  using Map = SlotMap<KT>;
  constexpr int G = Map::G, S = Map::S, NW = Map::NW;
  constexpr int NC = DYNK ? 2 : 1;
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
  const WindowTiles<G, NW, NC> tiles(reinterpret_cast<int*>(smem4), grp, K, W);
  const int n_tiles = (W + kTile - 1) / kTile;

  int lead_b = 0;
  bool seed_b = false;
  if (live) {
    lead_b = lead[b];
    seed_b = seed[b] != 0;
  }
  int slot[S];
  bool exists[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    slot[s] = g.rank + 32 * s;
    exists[s] = slot[s] < K;
  }
  const mask_t all_k = Group::low_bits(K);

  auto prefetch = [&](int t) {
    tiles.prefetch(live && t < n_tiles, t, g.rank, key, cnt, cov, n_slots, bw,
                   W, K);
  };

  // the carry: column carry_c as the next column's pool (-1: nothing yet)
  int p_sc[S], p_b2[S], p_b3[S];
  mask_t p_head = 0, p_nongap = 0, p_vmask = 0;
  unsigned p_n_vmask = 0;
  int carry_c = -1;
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
    const int ncol = min(kTile, W - c0);
    const int* tile = tiles.stage(t);

    // the tile's columns that hold a key other than -1 in some window
    unsigned nz = 0;
    if (live && K % 4 == 0) {
      const int4* tile4 = reinterpret_cast<const int4*>(tile);
#pragma unroll 4
      for (int e = g.rank; e < ncol * K / 4; e += G) {
        const int4 k4 = tile4[e];
        if ((k4.x & k4.y & k4.z & k4.w) != -1) nz |= 1u << (4 * e / K);
      }
    } else if (live) {
      for (int e = g.rank; e < ncol * K; e += G)
        if (tile[e] != -1) nz |= 1u << (e / K);
    }
    nz = __reduce_or_sync(kFullMask, nz);
    if (nz == 0) {
      if (live) {
        fill_words(scores + (bw + c0) * K, ncol * K, kNegInf, g.rank, G,
                   tiles.vec_w);
        fill_bytes(besti + (bw + c0) * K, ncol * K, 0, g.rank, G, tiles.vec_b);
      }
      continue;
    }
    if (nz != Group::low_bits(ncol)) {
      for (int e = g.rank; e < ncol * K; e += G) {
        if (!((nz >> (e / K)) & 1)) {
          tiles.out_sc[e] = kNegInf;
          tiles.out_bi[e] = 0;
        }
      }
    }

    auto decode = [&](int cc) {
      return decode_column_lanes<DYNK>(g, tile, tiles.tk, cc, c0 + cc, live, K,
                                       slot, exists);
    };

    unsigned rest = nz;
    Col cur = decode(__ffs((int)rest) - 1);
    while (rest) {
      const int cc = __ffs((int)rest) - 1;
      rest &= rest - 1;
      const int c = c0 + cc;
      Col nxt = cur;
      if (rest) nxt = decode(__ffs((int)rest) - 1);

      if (carry_c != c - 1) {
        // the column before this one was empty in every window
#pragma unroll
        for (int s = 0; s < S; ++s) {
          p_sc[s] = kNegInf;
          p_b2[s] = -7;
          p_b3[s] = -8;
        }
        p_head = p_nongap = live ? all_k : 0;
        p_vmask = 0;
        p_n_vmask = 0;
      }

      const bool colge3 = lead_b + c >= 3;
      const mask_t pv_guard = colge3 ? p_head : 0;
      const mask_t cur_guard = colge3 ? cur.head : 0;
      ReducePick<S> pick;
      int c_sc[S], bi[S];
      auto score = [&](int s) {
        return cur.b2head[s] ? cur.gain[s]
                             : (pick.has(s, K)
                                    ? wrap_add(pick.best[s], cur.gain[s])
                                    : kNegInf);
      };

      // previous-column pool: every computed slot without the same-column
      // flag
      pick.reset();
      group_reduce<false>(g, cur.neg7 ? all_k : p_vmask, p_sc, p_b2, p_b3,
                          pv_guard, p_nongap, cur.b1, cur.b2, slot,
                          cur.neg7 ? (unsigned)K : p_n_vmask, pick);
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const bool prev_pool = cur.comp[s] && !cur.same[s];
        c_sc[s] = (prev_pool && cur.valid[s]) ? score(s) : kNegInf;
        bi[s] = prev_pool ? pick.row(s, K) : 0;
      }

      // same-column pool, valid slots: in slot order, each over all slots of
      // this column, those before it at their final (unseeded) scores
      const mask_t cur_pool = cur.neg7 ? all_k : cur.vmask;
      const unsigned cur_trips = cur.neg7 ? (unsigned)K : cur.n_vmask;
      mask_t todo_i = cur.same_valid;
      for (unsigned it = 0; it < cur.n_same_valid; ++it) {
        const bool live_i = todo_i != 0;
        const int i = live_i ? mask_ffs(todo_i) : 0;
        todo_i &= todo_i - 1;
        int lim_i[S];
#pragma unroll
        for (int s = 0; s < S; ++s) lim_i[s] = i;
        pick.reset();
        group_reduce<true>(g, live_i ? cur_pool : 0, c_sc, cur.b2m, cur.b3m,
                           cur_guard, cur.nongap, cur.b1, cur.b2, lim_i,
                           cur_trips, pick);
#pragma unroll
        for (int s = 0; s < S; ++s) {
          if (live_i && slot[s] == i) {
            c_sc[s] = score(s);
            bi[s] = pick.row(s, K);
          }
        }
      }

      // same-column pool, invalid slots: they score NEG_INF whatever they
      // pick, so only their besti is left, for all of them at once
      if (cur.invalid_same_work) {
        pick.reset();
        group_reduce<true>(g, cur_pool, c_sc, cur.b2m, cur.b3m, cur_guard,
                           cur.nongap, cur.b1, cur.b2, slot, cur_trips, pick);
#pragma unroll
        for (int s = 0; s < S; ++s) {
          if (cur.same[s] && !cur.valid[s] && cur.comp[s])
            bi[s] = pick.row(s, K);
        }
      }

      const bool anchor = seed_b && c == 2;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int out = (anchor && cur.valid[s]) ? 0 : c_sc[s];
        if (exists[s]) {
          tiles.out_sc[cc * K + slot[s]] = out;
          tiles.out_bi[cc * K + slot[s]] = (int8_t)bi[s];
        }
        p_sc[s] = out;
        p_b2[s] = cur.b2m[s];
        p_b3[s] = cur.b3m[s];
      }
      p_head = cur.head;
      p_nongap = cur.nongap;
      p_vmask = cur.vmask;
      p_n_vmask = cur.n_vmask;
      carry_c = c;
      cur = nxt;
    }

    __syncwarp();
    if (live) tiles.flush(scores, besti, bw, c0, ncol, g.rank, K);
    // the next tile overwrites the output buffer, and the next prefetch the
    // stage this tile was read from
    __syncwarp();
  }
  cp_async_wait<0>();
}

// Launch the instance of the scan for K (fixed at 8 or 48, else read at run
// time) on `stream`: one warp per block, a block per SlotMap::NW windows.
// Returns the launch's cudaGetLastError(); K must be in 1..kMaxK.
template <int KT, bool DYNK>
int launch_reduce_k(const void* key, const void* cnt, const void* cov,
                    const void* n_slots, const void* lead, const void* seed,
                    void* scores, void* besti, int B, int W, int K,
                    void* stream) {
  constexpr int NW = SlotMap<KT>::NW;
  constexpr int NC = DYNK ? 2 : 1;
  static SmemLimit limit;
  auto* kernel = dp_reduce_kernel<KT, DYNK>;
  // the runtime-K instance asks once for what its widest K needs
  const int rc = limit.raise(kernel, smem_bytes(KT > 0 ? KT : kMaxK, NW, NC));
  if (rc != 0) return rc;
  NP2T_LAUNCH_WARPS(kernel, (B + NW - 1) / NW, smem_bytes(K, NW, NC), stream,
                    (const int*)key, (const int*)cnt, (const int*)cov,
                    (const int*)n_slots, (const int*)lead,
                    (const uint8_t*)seed, (int*)scores, (int8_t*)besti, B, W,
                    K);
  return (int)cudaGetLastError();
}

template <bool DYNK>
int launch_reduce(const void* key, const void* cnt, const void* cov,
                  const void* n_slots, const void* lead, const void* seed,
                  void* scores, void* besti, int B, int W, int K,
                  void* stream) {
  if (K < 1 || K > kMaxK || B < 0 || W < 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || W == 0) return 0;
  auto* launch = K == 8 ? launch_reduce_k<8, DYNK>
                        : (K == 48 ? launch_reduce_k<48, DYNK>
                                   : launch_reduce_k<0, DYNK>);
  return launch(key, cnt, cov, n_slots, lead, seed, scores, besti, B, W, K,
                stream);
}

}  // namespace np2t
