// Shared pieces of the consensus kernels (consensus_dp.cu,
// consensus_dp_base.cu, consensus_dp_dynk.cu, backtrack.cu): constants, the
// int32 key packing of nextpolish2_tpu/ops/consensus_pallas.py::_decode_tile
// and its one-slot decode; the slot-parallel mapping (a group of lanes owns a
// window, a lane owns a slot: group ballots, slot fetches by shuffle, the
// running pick over a pool of predecessor slots), asynchronous tile staging
// into shared memory and the wide output flush and fill; and, for the
// one-thread-per-window kernels, the per-column decode, the _pick reduction,
// the column scan of the base and dynamic-K formulations and the launch by
// slot tier.

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

// One column of one window, decoded by one thread: per slot the keys of
// SlotDecode and one bit per slot for each predicate.
template <int KM>
struct Column {
  int b1[KM], b2[KM], b2m[KM], b3m[KM];
  uint64_t head, nongap, vmask, same, valid, b2head;
};

template <int KM>
__device__ __forceinline__ void decode_column(const int* __restrict__ key_row,
                                              int c, int K, Column<KM>& col) {
  col.head = col.nongap = col.vmask = col.same = col.valid = col.b2head = 0;
  for (int i = 0; i < K; ++i) {
    const SlotDecode d = decode_slot(key_row[i], c);
    const uint64_t bit = 1ull << i;
    col.b1[i] = d.b1;
    col.b2[i] = d.b2;
    col.b2m[i] = d.b2m;
    col.b3m[i] = d.b3m;
    if (d.head) col.head |= bit;
    if (d.nongap) col.nongap |= bit;
    if (d.vbit) col.vmask |= bit;
    if (d.same) col.same |= bit;
    if (d.valid) col.valid |= bit;
    if (d.b2head) col.b2head |= bit;
  }
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
// One thread per window: the _pick reduction and the column scan of the base
// and dynamic-K formulations.

struct Pick {
  int best;  // the max; meaningful only when has
  int j;     // the chosen predecessor slot, 0 when !has
  bool has;
};

// The _pick reduction of consensus_pallas.py (:53-66) over a pool of K
// predecessor rows: rows that do not match enter the max as NEG_INF-1;
// ismax = match & (score == max); the pick is the LAST max whose
// predecessor is a non-gap, else the FIRST max; has = any(ismax), so a pool
// whose matching scores all lie below NEG_INF-1 (beside at least one
// non-matching row) reports has = 0. `todo` holds the rows that can match:
// every row outside it is a non-match (a target of -7 matches only a query
// of -7, and the caller widens todo to all K rows for that query).
__device__ __forceinline__ Pick pick_reduce(const int* b2m, const int* b3m,
                                            const int* sc, uint64_t guard,
                                            uint64_t nongap, uint64_t todo,
                                            int qb1, int qb2, int K) {
  uint64_t match = 0;
  int n_match = 0;
  int best = INT32_MIN;
  while (todo) {
    const int j = __ffsll((long long)todo) - 1;
    todo &= todo - 1;
    if (b2m[j] == qb1 && b3m[j] == qb2 && !((guard >> j) & 1)) {
      match |= 1ull << j;
      ++n_match;
      best = sc[j] > best ? sc[j] : best;
    }
  }
  const int maxv = (n_match < K && best < kNeg1) ? kNeg1 : best;
  uint64_t ismax = 0;
  while (match) {
    const int j = __ffsll((long long)match) - 1;
    match &= match - 1;
    if (sc[j] == maxv) ismax |= 1ull << j;
  }
  Pick p;
  p.best = maxv;
  p.has = ismax != 0;
  const uint64_t nonmax = ismax & nongap;
  p.j = !p.has ? 0
               : (nonmax ? 63 - __clzll((long long)nonmax)
                         : __ffsll((long long)ismax) - 1);
  return p;
}

// The column scan of the base and dynamic-K formulations for window b: one
// thread per window, columns in sequence, the previous column's K-slot
// carry in per-thread arrays. Per column, slot i (ascending) picks over the
// previous column's slots, or, with the same-column flag, over ALL slots of
// this column at their current scores: final for slots before i, NEG_INF
// for slots from i on, exactly the [K, L] tile the Pallas loops read. Only
// the pool that the slot's flag selects is reduced (Pallas reduces both and
// selects). With n_slots (dynamic-K) the slot loop of column c stops at
// n_slots[b, c]; slots from there on keep NEG_INF / 0. Without it (base)
// all K slots are computed. KT > 0 fixes K at compile time.
template <int KT>
__device__ __forceinline__ void dp_reduce_window(
    const int* __restrict__ key, const int* __restrict__ cnt,
    const int* __restrict__ cov, const int* __restrict__ n_slots,
    const int* __restrict__ lead, const uint8_t* __restrict__ seed,
    int* __restrict__ scores, int8_t* __restrict__ besti, int b, int W,
    int k_rt) {
  constexpr int KM = KT > 0 ? KT : kMaxK;
  const int K = KT > 0 ? KT : k_rt;

  int p_sc[KM], p_b2[KM], p_b3[KM];
  uint64_t p_head = 0, p_nongap = 0, p_vmask = 0;
  Column<KM> col;
  int c_sc[KM];
  for (int i = 0; i < K; ++i) {
    p_sc[i] = kNegInf;
    p_b2[i] = -7;
    p_b3[i] = -8;
  }
  const uint64_t all_k = K >= 64 ? ~0ull : ((1ull << K) - 1);
  const int lead_b = lead[b];
  const bool seed_b = seed[b] != 0;

  for (int c = 0; c < W; ++c) {
    const size_t row = ((size_t)b * W + c) * K;
    const int cv = cov[(size_t)b * W + c];
    int kmax = K;
    if (n_slots != nullptr) {
      const int ns = n_slots[(size_t)b * W + c];
      kmax = ns < 0 ? 0 : (ns > K ? K : ns);
    }
    const bool colge3 = lead_b + c >= 3;
    decode_column<KM>(key + row, c, K, col);
    const uint64_t pv_guard = colge3 ? p_head : 0;
    const uint64_t cur_guard = colge3 ? col.head : 0;
    for (int i = 0; i < K; ++i) c_sc[i] = kNegInf;

    for (int i = 0; i < kmax; ++i) {
      const uint64_t bit = 1ull << i;
      const int qb1 = col.b1[i], qb2 = col.b2[i];
      const Pick p = (col.same & bit)
          ? pick_reduce(col.b2m, col.b3m, c_sc, cur_guard, col.nongap,
                        qb1 == -7 ? all_k : col.vmask, qb1, qb2, K)
          : pick_reduce(p_b2, p_b3, p_sc, pv_guard, p_nongap,
                        qb1 == -7 ? all_k : p_vmask, qb1, qb2, K);
      const int gain = 10 * cnt[row + i] - 4 * cv;
      int s = (col.b2head & bit) ? gain
                                 : (p.has ? wrap_add(p.best, gain) : kNegInf);
      if (!(col.valid & bit)) s = kNegInf;
      c_sc[i] = s;
      besti[row + i] = (int8_t)p.j;
    }
    for (int i = kmax; i < K; ++i) besti[row + i] = 0;
    const bool anchor = seed_b && c == 2;
    for (int i = 0; i < K; ++i) {
      const int out = (anchor && ((col.valid >> i) & 1)) ? 0 : c_sc[i];
      scores[row + i] = out;
      p_sc[i] = out;
      p_b2[i] = col.b2m[i];
      p_b3[i] = col.b3m[i];
    }
    p_head = col.head;
    p_nongap = col.nongap;
    p_vmask = col.vmask;
  }
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

// Launch one of a kernel's three instances by slot tier (K fixed at 8 or
// 48, else read at run time), one thread per window in blocks of 128.
// Returns the launch's cudaGetLastError(); K must be in 1..kMaxK.
template <typename... Args>
int launch_by_k(void (*k8)(Args...), void (*k48)(Args...),
                void (*k_rt)(Args...), int B, int W, int K, void* stream,
                Args... args) {
  if (K < 1 || K > kMaxK || B < 0 || W < 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || W == 0) return 0;
  void (*kernel)(Args...) = K == 8 ? k8 : (K == 48 ? k48 : k_rt);
  kernel<<<(B + 127) / 128, 128, 0, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace np2t
