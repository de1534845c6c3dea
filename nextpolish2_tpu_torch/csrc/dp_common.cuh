// Shared pieces of the consensus DP kernels (consensus_dp.cu,
// consensus_dp_base.cu, consensus_dp_dynk.cu): constants, the int32 key
// packing of nextpolish2_tpu/ops/consensus_pallas.py::_decode_tile, the
// per-column slot decode, the _pick reduction and the column scan of the base
// and dynamic-K formulations, and the launch by slot tier.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

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

// One column of one window, decoded: per slot the query keys (b1, b2), the
// match targets (b2m, b3m: -7 / -8 on invalid slots, so they never match)
// and one bit per slot for each predicate.
template <int KM>
struct Column {
  int b1[KM], b2[KM], b2m[KM], b3m[KM];
  uint64_t head;     // q1 == HEAD_Q (b1 is the head marker)
  uint64_t nongap;   // q1 != 4
  uint64_t vmask;    // b2m != -7: the slot can match a query other than -7
  uint64_t same;     // flag bit 0: the predecessor pool is this column
  uint64_t valid;    // key >= 0
  uint64_t b2head;   // q2 == HEAD_Q
};

template <int KM>
__device__ __forceinline__ void decode_column(const int* __restrict__ key_row,
                                              int c, int K, Column<KM>& col) {
  col.head = col.nongap = col.vmask = col.same = col.valid = col.b2head = 0;
  for (int i = 0; i < K; ++i) {
    const int k = key_row[i];
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
    const bool valid = k >= 0;
    const uint64_t bit = 1ull << i;
    col.b1[i] = pack_bkey(b1_t, delta, q1);
    col.b2[i] = pack_bkey(b2_t, b2_d, q2);
    col.b2m[i] = valid ? col.b2[i] : -7;
    col.b3m[i] = valid ? pack_bkey(c, b3d, q3) : -8;
    if (q1 == kHeadQ) col.head |= bit;
    if (q1 != 4) col.nongap |= bit;
    if (col.b2m[i] != -7) col.vmask |= bit;
    if (f23) col.same |= bit;
    if (valid) col.valid |= bit;
    if (q2 == kHeadQ) col.b2head |= bit;
  }
}

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
