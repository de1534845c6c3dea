// Windowed consensus Viterbi DP for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel nextpolish2_tpu/ops/consensus_pallas.py::
// _dp_kernel_v2 with span bounding (the "v2" running-pick formulation).
// Outputs are bit-identical to it on every column below a window's span;
// columns at or past the span hold NEG_INF / 0 (the Pallas kernel's memset
// values; the backtrack reads scores only at last_col = span - 1 and besti
// only along its walk, which never leaves columns <= last_col).
//
// Design: one thread per window. The K-slot carry of the previous column
// (scores, b2key, b3key, b1head, b1nongap) lives in per-thread arrays
// (registers at K=8, local memory at K=48); columns run sequentially inside
// the thread. Per column, slot i takes the running pick over predecessors
// j in ascending order:
//     take = match & (cand > best  ||  (cand == best && pred_nongap))
// best starting at NEG_INF-1 and j at 0: strict max, ties prefer the last
// non-gap predecessor, else the first maximum (main.rs:1670). Slots without
// the same-column flag pick over the previous column's slots; slots with it
// pick over EARLIER slots of this column (slots are ordered by b3-delta, so
// in-column predecessors always come first: any insertion depth, no level
// cap). Only predecessors that can match are visited: a predecessor whose
// b2key is the invalid sentinel (-7) can match only a query b1key of -7, so
// the loop walks the valid-predecessor bit mask unless the query is -7.
//
// Bound: O(K^2) int32 compare/select per column per window against
// 13 B/slot of traffic, so it is operation-bound on paper; with one thread
// per window a B=128 chunk fills 4 warps of one SM each, so in practice it
// is latency-bound on the per-thread sequential column chain. A
// warp-per-window or slot-parallel mapping is later work.

#include "dp_common.cuh"

namespace {

using namespace np2t;

template <int KT>
__global__ void __launch_bounds__(128)
dp_v2_kernel(const int* __restrict__ key, const int* __restrict__ cnt,
             const int* __restrict__ cov, const int* __restrict__ lead,
             const uint8_t* __restrict__ seed, const int* __restrict__ span,
             int* __restrict__ scores, int8_t* __restrict__ besti,
             int B, int W, int k_rt) {
  constexpr int KM = KT > 0 ? KT : kMaxK;
  const int K = KT > 0 ? KT : k_rt;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

  int p_sc[KM], p_b2[KM], p_b3[KM];
  uint64_t p_head = 0, p_nongap = 0, p_vmask = 0;  // vmask: p_b2 != -7
  int c_b1[KM], c_b2[KM], c_b2m[KM], c_b3m[KM], c_sc[KM];
  for (int i = 0; i < K; ++i) {
    p_sc[i] = kNegInf;
    p_b2[i] = -7;
    p_b3[i] = -8;
  }
  const uint64_t all_k = K >= 64 ? ~0ull : ((1ull << K) - 1);
  const int lead_b = lead[b];
  const bool seed_b = seed[b] != 0;
  int sp = span[b];
  sp = sp < 0 ? 0 : (sp > W ? W : sp);

  for (int c = 0; c < sp; ++c) {
    const size_t row = ((size_t)b * W + c) * K;
    const int cv = cov[(size_t)b * W + c];
    const bool colge3 = lead_b + c >= 3;
    uint64_t c_head = 0, c_nongap = 0, c_vmask = 0, c_same = 0, c_valid = 0,
             c_b2head = 0;
    for (int i = 0; i < K; ++i) {
      const int k = key[row + i];
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
      c_b1[i] = pack_bkey(b1_t, delta, q1);
      c_b2[i] = pack_bkey(b2_t, b2_d, q2);
      c_b2m[i] = valid ? c_b2[i] : -7;
      c_b3m[i] = valid ? pack_bkey(c, b3d, q3) : -8;
      if (q1 == kHeadQ) c_head |= bit;
      if (q1 != 4) c_nongap |= bit;
      if (c_b2m[i] != -7) c_vmask |= bit;
      if (f23) c_same |= bit;
      if (valid) c_valid |= bit;
      if (q2 == kHeadQ) c_b2head |= bit;
    }
    const uint64_t pv_guard = colge3 ? p_head : 0;
    const uint64_t cur_guard = colge3 ? c_head : 0;

    for (int i = 0; i < K; ++i) {
      const uint64_t bit = 1ull << i;
      const int qb1 = c_b1[i], qb2 = c_b2[i];
      int rbest = kNeg1, rj = 0;
      bool rhas = false;
      if (c_same & bit) {
        // same-column pool: slots j < i with their unseeded final scores
        uint64_t todo = (qb1 == -7 ? all_k : c_vmask) & (bit - 1);
        while (todo) {
          const int j = __ffsll((long long)todo) - 1;
          todo &= todo - 1;
          const bool m = c_b2m[j] == qb1 && c_b3m[j] == qb2 &&
                         !((cur_guard >> j) & 1);
          if (m) {
            const int cand = c_sc[j];
            if (cand > rbest || (cand == rbest && ((c_nongap >> j) & 1))) {
              rbest = cand;
              rj = j;
            }
            rhas = true;
          }
        }
      } else {
        // previous-column pool
        uint64_t todo = qb1 == -7 ? all_k : p_vmask;
        while (todo) {
          const int j = __ffsll((long long)todo) - 1;
          todo &= todo - 1;
          const bool m = p_b2[j] == qb1 && p_b3[j] == qb2 &&
                         !((pv_guard >> j) & 1);
          if (m) {
            const int cand = p_sc[j];
            if (cand > rbest || (cand == rbest && ((p_nongap >> j) & 1))) {
              rbest = cand;
              rj = j;
            }
            rhas = true;
          }
        }
      }
      const int gain = 10 * cnt[row + i] - 4 * cv;
      int s = (c_b2head & bit) ? gain : (rhas ? wrap_add(rbest, gain) : kNegInf);
      if (!(c_valid & bit)) s = kNegInf;
      c_sc[i] = s;
      besti[row + i] = (int8_t)(rhas ? rj : 0);
    }
    const bool anchor = seed_b && c == 2;
    for (int i = 0; i < K; ++i) {
      const int out = (anchor && ((c_valid >> i) & 1)) ? 0 : c_sc[i];
      scores[row + i] = out;
      p_sc[i] = out;
      p_b2[i] = c_b2m[i];
      p_b3[i] = c_b3m[i];
    }
    p_head = c_head;
    p_nongap = c_nongap;
    p_vmask = c_vmask;
  }
  for (int c = sp; c < W; ++c) {
    const size_t row = ((size_t)b * W + c) * K;
    for (int i = 0; i < K; ++i) {
      scores[row + i] = kNegInf;
      besti[row + i] = 0;
    }
  }
}

}  // namespace

// key/cnt int32 [B,W,K], cov int32 [B,W], lead/span int32 [B], seed u8 [B]
// -> scores int32 [B,W,K], besti int8 [B,W,K]. Returns the launch's
// cudaGetLastError() (0 on success); K must be in 1..64.
extern "C" int np2t_consensus_dp(const void* key, const void* cnt,
                                 const void* cov, const void* lead,
                                 const void* seed, const void* span,
                                 void* scores, void* besti, int B, int W,
                                 int K, void* stream) {
  if (K < 1 || K > kMaxK || B < 0 || W < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const dim3 block(128);
  const dim3 grid((B + 127) / 128);
  cudaStream_t s = (cudaStream_t)stream;
  const int* k = (const int*)key;
  const int* n = (const int*)cnt;
  const int* cv = (const int*)cov;
  const int* ld = (const int*)lead;
  const uint8_t* sd = (const uint8_t*)seed;
  const int* sp = (const int*)span;
  int* sc = (int*)scores;
  int8_t* bi = (int8_t*)besti;
  if (K == 8) {
    dp_v2_kernel<8><<<grid, block, 0, s>>>(k, n, cv, ld, sd, sp, sc, bi, B, W, K);
  } else if (K == 48) {
    dp_v2_kernel<48><<<grid, block, 0, s>>>(k, n, cv, ld, sd, sp, sc, bi, B, W, K);
  } else {
    dp_v2_kernel<0><<<grid, block, 0, s>>>(k, n, cv, ld, sd, sp, sc, bi, B, W, K);
  }
  return (int)cudaGetLastError();
}
