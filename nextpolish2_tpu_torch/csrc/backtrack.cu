// Consensus backtrack walk + output pack for Hopper (sm_90a), plain C
// interface.
//
// Replaces the XLA scan nextpolish2_tpu/ops/consensus.py::
// _backtrack_scan_packed together with _backtrack_state_tables,
// _backtrack_start and pack_backtrack_out: as a chain of PyTorch ops the
// walk costs about W+128 launches per chunk; here it is one launch.
//
// What it computes. The start state is the LAST maximum slot of the scores
// at last_col (all-NEG_INF columns start at slot K-1). Each of max_steps
// steps emits the current state's 15-bit word
//     word = qv<<7 | dec<<6 | (cov<2)<<5 | (q3!=4)<<4 | q3
// with qv = min(cnt*100 / cov, 255) (0 when cov == 0), and moves to the
// state's successor (same or previous column, slot besti). A terminal state
// (head b2, the seeded anchor column, or column < 0 next) stays on itself;
// the walk is alive until it first stays on a state, and words emitted
// after that have bit 4 (valid) cleared. The row ends with the meta quad
// (best score, steps alive, still alive after the last step, lvl_over = 0)
// as lo/hi u16 pairs: the whole pack_backtrack_out array, so the chunk's
// one device-to-host copy is this output.
//
// Bound: by bytes (the 13 B of each visited state, the start column and the
// packed output). What the kernel waits on is the chase: up to max_steps
// dependent reads per window, with only 128-512 windows in a chunk. The
// design makes each link of the chain a shared-memory read and takes
// everything else off it.
//
// Design: one warp per window, one warp per block, so the walks of a chunk
// spread over the whole card.
//  - start: a warp max over the K scores, then the highest slot holding it
//    (ballot).
//  - chase: the walk only ever moves to the same or the previous column, so
//    key and besti are staged in tiles of 64 columns, walking downwards, by
//    cp.async into a ring of four tiles, two tiles ahead of the walk. When
//    a tile has arrived the lanes boil its states down to one byte each
//    (successor slot, same-column bit, head bit): all the chase needs. The
//    32 lanes walk together, every lane reading the same byte (a broadcast,
//    no divergence); a step is one shared-memory read and a few integer
//    operations, without a branch: steps run in blocks of 8 between two
//    looks at the tile ring, and a dead walk's steps change nothing.
//    Visited states go to a shared buffer.
//  - emit: the words do not depend on each other, so every 1024 steps, and
//    when the walk has died, the lanes compute the words of the recorded
//    states in parallel (gathering key, cnt and cov of visited states only)
//    and store them side by side; the dead tail is one word (the terminal
//    state's, bit 4 cleared) filled in parallel, not walked.
// besti must lie in [0, K), as the DP kernels write it.

#include "dp_common.cuh"

namespace {

using namespace np2t;

constexpr int kTile = 64;       // columns per staged tile (a multiple of 16)
constexpr int kRing = 4;        // tiles in the ring (a power of two): the one
                                // being left, the walk's, the next, one loading
constexpr int kBlock = 8;       // branch-free steps between two looks at the ring
constexpr int kVisited = 1024;  // steps walked between two emissions
constexpr unsigned kSameBit = 0x40, kHeadBit = 0x80;  // of a state's byte

__host__ __device__ constexpr size_t bt_smem_bytes(int K) {
  return (size_t)kRing * kTile * K * 5 + kVisited * 4;
}

__global__ void __launch_bounds__(32)
backtrack_kernel(const int* __restrict__ key, const int* __restrict__ cnt,
                 const int* __restrict__ cov, const int* __restrict__ scores,
                 const int8_t* __restrict__ besti,
                 const int* __restrict__ last_col,
                 const uint8_t* __restrict__ seed, uint16_t* __restrict__ out,
                 int W, int K, int max_steps) {
  extern __shared__ int4 smem4[];
  const int tk = kTile * K;
  int* const key_s = reinterpret_cast<int*>(smem4);         // [ring][tk]
  int* const visited = key_s + kRing * tk;                  // [kVisited]
  // besti as staged, then each state's byte: [ring][tk]
  uint8_t* const code_s = reinterpret_cast<uint8_t*>(visited + kVisited);

  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  const size_t bw = (size_t)b * W;
  // a window wider than the chunk (flagged for the host fallback) starts at
  // the last column, as the clamped gather of the JAX program does
  const int lc = min(max(last_col[b], 0), W - 1);
  const bool seed_b = seed[b] != 0;
  uint16_t* const row_out = out + (size_t)b * (max_steps + 8);
  const bool vec_w = ((size_t)W * K) % 4 == 0;   // key rows 16-byte aligned
  const bool vec_b = ((size_t)W * K) % 16 == 0;  // besti rows likewise

  // start: the last max slot at last_col
  const int* sc = scores + (bw + lc) * K;
  const bool has0 = lane < K, has1 = lane + 32 < K;
  const int v0 = has0 ? sc[lane] : INT32_MIN;
  const int v1 = has1 ? sc[lane + 32] : INT32_MIN;
  const int best = __reduce_max_sync(kFullMask, max(v0, v1));
  const unsigned at_lo = __ballot_sync(kFullMask, has0 && v0 == best);
  const unsigned at_hi = __ballot_sync(kFullMask, has1 && v1 == best);
  const int start = at_hi ? 63 - __clz(at_hi) : 31 - __clz(at_lo);

  // the 15-bit word of state (c, s), read from device memory
  auto word_of = [&](int c, int s) {
    const size_t idx = (bw + c) * K + s;
    const int k = key[idx];
    const int cv = cov[bw + c];
    const int flags = (k >> 12) & 0xF;
    const int q2 = (k >> 4) & 0xF;
    const int q3 = k & 0xF;
    int qv = cv > 0 ? (cnt[idx] * 100) / (cv > 1 ? cv : 1) : 0;
    qv = qv > 255 ? 255 : qv;
    const bool b2_same = (flags & 0b0101) == 0b0101 || (flags & 1);
    const int nc = b2_same ? c : c - 1;
    const bool alive_nxt = q2 != kHeadQ && !(seed_b && c == 2) && nc >= 0;
    const bool dec = alive_nxt && !b2_same;
    return ((qv << 7) | q3 | ((q3 != 4) << 4) | ((cv < 2) << 5) |
            ((int)dec << 6)) & 0x7FFF;
  };

  // tile q (columns q*kTile ...) -> ring slot q % kRing; one (possibly
  // empty) group per call keeps the wait counts uniform
  auto prefetch = [&](int q) {
    if (q >= 0) {
      const int c0 = q * kTile;
      const int n = min(kTile, W - c0) * K;
      const int at = (q % kRing) * tk;
      stage_words(key_s + at, key + (bw + c0) * K, n, lane, 32, vec_w);
      uint8_t* dst = code_s + at;
      const int8_t* src = besti + (bw + c0) * K;
      if (vec_b) {
        for (int i = lane; i < n / 16; i += 32)
          cp_async_16(dst + 16 * i, src + 16 * i);
      } else {
        for (int i = lane; i < n; i += 32) dst[i] = (uint8_t)src[i];
      }
    }
    cp_async_commit();
  };
  // an arrived tile's states -> successor slot | same-column bit | head bit
  auto convert = [&](int q) {
    if (q >= 0) {
      const int n = min(kTile, W - q * kTile) * K;
      const int at = (q % kRing) * tk;
      for (int i = lane; i < n; i += 32) {
        const int k = key_s[at + i];
        const int flags = (k >> 12) & 0xF;
        const bool b2_same = (flags & 0b0101) == 0b0101 || (flags & 1);
        code_s[at + i] = (code_s[at + i] & 0x3F) | (b2_same ? kSameBit : 0) |
                         (((k >> 4) & 0xF) == kHeadQ ? kHeadBit : 0);
      }
    }
    __syncwarp();
  };

  int c = lc, s = start, t = 0;
  bool alive = true;
  if (max_steps > 0) {
    // invariant while the walk is in tile q: tiles q and q-1 have arrived
    // and are converted, tile q-2 is on its way
    int q = lc / kTile;
    prefetch(q);
    prefetch(q - 1);
    cp_async_wait<0>();
    __syncwarp();
    convert(q);
    convert(q - 1);
    prefetch(q - 2);
    const int anchor_c = seed_b ? 2 : -1;
    int t0 = 0;
    // one step; a dead walk's step changes nothing
    auto step = [&]() {
      const unsigned code = code_s[(c & (kRing * kTile - 1)) * K + s];
      const int nc = (code & kSameBit) ? c : c - 1;
      const int ns = code & 0x3F;
      const bool go = alive && !(code & kHeadBit) && c != anchor_c && nc >= 0;
      if (lane == 0) visited[t - t0] = c * kMaxK + s;
      t += alive;
      alive = go && (nc != c || ns != s);
      c = go ? nc : c;
      s = go ? ns : s;
    };
    while (t < max_steps && alive) {
      t0 = t;
      const int t_end = min(max_steps, t0 + kVisited);
      while (t < t_end && alive) {
        if (c / kTile < q) {
          // the walk entered the next tile down: the slot of the tile above
          // the one it left is free for the tile two further down
          --q;
          __syncwarp();
          prefetch(q - 2);
          cp_async_wait<1>();
          __syncwarp();
          convert(q - 1);
        }
        if (t_end - t >= kBlock) {
#pragma unroll
          for (int u = 0; u < kBlock; ++u) step();
        } else {
          step();
        }
      }
      __syncwarp();
#pragma unroll 4
      for (int i = t0 + lane; i < t; i += 32) {
        const int st = visited[i - t0];
        row_out[i] = (uint16_t)word_of(st / kMaxK, st % kMaxK);
      }
      __syncwarp();
    }
    cp_async_wait<0>();
  }
  // the dead tail repeats the terminal state's word with bit 4 cleared
  if (!alive && t < max_steps) {
    const uint16_t dead = (uint16_t)(word_of(c, s) & ~0x10);
    for (int i = t + lane; i < max_steps; i += 32) row_out[i] = dead;
  }
  if (lane < 8) {
    const int m = lane >> 1;
    const unsigned v = m == 0 ? (unsigned)best
                              : (m == 1 ? (unsigned)t
                                        : (m == 2 ? (unsigned)alive : 0u));
    row_out[max_steps + lane] = (uint16_t)((lane & 1) ? v >> 16 : v & 0xFFFF);
  }
}

}  // namespace

// key/cnt int32 [B,W,K], cov int32 [B,W], scores int32 [B,W,K], besti int8
// [B,W,K], last_col int32 [B], seed u8 [B] -> out u16 [B, max_steps+8].
// Launches on `stream` and does not synchronise. Returns the launch's
// cudaGetLastError() (0 on success); K must be in 1..64.
extern "C" int np2t_backtrack(const void* key, const void* cnt,
                              const void* cov, const void* scores,
                              const void* besti, const void* last_col,
                              const void* seed, void* out, int B, int W,
                              int K, int max_steps, void* stream) {
  if (K < 1 || K > kMaxK || B < 0 || W < 1 || max_steps < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  static SmemLimit limit;
  const int rc = limit.raise(backtrack_kernel, bt_smem_bytes(kMaxK));
  if (rc != 0) return rc;
  backtrack_kernel<<<B, 32, bt_smem_bytes(K), (cudaStream_t)stream>>>(
      (const int*)key, (const int*)cnt, (const int*)cov, (const int*)scores,
      (const int8_t*)besti, (const int*)last_col, (const uint8_t*)seed,
      (uint16_t*)out, W, K, max_steps);
  return (int)cudaGetLastError();
}
