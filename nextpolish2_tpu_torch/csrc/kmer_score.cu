// Fused allele scorer for Hopper (sm_90a), plain C interface: the minimum
// k-mer count of each allele of a batch, from the raw base codes.
//
// Replaces the jitted XLA function nextpolish2_tpu/ops/kmer_score.py::
// device_min_kscores_jit: codes uint8 [L] (the alleles joined, separated
// and padded by codes >= 4), starts int32 [S] (each allele's first offset,
// ascending; padding repeats L) -> int32 [S]. For every end position j
// whose k codes c[j-k+1 .. j] are all below 4 (k < 32): the canonical
// 2k-bit k-mer min(forward, reverse complement), its yak hash, the count
// that the table holds for it (0 if absent or below min_count). Position j
// belongs to allele #{i >= 1 : starts[i] <= j}. Each allele gets the
// minimum over its valid end positions, 0 where it has none. Where JAX
// works on two uint32 planes (the TPU has no 64-bit words), this kernel
// uses native unsigned 64-bit arithmetic, so the hash's shifts are logical
// and its sums wrap as yak's do. Counts are non-negative (the table's come
// from yak's u16 counters), so their unsigned order is the signed one.
//
// Bound: by bytes: 1 B a base and 4 B an allele, streamed, plus one random
// 32 B sector a probe (the 16-byte slot entry of kmer_common.cuh). The
// design keeps everything else off the memory system:
//   - a warp owns a strip of 32 * kRun consecutive end positions, each lane
//     a run of kRun of them (16 below kLongFrom bases, where more, shorter
//     strips spread a small batch over the SMs; 32 from there on, where
//     the halo and the search weigh less); a lane reads its run and a
//     32-byte halo before
//     it with 16-byte loads into registers, and rolls the forward and
//     reverse-complement k-mers over them, one shift-or a base (a code >= 4
//     resets the run of valid bases), instead of k loads a position;
//   - a warp searches `starts` once a strip, 32 points a round, then finds
//     each lane's allele among the next boundaries held in registers; the
//     lanes walk forward through `starts` as their positions cross allele
//     boundaries: no search a position;
//   - positions are probed kGroup at a time with their chains in flight
//     together (probe_chains);
//   - minima are kept per allele in registers. An allele inside one run is
//     written directly; one that crosses runs within the strip is reduced
//     across those lanes (match, then warp minimum) and written by one of
//     them; only an allele that crosses strips takes an atomicMin.
// One launch a call (after one memset): the output and a counter start at
// 0xFFFFFFFF, alleles with no position (start >= L) are zeroed by every
// thread's first loop, and the last warp to finish turns the strip-crossing
// alleles that no valid position reached into 0.

#include "kmer_common.cuh"

namespace {

using namespace np2t_kmer;

constexpr int kShortRun = 16;      // end positions a lane, L < kLongFrom
constexpr int kLongRun = 32;       // end positions a lane, L >= kLongFrom
constexpr int kLongFrom = 1 << 19;
constexpr int kGroup = 4;          // positions probed together
constexpr unsigned kNone = 0xFFFFFFFFu;
constexpr unsigned kFull = 0xFFFFFFFFu;

// The allele of position x, #{i in [1, S) : starts[i] <= x}, for each lane
// of a warp whose targets ascend with the lane, x0 the lowest: one 32-ary
// search of `starts` for x0 (a ballot a round: log32(S) rounds), then the
// boundaries after it, 32 at a time in the lanes' registers, counted by
// shuffles. Called by all 32 lanes.
__device__ __forceinline__ int strip_alleles(const int* __restrict__ starts,
                                             int S, int x, int x0,
                                             int lane) {
  // first i in [lo, hi) with starts[i] > x0: all below lo are <= x0 (index
  // 0 counts as such), all from hi on are above
  int lo = 1, hi = S;
  while (lo < hi) {
    const int stride = (hi - lo + 31) / 32;
    const int p = lo + lane * stride;
    const bool le = p < hi && __ldg(starts + p) <= x0;
    const int c = __popc(__ballot_sync(kFull, le));  // a prefix of lanes
    const int p_c = lo + c * stride;
    if (c > 0) lo += (c - 1) * stride + 1;
    if (p_c < hi) hi = p_c;
  }
  int r = -1;
  for (int base = lo;; base += 32) {
    const int v = base + lane < S ? __ldg(starts + base + lane) : 0x7FFFFFFF;
    int n = 0;
    for (int j = 0; j < 32; ++j) n += __shfl_sync(kFull, v, j) <= x;
    if (r < 0 && n < 32) r = base + n;
    if (!__any_sync(kFull, r < 0)) break;
  }
  return r - 1;
}

__device__ __forceinline__ unsigned final_min(unsigned m) {
  return m == kNone ? 0u : m;
}

// out (S entries), then the finish counter, then one crossing allele id a
// strip (-1 where none)
template <int kRun>
__global__ void __launch_bounds__(kThreads)
kmer_score_kernel(const int4* __restrict__ tab,
                  const uint8_t* __restrict__ codes,
                  const int* __restrict__ starts, unsigned* __restrict__ out,
                  int L, int S, int ksize, uint32_t mask, int min_count,
                  int n_probes) {
  unsigned* counter = out + S;
  int* cross = (int*)(out + S + 1);
  constexpr int kStrip = 32 * kRun;  // end positions a warp
  constexpr int kWords = (32 + kRun) / 4;
  const int n_strips = (L + kStrip - 1) / kStrip;
  const long long T = (long long)gridDim.x * blockDim.x;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int n_warps = (int)(T >> 5);
  const int warp = (int)(t >> 5);

  // alleles that own no position (allele 0 always starts at 0)
  for (long long i = t + 1; i < S; i += T)
    if (__ldg(starts + i) >= L) out[i] = 0u;

  const uint64_t kmask = (1ull << (2 * ksize)) - 1;
  const int rshift = 2 * (ksize - 1);
  for (int strip = warp; strip < n_strips; strip += n_warps) {
    const int a = strip * kStrip + lane * kRun;  // this lane's run [a, b)
    const int b = min(a + kRun, L);
    const bool active = a < L;
    // codes [a - 32, a + kRun) as little-endian words; outside [0, L): 4
    uint32_t w[kWords];
    if (active && a >= 32 && a + kRun <= L) {
      const int4* src = (const int4*)(codes + a - 32);
#pragma unroll
      for (int v = 0; v < kWords / 4; ++v) {
        const int4 q = __ldg(src + v);
        w[4 * v] = (uint32_t)q.x;
        w[4 * v + 1] = (uint32_t)q.y;
        w[4 * v + 2] = (uint32_t)q.z;
        w[4 * v + 3] = (uint32_t)q.w;
      }
    } else {
#pragma unroll
      for (int v = 0; v < kWords; ++v) {
        uint32_t word = 0;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int p = a - 32 + 4 * v + u;
          const uint32_t c = (active && p >= 0 && p < L) ? __ldg(codes + p)
                                                         : 4u;
          word |= c << (8 * u);
        }
        w[v] = word;
      }
    }
    // roll over the halo: the state at position a - 1
    uint64_t fwd = 0, rev = 0;
    int run = 0;
#pragma unroll
    for (int u = 0; u < 32; ++u) {
      const uint32_t c = (w[u >> 2] >> (8 * (u & 3))) & 0xFFu;
      if (c < 4) {
        fwd = ((fwd << 2) | c) & kmask;
        rev = (rev >> 2) | ((uint64_t)(c ^ 3u) << rshift);
        ++run;
      } else {
        run = 0;
      }
    }
    // the allele holding position a - 1 (0 for a = 0); it crosses into this
    // run from the left unless the run starts the batch
    const int strip0 = strip * kStrip;
    int sid = strip_alleles(starts, S, a - 1, strip0 - 1, lane);
    bool from_left = a > 0;
    int nxt = sid + 1 < S ? __ldg(starts + sid + 1) : 0x7FFFFFFF;
    unsigned m = kNone;           // minimum of allele sid over this run
    bool has_left = false;        // the left-crossing allele's partial
    int left_sid = -1;
    unsigned left_min = kNone;
#pragma unroll
    for (int q = 0; q < kRun / kGroup; ++q) {
      int qh[kGroup], ql[kGroup], count[kGroup];
      uint32_t idx[kGroup], stride[kGroup];
      bool valid[kGroup], live[kGroup];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        const int u = 32 + q * kGroup + g;
        const uint32_t c = (w[u >> 2] >> (8 * (u & 3))) & 0xFFu;
        if (c < 4) {
          fwd = ((fwd << 2) | c) & kmask;
          rev = (rev >> 2) | ((uint64_t)(c ^ 3u) << rshift);
          ++run;
        } else {
          run = 0;
        }
        valid[g] = a + q * kGroup + g < b && run >= ksize;
        const uint64_t h = yak_hash64(fwd < rev ? fwd : rev, kmask);
        const uint32_t s10 = (uint32_t)(h >> 10);
        qh[g] = (int)(h >> 32);
        ql[g] = (int)(uint32_t)h;
        idx[g] = (s10 ^ ((uint32_t)h << 7)) & mask;
        stride[g] = (s10 | 1u) & mask;
        live[g] = valid[g] && n_probes > 0;
      }
      probe_chains<kGroup>(tab, qh, ql, idx, stride, live, count, mask,
                           n_probes);
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        const int j = a + q * kGroup + g;
        if (j >= b) continue;
        while (nxt <= j) {  // allele sid ends before j
          if (!from_left) {
            out[sid] = final_min(m);  // it lies inside this run
          } else if (j > a) {
            has_left = true;          // it came from the left, ends here
            left_sid = sid;
            left_min = m;
          }                           // (else it ended before this run)
          from_left = false;
          m = kNone;
          ++sid;
          nxt = sid + 1 < S ? __ldg(starts + sid + 1) : 0x7FFFFFFF;
        }
        if (valid[g]) {
          const unsigned v = count[g] >= min_count ? (unsigned)count[g] : 0u;
          m = v < m ? v : m;
        }
      }
    }
    // the allele open at the run's end, and whether it goes on past b
    const bool to_right = active && b < L && nxt > b;
    if (active && from_left) {  // one allele spans the whole run
      has_left = true;
      left_sid = sid;
      left_min = m;
    } else if (active && !to_right) {
      out[sid] = final_min(m);  // it lies inside this run
    }
    const bool span_right = active && from_left && to_right;
    // the next lane's left-crossing allele is this lane's open one
    const unsigned right_min = to_right ? m : kNone;
    const unsigned from_prev =
        __shfl_sync(kFull, right_min, lane ? lane - 1 : 0);
    if (has_left && lane > 0 && from_prev < left_min) left_min = from_prev;
    // lanes that share a left-crossing allele reduce their partials
    const int key = has_left ? left_sid : -1 - lane;
    const unsigned group = __match_any_sync(kFull, key);
    const unsigned gmin = __reduce_min_sync(group, left_min);
    const unsigned spans = __ballot_sync(kFull, span_right);
    const int first = __ffs(group) - 1, last = 31 - __clz(group);
    if (has_left && lane == first) {
      const bool whole = !(first == 0 && a > 0) && !((spans >> last) & 1u);
      if (whole) out[left_sid] = final_min(gmin);
      else if (gmin != kNone) atomicMin(out + left_sid, gmin);
    }
    // an allele that starts in the last run and leaves the strip
    if (lane == 31 && to_right && !from_left && m != kNone)
      atomicMin(out + sid, m);
    if (lane == 0) cross[strip] = has_left ? left_sid : -1;
  }

  // the last warp to finish zeroes the strip-crossing alleles that no
  // valid position reached. Each lane fences its own stores to out[] and
  // cross[]; the __syncwarp then orders every lane's fence before lane 0's
  // counter bump (a fence orders only its own thread's writes), as in the
  // threadFenceReduction pattern with the warp for the block
  __threadfence();
  __syncwarp();
  unsigned done = 0;
  if (lane == 0) done = atomicAdd(counter, 1u) + 1u;  // counter starts at -1
  done = (unsigned)__shfl_sync(kFull, (int)done, 0);
  if (done == (unsigned)n_warps - 1u) {
    // lane 0 saw every other warp's bump; the barrier and fence order its
    // observation before every lane's reads below
    __syncwarp();
    __threadfence();
    for (int s = lane; s < n_strips; s += 32) {
      const int sid = __ldcg(cross + s);
      if (sid >= 0 && __ldcg(out + sid) == kNone) out[sid] = 0u;
    }
  }
}

// the kernel at run length kRun, on one warp a block, as many blocks as
// its strips or the card holds at once
template <int kRun>
void launch_score(const int4* entries, const uint8_t* codes,
                  const int* starts, unsigned* out, int L, int S, int ksize,
                  uint32_t mask, int min_count, int n_probes, void* stream) {
  static const int resident = resident_blocks(kmer_score_kernel<kRun>);
  const int n_strips = (L + 32 * kRun - 1) / (32 * kRun);
  NP2T_KMER_LAUNCH(kmer_score_kernel<kRun>,
                   persistent_blocks(n_strips, kThreads / 32, resident),
                   stream, entries, codes, starts, out, L, S, ksize, mask,
                   min_count, n_probes);
}

}  // namespace

// the length of `out` np2t_kmer_score needs for L bases and S alleles: the
// minima, the counter, a crossing allele a strip of the shorter runs
extern "C" int np2t_kmer_score_out_len(int L, int S) {
  return S + 1 + (L + 32 * kShortRun - 1) / (32 * kShortRun);
}

// mask = table size - 1 (a power of two minus one); entries int32 [size, 4]
// and codes 16-byte aligned; out int32 [out_len]: the S minima, then
// scratch, out_len >= np2t_kmer_score_out_len(L, S)
extern "C" int np2t_kmer_score(const void* entries, const void* codes,
                               const void* starts, void* out, int L, int S,
                               int ksize, int mask, int min_count,
                               int n_probes, int out_len, void* stream) {
  if (L < 0 || S < 0 || ksize < 1 || ksize > 31 || mask < 0 ||
      n_probes < 0 || ((uintptr_t)entries & 15) != 0 ||
      ((uintptr_t)codes & 15) != 0 ||
      out_len < np2t_kmer_score_out_len(L, S))
    return (int)cudaErrorInvalidValue;
  if (S == 0) return 0;
  const cudaError_t rc = cudaMemsetAsync(
      out, 0xFF, ((size_t)S + 1) * sizeof(int), (cudaStream_t)stream);
  if (rc != cudaSuccess) return (int)rc;
  if (L < kLongFrom)
    launch_score<kShortRun>((const int4*)entries, (const uint8_t*)codes,
                            (const int*)starts, (unsigned*)out, L, S, ksize,
                            (uint32_t)mask, min_count, n_probes, stream);
  else
    launch_score<kLongRun>((const int4*)entries, (const uint8_t*)codes,
                           (const int*)starts, (unsigned*)out, L, S, ksize,
                           (uint32_t)mask, min_count, n_probes, stream);
  return (int)cudaGetLastError();
}
