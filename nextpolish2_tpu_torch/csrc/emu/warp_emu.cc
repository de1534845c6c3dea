// CPU rehearsal of the three DP kernels and the two k-mer kernels: the CUDA
// sources themselves, compiled by the host compiler against the stand-in
// cuda_runtime.h of this directory, run through their C entry points one
// warp at a time.
//
//   g++ -std=c++17 -O1 -DNP2T_EMULATE -I csrc/emu -o warp_emu csrc/emu/warp_emu.cc
//   warp_emu DIR KERNEL B W K      KERNEL: v2 | base | dynk
//   warp_emu DIR lookup MIN_COUNT N_PROBES
//   warp_emu DIR lookup_sharded MIN_COUNT N_PROBES SHARD
//   warp_emu DIR score K MIN_COUNT N_PROBES
//
// For the DP kernels DIR holds the raw little-endian inputs key, cnt (int32
// [B,W,K]), cov, ns (int32 [B,W]), lead, span (int32 [B]) and seed (uint8
// [B]); the outputs go to DIR/scores (int32) and DIR/besti (int8). For the
// k-mer kernels it holds entries (int32 [S,4], the table's slot entries)
// and the queries q_hi, q_lo, q_slot (int32 [Q]; for the sharded lookup
// also q_shard, and the entries are one shard's), or the codes (uint8 [L])
// and starts (int32 [N]); the output goes to DIR/out (int32 [Q] or [N]).
// Exit code 3: the lanes of a warp diverged at a warp-wide intrinsic; 5: a
// kernel wrote past its outputs. It checks the kernels' logic (the lane
// mapping, trip counts, tile and alignment paths); what only nvcc and the
// card see (registers, the cp.async pipeline, timing) it cannot.
// nextpolish2_tpu_torch/utils/warp_emu.py builds and drives it.

#include <cuda_runtime.h>

#include <stdio.h>
#include <stdlib.h>
#include <ucontext.h>

#include <string>
#include <vector>

// the kernels' `extern __shared__ int4 smem4[]`, in each namespace that
// declares one
constexpr size_t kSmemWords = 64 * 1024;
namespace np2t {
int4 smem4[kSmemWords / 4];
}
namespace {
int4 smem4[kSmemWords / 4];
}

#include "../consensus_dp.cu"
#include "../consensus_dp_base.cu"
#include "../consensus_dp_dynk.cu"
#include "../kmer_lookup.cu"
#include "../kmer_score.cu"

namespace np2t_emu {

int lane = -1;
int block = 0;
int grid = 0;
const int warp_size = 32;

namespace {
ucontext_t main_ctx, lane_ctx[32];
int values[32], ops[32];
unsigned masks[32];
bool done[32];
void (*block_body)(void*);
void* block_arg;

void yield_to_next() {
  const int me = lane, next = (me + 1) % 32;
  lane = next == 0 ? -1 : next;
  swapcontext(&lane_ctx[me], next == 0 ? &main_ctx : &lane_ctx[next]);
}

void lane_main() {
  block_body(block_arg);
  const int me = lane;
  done[me] = true;
  ops[me] = -1;
  for (;;) yield_to_next();  // the scheduler stops once every lane is done
}
}  // namespace

int exchange(Op op, int value, int src, unsigned mask) {
  const int me = lane;
  values[me] = value;
  ops[me] = op;
  masks[me] = mask;
  yield_to_next();  // every lane deposits
  for (int l = 0; l < 32; ++l) {
    if (ops[l] != op) {
      fprintf(stderr, "warp_emu: block %d: lane %d is at intrinsic %d, lane "
              "%d at %d\n", block, me, (int)op, l, ops[l]);
      exit(3);
    }
  }
  unsigned r = 0;
  if (op == kShfl) r = (unsigned)values[src & 31];
  for (int l = 0; l < 32; ++l) {
    if (op == kBallot && values[l]) r |= 1u << l;
    if (op == kOr) r |= (unsigned)values[l];
    if (op == kMax) r = std::max(r, (unsigned)values[l]);
    if (op == kMatch && values[l] == values[me]) r |= 1u << l;
  }
  if (op == kMin) {
    r = 0xFFFFFFFFu;
    for (int l = 0; l < 32; ++l)
      if ((masks[me] >> l) & 1u) r = std::min(r, (unsigned)values[l]);
  }
  yield_to_next();  // every lane reads before any deposits again
  return (int)r;
}

void run_blocks(int blocks, void (*body)(void*), void* arg) {
  static std::vector<char> stacks(32 * (1 << 18));
  block_body = body;
  block_arg = arg;
  grid = blocks;
  for (block = 0; block < blocks; ++block) {
    memset(np2t::smem4, 0x5a, sizeof(np2t::smem4));
    memset(::smem4, 0x5a, sizeof(::smem4));
    for (int l = 0; l < 32; ++l) {
      done[l] = false;
      ops[l] = -2;
      getcontext(&lane_ctx[l]);
      lane_ctx[l].uc_stack.ss_sp = &stacks[(size_t)l << 18];
      lane_ctx[l].uc_stack.ss_size = 1 << 18;
      lane_ctx[l].uc_link = &main_ctx;
      makecontext(&lane_ctx[l], lane_main, 0);
    }
    for (;;) {
      int n_done = 0;
      for (int l = 0; l < 32; ++l) n_done += done[l];
      if (n_done == 32) break;
      if (n_done != 0) {
        fprintf(stderr, "warp_emu: block %d: %d lanes ended while the others "
                "wait at a warp-wide intrinsic\n", block, n_done);
        exit(3);
      }
      lane = 0;
      swapcontext(&main_ctx, &lane_ctx[0]);
    }
  }
  lane = -1;
}

}  // namespace np2t_emu

template <typename T>
static std::vector<T> read_all(const std::string& path) {
  FILE* f = fopen(path.c_str(), "rb");
  if (f == nullptr) {
    fprintf(stderr, "warp_emu: cannot open %s\n", path.c_str());
    exit(4);
  }
  fseek(f, 0, SEEK_END);
  const long n = ftell(f);
  rewind(f);
  std::vector<T> v(n / sizeof(T));
  if (fread(v.data(), 1, n, f) != (size_t)n) exit(4);
  fclose(f);
  return v;
}

template <typename T>
static void write_all(const std::string& path, const T* p, size_t n) {
  FILE* f = fopen(path.c_str(), "wb");
  if (f == nullptr || fwrite(p, sizeof(T), n, f) != n) exit(4);
  fclose(f);
}

// a copy of `v` in 16-byte aligned storage, as device allocations are
template <typename T>
static std::vector<int4> aligned_copy(const std::vector<T>& v) {
  std::vector<int4> out(v.size() * sizeof(T) / 16 + 1);
  memcpy(out.data(), v.data(), v.size() * sizeof(T));
  return out;
}

// kmer_lookup or kmer_score through its C entry point; out goes to DIR/out
static int run_kmer(const std::string& dir, const std::string& kernel,
                    int argc, char** argv) {
  auto entries = read_all<int>(dir + "/entries");
  const int size = (int)(entries.size() / 4);
  if (entries.size() % 4 || size < 1 || (size & (size - 1))) {
    fprintf(stderr, "warp_emu: entries do not hold [2^n, 4] int32\n");
    return 4;
  }
  const std::vector<int4> tab = aligned_copy(entries);
  constexpr int kGuard = 64;
  std::vector<int> out;
  int n_out, n_write, rc;
  const bool sharded = kernel == "lookup_sharded" && argc == 6;
  if ((kernel == "lookup" && argc == 5) || sharded) {
    auto q_hi = read_all<int>(dir + "/q_hi");
    auto q_lo = read_all<int>(dir + "/q_lo");
    auto q_slot = read_all<int>(dir + "/q_slot");
    auto q_shard = sharded ? read_all<int>(dir + "/q_shard") : q_hi;
    n_out = (int)q_hi.size();
    if (q_lo.size() != q_hi.size() || q_slot.size() != q_hi.size() ||
        q_shard.size() != q_hi.size()) {
      fprintf(stderr, "warp_emu: query planes differ in length\n");
      return 4;
    }
    n_write = n_out;
    out.assign(n_out + kGuard, 0x77777777);
    if (sharded)
      rc = np2t_kmer_lookup_sharded(tab.data(), q_hi.data(), q_lo.data(),
                                    q_slot.data(), q_shard.data(), out.data(),
                                    n_out, size - 1, atoi(argv[3]),
                                    atoi(argv[4]), atoi(argv[5]), nullptr);
    else
      rc = np2t_kmer_lookup(tab.data(), q_hi.data(), q_lo.data(),
                            q_slot.data(), out.data(), n_out, size - 1,
                            atoi(argv[3]), atoi(argv[4]), nullptr);
  } else if (kernel == "score" && argc == 6) {
    auto codes = read_all<uint8_t>(dir + "/codes");
    auto starts = read_all<int>(dir + "/starts");
    const int L = (int)codes.size();
    n_write = (int)starts.size();
    const std::vector<int4> codes16 = aligned_copy(codes);
    const int len = np2t_kmer_score_out_len(L, n_write);
    out.assign(len + kGuard, 0x77777777);
    rc = np2t_kmer_score(tab.data(), codes16.data(), starts.data(),
                         out.data(), L, n_write, atoi(argv[3]), size - 1,
                         atoi(argv[4]), atoi(argv[5]), len, nullptr);
    n_out = len;  // the guard sits behind the scratch
  } else {
    return 2;
  }
  if (rc != 0) {
    fprintf(stderr, "warp_emu: the entry point returned %d\n", rc);
    return 6;
  }
  for (int i = 0; i < kGuard; ++i) {
    if (out[n_out + i] != 0x77777777) {
      fprintf(stderr, "warp_emu: a kernel wrote past its outputs\n");
      return 5;
    }
  }
  write_all(dir + "/out", out.data(), (size_t)n_write);
  return 0;
}

int main(int argc, char** argv) {
  if (argc >= 3 && (std::string(argv[2]) == "lookup" ||
                    std::string(argv[2]) == "lookup_sharded" ||
                    std::string(argv[2]) == "score"))
    return run_kmer(argv[1], argv[2], argc, argv);
  if (argc != 6) {
    fprintf(stderr, "usage: warp_emu DIR v2|base|dynk B W K | lookup "
            "MIN_COUNT N_PROBES | lookup_sharded MIN_COUNT N_PROBES SHARD | "
            "score K MIN_COUNT N_PROBES\n");
    return 2;
  }
  const std::string dir = argv[1], kernel = argv[2];
  const int B = atoi(argv[3]), W = atoi(argv[4]), K = atoi(argv[5]);
  const size_t n = (size_t)B * W * K;
  auto key = read_all<int>(dir + "/key"), cnt = read_all<int>(dir + "/cnt");
  auto cov = read_all<int>(dir + "/cov"), ns = read_all<int>(dir + "/ns");
  auto lead = read_all<int>(dir + "/lead"), span = read_all<int>(dir + "/span");
  auto seed = read_all<uint8_t>(dir + "/seed");
  if (key.size() != n || cnt.size() != n || cov.size() != (size_t)B * W ||
      ns.size() != (size_t)B * W || lead.size() != (size_t)B ||
      span.size() != (size_t)B || seed.size() != (size_t)B) {
    fprintf(stderr, "warp_emu: input sizes do not fit B W K\n");
    return 4;
  }
  // outputs aligned as device allocations are, with a guard behind them
  constexpr int kGuard = 64;
  std::vector<int4> sc4(n / 4 + 1 + kGuard), bi4(n / 16 + 1 + kGuard);
  int* scores = reinterpret_cast<int*>(sc4.data());
  int8_t* besti = reinterpret_cast<int8_t*>(bi4.data());
  memset(scores + n, 0x77, kGuard * 4);
  memset(besti + n, 0x77, kGuard);
  int rc;
  if (kernel == "v2")
    rc = np2t_consensus_dp(key.data(), cnt.data(), cov.data(), lead.data(),
                           seed.data(), span.data(), scores, besti, B, W, K,
                           nullptr);
  else if (kernel == "base")
    rc = np2t_consensus_dp_base(key.data(), cnt.data(), cov.data(),
                                lead.data(), seed.data(), scores, besti, B, W,
                                K, nullptr);
  else if (kernel == "dynk")
    rc = np2t_consensus_dp_dynk(key.data(), cnt.data(), cov.data(), ns.data(),
                                lead.data(), seed.data(), scores, besti, B, W,
                                K, nullptr);
  else
    return 2;
  if (rc != 0) {
    fprintf(stderr, "warp_emu: the entry point returned %d\n", rc);
    return 6;
  }
  for (int i = 0; i < kGuard; ++i) {
    if (scores[n + i] != 0x77777777 || besti[n + i] != 0x77) {
      fprintf(stderr, "warp_emu: a kernel wrote past its outputs\n");
      return 5;
    }
  }
  write_all(dir + "/scores", scores, n);
  write_all(dir + "/besti", besti, n);
  return 0;
}
