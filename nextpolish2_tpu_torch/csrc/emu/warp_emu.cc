// CPU rehearsal of the three DP kernels: the CUDA sources themselves, compiled
// by the host compiler against the stand-in cuda_runtime.h of this directory,
// run through their C entry points one warp at a time.
//
//   g++ -std=c++17 -O1 -DNP2T_EMULATE -I csrc/emu -o warp_emu csrc/emu/warp_emu.cc
//   warp_emu DIR KERNEL B W K      KERNEL: v2 | base | dynk
//
// DIR holds the raw little-endian inputs key, cnt (int32 [B,W,K]), cov, ns
// (int32 [B,W]), lead, span (int32 [B]) and seed (uint8 [B]); the outputs go
// to DIR/scores (int32) and DIR/besti (int8). Exit code 3: the lanes of a
// warp diverged at a warp-wide intrinsic; 5: a kernel wrote past its outputs.
// It checks the kernels' logic (the lane mapping, trip counts, tile and
// alignment paths); what only nvcc and the card see (registers, the
// cp.async pipeline, timing) it cannot. nextpolish2_tpu_torch/utils/
// warp_emu.py builds and drives it.

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

namespace np2t_emu {

int lane = -1;
int block = 0;

namespace {
ucontext_t main_ctx, lane_ctx[32];
int values[32], ops[32];
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

int exchange(Op op, int value, int src) {
  const int me = lane;
  values[me] = value;
  ops[me] = op;
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
  }
  yield_to_next();  // every lane reads before any deposits again
  return (int)r;
}

void run_blocks(int blocks, void (*body)(void*), void* arg) {
  static std::vector<char> stacks(32 * (1 << 18));
  block_body = body;
  block_arg = arg;
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

int main(int argc, char** argv) {
  if (argc != 6) {
    fprintf(stderr, "usage: warp_emu DIR v2|base|dynk B W K\n");
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
