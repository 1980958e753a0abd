// K21 cpu_serialize: the CPU model's serialization of each host's events.
//
// Replaces the CPU model of shadow_tpu/core/engine.py, both forms:
// the micro-step loop body's chain (904-966) and run_matrix's cummax
// (1224-1254). A loaded host's events execute one after another on its
// virtual CPU: event k of a host runs at
//   exec_k = max(t_k, exec_{k-1} + cost),  exec_{-1} + cost = cpu_avail,
// over the W columns of its row (the dense window's K, or the G events a
// micro-step took), in 64-bit integer arithmetic.
//
// matrix = 1, the JAX package's matrix form, for every cell k:
//   u_k    = max over real cells j <= k of (t_j - j * cost), floored at
//            -(1 << 62) (an empty cell, time NEVER, adds the floor)
//   exec_k = max(u_k, cpu_avail) + k * cost on a real cell, t_k on an
//            empty one;
//   last   = exec at index (real cells - 1);
// matrix = 0, the loop body's chain, over every column (NEVER + cost
// wraps, as int64 arithmetic does in JAX):
//   exec_0 = max(t_0, cpu_avail); exec_k = max(t_k, exec_{k-1} + cost);
//   last   = exec of the last real column.
// The two agree wherever a host's real cells are a prefix of its row.
// Both: cpu_avail' = last + cost where the host has a real event (on the
// loop path its column 0), else cpu_avail; delay = sum over real cells of
// exec_k - t_k, over all hosts.
//
// Output: one int64 buffer, [H * W exec | H cpu_avail' | delay].
//
// Bound: bytes. It reads each time and 16 bytes a host, and writes each
// exec time, 8 bytes a host and the sum. Design: one thread a host runs
// its row in order (the chain is sequential along k); a warp sums its
// hosts' delays by shuffles and one lane adds them to the sum word with a
// 64-bit atomic (integer, so the order of the adds changes nothing). The
// C entry clears the word first.

#include <cuda_runtime.h>

namespace {

constexpr long long kNever = 0x7FFFFFFFFFFFFFFFLL;
constexpr long long kEmpty = -(1LL << 62);
constexpr int kBlock = 128;

__device__ __forceinline__ long long wrap_add(long long a, long long b) {
  return (long long)((unsigned long long)a + (unsigned long long)b);
}

__global__ void __launch_bounds__(kBlock) cpu_serialize_kernel(
    const long long* __restrict__ t, const long long* __restrict__ cost,
    const long long* __restrict__ avail, long long* __restrict__ o_exec,
    long long* __restrict__ o_avail, unsigned long long* __restrict__ o_delay, int H, int W, int matrix) {
  const int h = blockIdx.x * kBlock + threadIdx.x;
  unsigned long long delay = 0ull;
  if (h < H) {
    const long long c = cost[h], a = avail[h];
    const long long* th = t + (long long)h * W;
    long long* eh = o_exec + (long long)h * W;
    long long last;
    bool busy;
    if (matrix) {
      long long u = kEmpty;
      int n = 0;
      for (int k = 0; k < W; ++k) {
        const long long tk = th[k];
        const long long kc = (long long)k * c;
        long long ek = tk;
        if (tk != kNever) {
          u = max(u, tk - kc);
          ek = max(u, a) + kc;
          ++n;
          delay += (unsigned long long)(ek - tk);
        }
        eh[k] = ek;
      }
      last = eh[n > 0 ? n - 1 : 0];
      busy = n > 0;
    } else {
      long long prev = max(th[0], a);
      eh[0] = prev;
      busy = th[0] != kNever;
      last = prev;
      if (busy) delay += (unsigned long long)(prev - th[0]);
      for (int k = 1; k < W; ++k) {
        const long long tk = th[k];
        prev = max(tk, wrap_add(prev, c));
        eh[k] = prev;
        if (tk != kNever) {
          last = prev;
          delay += (unsigned long long)(prev - tk);
        }
      }
    }
    o_avail[h] = busy ? wrap_add(last, c) : a;
  }
  for (int s = 16; s > 0; s >>= 1)
    delay += __shfl_down_sync(0xFFFFFFFFu, delay, s);
  if ((threadIdx.x & 31) == 0 && delay != 0ull) atomicAdd(o_delay, delay);
}

}  // namespace

extern "C" int cpu_serialize(const void* t, const void* cost,
                             const void* avail, void* out, int H, int W,
                             int matrix, void* stream) {
  long long* o = (long long*)out;
  const long long hw = (long long)H * W;
  cudaStream_t st = (cudaStream_t)stream;
  cudaMemsetAsync(o + hw + H, 0, sizeof(long long), st);
  if (H > 0 && W > 0) {
    cpu_serialize_kernel<<<(H + kBlock - 1) / kBlock, kBlock, 0, st>>>(
        (const long long*)t, (const long long*)cost,
        (const long long*)avail, o, o + hw,
        (unsigned long long*)(o + hw + H), H, W, matrix);
  }
  return (int)cudaGetLastError();
}
