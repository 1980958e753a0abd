// K13 nic_refill: the NIC token buckets' lazy refill.
//
// Replaces shadow_tpu/net/nic.py:lazy_refill (127), which the network
// stack calls on every packet it sends or receives (net/stack.py: the
// direct send, the arrival, both pumps and the bulk gate).
//
// Per host h, elementwise:
//   now_tick = floor(now / REFILL_NS)            (JAX's // floors)
//   rem'     = min(cap, rem + (now_tick - tick) * refill)   where
//              now_tick > tick, else rem
//   tick'    = max(tick, now_tick)
// then, where a mask is given, rem' and tick' only on masked lanes. A
// lane whose host has no real event carries now = NEVER, where the
// product overflows: JAX's int64 arithmetic wraps, so the kernel computes
// it in uint64 (signed overflow is undefined in C++), and the mask select
// comes after, as in JAX.
//
// Bound: bytes: five int64 inputs, the mask and two int64 outputs a host.
// Design: one thread a host; `now` may be one value broadcast to every
// host (stride 0), as the bulk gate passes the window start.

#include <cuda_runtime.h>

namespace {

constexpr long long kRefillNs = 1000000LL;
constexpr int kThreads = 256;

__device__ __forceinline__ long long floordiv(long long a, long long b) {
  const long long q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__global__ void __launch_bounds__(kThreads) nic_refill_kernel(
    const long long* __restrict__ rem, const long long* __restrict__ tick,
    const long long* __restrict__ refill, const long long* __restrict__ cap,
    const long long* __restrict__ now, int now_stride,
    const bool* __restrict__ mask, long long* __restrict__ o_rem,
    long long* __restrict__ o_tick, int H) {
  const int h = blockIdx.x * kThreads + threadIdx.x;
  if (h >= H) return;
  const long long r = rem[h], tk = tick[h];
  const long long now_tick = floordiv(now[(long long)h * now_stride],
                                      kRefillNs);
  const unsigned long long gain =
      ((unsigned long long)now_tick - (unsigned long long)tk) *
      (unsigned long long)refill[h];
  const long long sum = (long long)((unsigned long long)r + gain);
  const long long c = cap[h];
  long long nr = sum < c ? sum : c;
  nr = now_tick > tk ? nr : r;
  long long nt = tk > now_tick ? tk : now_tick;
  if (mask != nullptr && !mask[h]) {
    nr = r;
    nt = tk;
  }
  o_rem[h] = nr;
  o_tick[h] = nt;
}

}  // namespace

extern "C" int nic_refill(const void* rem, const void* tick,
                          const void* refill, const void* cap,
                          const void* now, int now_stride, const void* mask,
                          void* o_rem, void* o_tick, int H, void* stream) {
  if (H > 0) {
    nic_refill_kernel<<<(H + kThreads - 1) / kThreads, kThreads, 0,
                        (cudaStream_t)stream>>>(
        (const long long*)rem, (const long long*)tick,
        (const long long*)refill, (const long long*)cap,
        (const long long*)now, now_stride, (const bool*)mask,
        (long long*)o_rem, (long long*)o_tick, H);
  }
  return (int)cudaGetLastError();
}
