// K12 spec_check: the optimistic synchronizer's speculation check.
//
// Replaces the violation signal SimState.xmit_min of
// shadow_tpu/core/engine.py: the loop path's finish (1137-1153, over the
// window's box emissions) and the matrix path after the merge (1365-1414,
// over the window's emission rows), on the global engine.
//
// Over N emission rows (time t, dst, src) and the per-host progress clocks
// done_t [H]: the minimum t over the rows with dst != src, t != NEVER and
// t <= done_t[clip(dst, 0, H - 1)], else NEVER. A row behind its
// destination's clock means a sub-step emitted into a host's processed
// past, and the attempt rolls back. JAX gates the matrix form on whether a
// violation is possible at all; the gate only skips work, so the kernel
// computes the exact form.
//
// Bound: bytes. Each row's time is read once, its dst and src where the
// time is not NEVER, and the clock of each cross-host row's destination
// (a gather). Design: a grid-stride loop,
// each thread keeping its own minimum, a warp shuffle and a block
// reduction in shared memory, then one 64-bit atomicMin a block. Event
// times are non-negative, so unsigned order is their order. A one-thread
// kernel first sets the result to NEVER on the same stream.

#include <cuda_runtime.h>

namespace {

constexpr unsigned long long kNever = 0x7FFFFFFFFFFFFFFFULL;
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1056;  // 8 blocks on each of the 132 SMs

__global__ void spec_init_kernel(unsigned long long* out) { *out = kNever; }

__global__ void __launch_bounds__(kThreads) spec_check_kernel(
    const long long* __restrict__ t, const int* __restrict__ dst,
    const int* __restrict__ src, const long long* __restrict__ done_t,
    long long N, int H, unsigned long long* out) {
  unsigned long long m = kNever;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < N;
       i += (long long)gridDim.x * kThreads) {
    const long long ti = t[i];
    const int d = dst[i];
    if (ti == (long long)kNever || d == src[i]) continue;
    const int c = d < 0 ? 0 : (d > H - 1 ? H - 1 : d);
    if (ti <= done_t[c] && (unsigned long long)ti < m)
      m = (unsigned long long)ti;
  }
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_down_sync(0xFFFFFFFFu, m, off);
    m = o < m ? o : m;
  }
  __shared__ unsigned long long warp_min[kThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_min[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int w = 1; w < kThreads / 32; ++w)
    m = warp_min[w] < m ? warp_min[w] : m;
  if (m != kNever) atomicMin(out, m);
}

}  // namespace

extern "C" int spec_check(const void* t, const void* dst, const void* src,
                          const void* done_t, long long N, int H, void* out,
                          void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  unsigned long long* o = (unsigned long long*)out;
  spec_init_kernel<<<1, 1, 0, s>>>(o);
  if (N > 0 && H > 0) {
    long long blocks = (N + kThreads - 1) / kThreads;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    spec_check_kernel<<<(int)blocks, kThreads, 0, s>>>(
        (const long long*)t, (const int*)dst, (const int*)src,
        (const long long*)done_t, N, H, o);
  }
  return (int)cudaGetLastError();
}
