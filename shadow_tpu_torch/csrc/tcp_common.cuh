// Shared helpers of the TCP kernels (tcp_demux, tcp_ack, tcp_reorder,
// tcp_out): the JAX package's state numbering, int32 sequence arithmetic
// that wraps as two's complement (done in uint32: signed overflow is
// undefined in C++), floor division (C's / truncates toward zero, JAX's //
// floors), and the launch shape.
#pragma once

#include <cuda_runtime.h>

namespace tcp {

constexpr int kClosed = 0, kListen = 1, kSynSent = 2, kSynReceived = 3;
constexpr int kEstablished = 4, kFinWait1 = 5, kFinWait2 = 6, kClosing = 7;
constexpr int kTimeWait = 8, kCloseWait = 9, kLastAck = 10;
constexpr int kFin = 0x01, kSyn = 0x02, kAck = 0x10;
constexpr long long kRtoMin = 200000000LL, kRtoMax = 60000000000LL;
constexpr int kThreads = 256;

__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}
__device__ __forceinline__ bool seq_lt(int a, int b) { return wsub(b, a) > 0; }
__device__ __forceinline__ bool seq_leq(int a, int b) {
  return wsub(b, a) >= 0;
}
__device__ __forceinline__ int floordiv(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}
__device__ __forceinline__ long long floordiv(long long a, long long b) {
  const long long q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}
// the socket a host's slot names, read as JAX reads it (clipped)
__device__ __forceinline__ int clip_slot(int s, int S) {
  return s < 0 ? 0 : (s > S - 1 ? S - 1 : s);
}

inline int blocks(int H, int threads = kThreads) {
  return (H + threads - 1) / threads;
}

}  // namespace tcp
