// Shared helpers of the NIC kernels (nic_refill, nic_tx, nic_rx,
// nic_gate): floor division as JAX's // computes it (C's / truncates
// toward zero), the token buckets' lazy refill, a packet's wire size,
// and the block size of the admission kernels.
#pragma once

#include <cuda_runtime.h>

namespace nic {

// threads a block of nic_tx, nic_rx and nic_gate: each is one round of
// loads a host, and blocks of 128 spread config 3's 10,240 hosts over 80
// of the card's 132 SMs (64 and 256 timed no faster, PERF.md)
constexpr int kBlock = 128;

constexpr long long kRefillNs = 1000000LL;  // kernels.REFILL_NS
constexpr long long kMtu = 1500;            // kernels.MTU
constexpr int kWProto = 0, kWLen = 3;       // kernels.W_PROTO, W_LEN
constexpr int kProtoTcp = 6;                // kernels.PROTO_TCP
constexpr int kTcpHeader = 40, kUdpHeader = 28;

__device__ __forceinline__ long long floordiv(long long a, long long b) {
  const long long q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// One bucket refilled to `now`, before any mask select: every grid tick
// since `tick` adds `refill`, clamped to `cap` (nic.lazy_refill). A lane
// whose host has no real event carries now = NEVER, where the product
// overflows: JAX's int64 arithmetic wraps, so it is computed in uint64
// (signed overflow is undefined in C++).
__device__ __forceinline__ void refill(long long rem, long long tick,
                                       long long refill, long long cap,
                                       long long now, long long& o_rem,
                                       long long& o_tick) {
  const long long now_tick = floordiv(now, kRefillNs);
  const unsigned long long gain =
      ((unsigned long long)now_tick - (unsigned long long)tick) *
      (unsigned long long)refill;
  const long long sum = (long long)((unsigned long long)rem + gain);
  const long long nr = sum < cap ? sum : cap;
  o_rem = now_tick > tick ? nr : rem;
  o_tick = tick > now_tick ? tick : now_tick;
}

// a packet's wire size from its protocol and length words: the length
// plus the TCP or UDP header, added in int32 as kernels.wire_bytes does
__device__ __forceinline__ long long wire_bytes(int proto, int len) {
  const int hdr = proto == kProtoTcp ? kTcpHeader : kUdpHeader;
  return (long long)(int)((unsigned)len + (unsigned)hdr);
}

// int64 a - b and a + b wrapping as torch's do
__device__ __forceinline__ long long wsub(long long a, long long b) {
  return (long long)((unsigned long long)a - (unsigned long long)b);
}
__device__ __forceinline__ long long wadd(long long a, long long b) {
  return (long long)((unsigned long long)a + (unsigned long long)b);
}

inline int blocks(int H) { return (H + kBlock - 1) / kBlock; }

}  // namespace nic
