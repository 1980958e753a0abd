// CoDel's constants and control law, shared by the router's dequeue
// (K6 codel_dequeue) and the device-queue disciplines' CoDel hook (K23
// qdisc_dequeue), so that the two cannot drift: shadow_tpu/net/codel.py
// (TARGET_NS, INTERVAL_NS, _control_law), which shadow_tpu/net/qdisc/
// drops.py imports.
//
// The control law is next = ts + round(INTERVAL / sqrt(max(count, 1))) in
// float64 with ties to even (jnp.round): an IEEE square root and divide
// (__dsqrt_rn, __ddiv_rn) and rint, never a fast approximation.

#pragma once

#include <cuda_runtime.h>

namespace codel {

constexpr long long kTarget = 10000000LL;
constexpr long long kInterval = 100000000LL;
constexpr int kMtu = 1500;
constexpr int kWProto = 0, kWLen = 3, kProtoTcp = 6;

// a packet's wire size: its length word and the UDP or TCP header
__device__ __forceinline__ long long wire_bytes(const int* words) {
  return (long long)words[kWLen] + (words[kWProto] == kProtoTcp ? 40 : 28);
}

__device__ __forceinline__ long long control_law(int count, long long ts) {
  const double c = (double)(count > 1 ? count : 1);
  return ts + (long long)rint(__ddiv_rn((double)kInterval, __dsqrt_rn(c)));
}

}  // namespace codel
