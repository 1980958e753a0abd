// The device-queue disciplines' sub-state as the two kernels K22
// qdisc_enqueue and K23 qdisc_dequeue see it: one pointer a field, in the
// order of kernels.QDISC_FIELDS (the JAX package's dict keys of
// shadow_tpu/net/qdisc/pifo.py:init_subs), null where the discipline has
// no such field (pifo: no q_valid, q_bucket, cur_bucket; eiffel: no
// q_len). Every pointer but cls is written in place.
//
// Integer helpers: jnp's floor division and floor modulo, and sums that
// wrap as XLA's and PyTorch's int64 arithmetic do (through uint64, where
// C++ would leave signed overflow undefined).

#pragma once

#include <cuda_runtime.h>

#include "codel_common.cuh"

namespace qdisc {

constexpr int kFields = 29;
constexpr int kMaxP = 12;  // packet trails (P = 13) are not ported
constexpr int kBlock = 128;
constexpr int kWPriority = 4, kWSocket = 10;

struct Plane {
  int* q_payload;  // [H, Q, P]
  int* q_dst;  // [H, Q]
  long long* q_rank;  // [H, Q]
  long long* q_seq;  // [H, Q]
  long long* q_enq_ts;  // [H, Q]
  long long* q_bytes;
  long long* seq;
  const int* cls;
  long long* vtime;
  long long* finish;  // [H, C]
  long long* shape_next;  // [H, C]
  bool* drop_mode;
  long long* interval_expire;
  long long* next_drop;
  int* drop_count;
  int* drop_count_last;
  long long* red_avg;
  long long* red_count;
  long long* enqueues;
  long long* dequeues;
  long long* drops_overflow;
  long long* drops_red;
  long long* drops_codel;
  long long* sojourn_sum;
  long long* depth_peak;
  int* q_len;  // pifo
  bool* q_valid;  // eiffel [H, Q]
  long long* q_bucket;  // eiffel [H, Q]
  long long* cur_bucket;  // eiffel
};

static_assert(sizeof(Plane) == kFields * sizeof(void*),
              "Plane holds the kFields pointers and nothing else");

// the plane from the first kFields values of a C entry's packed array
inline Plane unpack(const long long* a) {
  Plane p;
  void** dst = reinterpret_cast<void**>(&p);
  for (int i = 0; i < kFields; ++i) dst[i] = reinterpret_cast<void*>(a[i]);
  return p;
}

__device__ __forceinline__ long long wadd(long long a, long long b) {
  return (long long)((unsigned long long)a + (unsigned long long)b);
}

__device__ __forceinline__ long long wsub(long long a, long long b) {
  return (long long)((unsigned long long)a - (unsigned long long)b);
}

__device__ __forceinline__ long long wmul(long long a, long long b) {
  return (long long)((unsigned long long)a * (unsigned long long)b);
}

__device__ __forceinline__ long long floor_div(long long a, long long b) {
  const long long q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__device__ __forceinline__ long long floor_mod(long long a, long long b) {
  const long long r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}

__device__ __forceinline__ long long lmax(long long a, long long b) {
  return a > b ? a : b;
}

// a packet's P words, one word a load (a device memcpy of a runtime
// size copies byte by byte)
__device__ __forceinline__ void copy_words(int* to, const int* from, int P) {
  for (int w = 0; w < P; ++w) to[w] = from[w];
}

inline int blocks(int H) { return (H + kBlock - 1) / kBlock; }

}  // namespace qdisc
