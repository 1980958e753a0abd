// K15 link_send: cross-host packet transit, per sending host.
//
// Replaces the device work of shadow_tpu/net/link.py:send (23-80): the
// path lookup, the per-host uniform draw and the loss roll. The emission,
// the drop registers and the counter sums stay with the caller.
//
// Per host h:
//   lat, rel = the one [0, 0] entry on a single-vertex topology, else
//              latency_vv / reliability_vv[vertex[h], table[dst[h]]]
//              with table the global host -> vertex table (the hosts'
//              own vertex column where there is none); dst indexes
//              the table as a JAX gather does: a negative index counts
//              from the end, then it is clipped into the table (a lane
//              that does not send may carry any dst)
//   roll     = mask && lat != NEVER                    (reachable)
//   u        = uniform(fold_in(key_h, counter_h))      (threefry.cuh)
//   counter' = counter + 1 (mod 2^32) where roll
//   kept     = now < bootstrap_end || control || u < rel
//   deliver  = roll && kept;  drop = roll && !kept
//   arrival  = now + lat, wrapping as JAX's int64 add does
// The draw is skipped where its value cannot matter (no roll, bootstrap,
// control packet); the counter advances on every rolled lane all the same.
//
// Bound: bytes (every host's mask, now, control flag and counter, the
// key pair of each host that draws, and with several vertices each
// host's dst, vertex and path lookup, in; deliver, drop, arrival and
// counter out); the two threefry blocks a draw (~240 integer
// operations) take less time at the card's integer rate. Design: one
// thread a host; `now` and `control` may be one value broadcast to every
// host (stride 0).

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr long long kNever = 0x7FFFFFFFFFFFFFFFLL;
constexpr int kThreads = 256;

struct Args {
  const bool* mask;
  const int* dst;
  const long long* now;
  const bool* control;
  const int* vertex;
  const int* vtab;
  const long long* lat_vv;
  const float* rel_vv;
  const long long* keys;
  const long long* ctr;
  bool* o_deliver;
  bool* o_drop;
  long long* o_arrival;
  long long* o_ctr;
  long long bootstrap_end;
  int now_stride, control_stride, H, U, T;
};

__global__ void __launch_bounds__(kThreads) link_send_kernel(Args a) {
  const int h = blockIdx.x * kThreads + threadIdx.x;
  if (h >= a.H) return;
  long long lat;
  float rel;
  if (a.U == 1) {
    lat = a.lat_vv[0];
    rel = a.rel_vv[0];
  } else {
    int d = a.dst[h];
    d = d < 0 ? d + a.T : d;  // a negative index counts from the end
    d = d < 0 ? 0 : (d > a.T - 1 ? a.T - 1 : d);
    const long long e = (long long)a.vertex[h] * a.U + a.vtab[d];
    lat = a.lat_vv[e];
    rel = a.rel_vv[e];
  }
  const long long now = a.now[(long long)h * a.now_stride];
  const bool roll = a.mask[h] && lat != kNever;
  const long long c = a.ctr[h];
  bool kept = now < a.bootstrap_end ||
              a.control[(long long)h * a.control_stride];
  if (roll && !kept) {
    const float u = rng::uniform_at((uint32_t)a.keys[2 * h],
                                    (uint32_t)a.keys[2 * h + 1], (uint32_t)c);
    kept = u < rel;
  }
  a.o_deliver[h] = roll && kept;
  a.o_drop[h] = roll && !kept;
  a.o_arrival[h] =
      (long long)((unsigned long long)now + (unsigned long long)lat);
  a.o_ctr[h] = roll ? (long long)(uint32_t)((uint32_t)c + 1u) : c;
}

}  // namespace

extern "C" int link_send(const void* mask, const void* dst, const void* now,
                         int now_stride, const void* control,
                         int control_stride, const void* vertex,
                         const void* vtab, int T, const void* lat_vv,
                         const void* rel_vv, int U, const void* keys,
                         const void* ctr, long long bootstrap_end,
                         void* o_deliver, void* o_drop, void* o_arrival,
                         void* o_ctr, int H, void* stream) {
  Args a{(const bool*)mask, (const int*)dst, (const long long*)now,
         (const bool*)control, (const int*)vertex, (const int*)vtab,
         (const long long*)lat_vv, (const float*)rel_vv,
         (const long long*)keys, (const long long*)ctr, (bool*)o_deliver,
         (bool*)o_drop, (long long*)o_arrival, (long long*)o_ctr,
         bootstrap_end, now_stride, control_stride, H, U, T};
  if (H > 0) {
    link_send_kernel<<<(H + kThreads - 1) / kThreads, kThreads, 0,
                       (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}
