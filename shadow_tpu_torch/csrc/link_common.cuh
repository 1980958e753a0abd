// Shared by link_send and nic_tx: the path lookup and the loss roll of
// net/link.py:send (shadow_tpu/net/link.py:send), so that the two cannot
// drift apart.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace transit {

constexpr long long kNever = 0x7FFFFFFFFFFFFFFFLL;

// the baked network model a sending host reads
struct Paths {
  const int* vertex;        // [H] each host's own vertex
  const int* vtab;          // [T] global host -> vertex
  const long long* lat_vv;  // [U, U] ns; NEVER = unreachable
  const float* rel_vv;      // [U, U]
  int U, T;
};

// Host h's path to `dst`: the one [0, 0] entry on a single-vertex
// topology (nothing else read), else the entry of h's vertex and dst's.
// dst indexes the table as a JAX gather does: a negative index counts from
// the end, then it is clipped into the table (a lane that does not send
// may carry any dst).
__device__ __forceinline__ void lookup(const Paths& p, int h, int dst,
                                       long long& lat, float& rel) {
  if (p.U == 1) {
    lat = p.lat_vv[0];
    rel = p.rel_vv[0];
    return;
  }
  int d = dst < 0 ? dst + p.T : dst;
  d = d < 0 ? 0 : (d > p.T - 1 ? p.T - 1 : d);
  const long long e = (long long)p.vertex[h] * p.U + p.vtab[d];
  lat = p.lat_vv[e];
  rel = p.rel_vv[e];
}

struct Roll {
  bool deliver, drop;
  long long arrival, ctr;
};

// The roll of one lane that sends (`send`) at `now` over a path of
// `lat`, `rel`, with its key pair (k0, k1) and draw counter:
//   rolled   = send && lat != NEVER                   (reachable)
//   kept     = pass || uniform(fold_in(key, ctr)) < rel
//   deliver  = rolled && kept;  drop = rolled && !kept
//   arrival  = now + lat, wrapping as JAX's int64 add does
//   ctr'     = ctr + 1 (mod 2^32) where rolled
// `pass` (bootstrap, or a control packet) keeps the packet without a
// draw; the draw is made only where its value matters, and the counter
// advances on every rolled lane all the same.
__device__ __forceinline__ Roll roll(bool send, long long lat, float rel,
                                     long long now, bool pass, long long k0,
                                     long long k1, long long ctr) {
  const bool rolled = send && lat != kNever;
  bool kept = pass;
  if (rolled && !kept) {
    const float u =
        rng::uniform_at((uint32_t)k0, (uint32_t)k1, (uint32_t)ctr);
    kept = u < rel;
  }
  Roll r;
  r.deliver = rolled && kept;
  r.drop = rolled && !kept;
  r.arrival =
      (long long)((unsigned long long)now + (unsigned long long)lat);
  r.ctr = rolled ? (long long)(uint32_t)((uint32_t)ctr + 1u) : ctr;
  return r;
}

}  // namespace transit
