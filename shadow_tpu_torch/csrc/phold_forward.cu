// K1 phold_forward: PHOLD's forwarding over one window's dense events.
//
// Replaces shadow_tpu/net/apps.py:PholdApp.handle_msg_matrix with the
// threefry draws of shadow_tpu/core/rng.py:uniform_matrix, and the
// per-source seq numbering and row flattening of run_matrix
// (shadow_tpu/core/engine.py).
//
// Per host h, in column order k = 0..K-1 over the [H, K] window:
//   send  = real event (time != NEVER) and time < stop_sending
//   u1    = uniform(fold_in(key_h, c0 + 2 * sends_before_k))
//   dst   = floor(u1 * (H - 1)) in float32, clipped to [0, H - 2], +1 at or
//           above h's own id (skip self)
//   kept  = time < bootstrap_end, or u2 < reliability with u2 drawn at the
//           next counter
//   row   = (time + latency or NEVER, dst, gid, seq_next + kept_before_k,
//            kind, payload) for every cell, sent or not: the merge's stable
//            ties see every row, and unsent rows become free pool rows.
// The draws are JAX's threefry2x32 (partitionable form) and its float32
// uniform, bit for bit. Built with --fmad=false; the one float multiply
// is __fmul_rn as well.
//
// Bound: bytes. It reads 16 bytes a cell (time, payload) and writes 32
// (time, dst, src, seq, kind, payload); the ~4 threefry blocks a cell are
// ~400 integer operations, far under the card's integer rate at this
// byte count. Design: one thread per host, a sequential loop over k (the
// draw counters and seq numbers are exclusive counts along k). The stores
// are strided by K across a warp; coalescing them is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr long long kNever = 0x7FFFFFFFFFFFFFFFLL;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[i & 1][j]);
      x1 ^= x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
}

// uniform(fold_in(key, counter)) as jax.random computes it
__device__ __forceinline__ float uniform_at(uint32_t k0, uint32_t k1,
                                            uint32_t counter) {
  uint32_t a = 0u, b = counter;
  threefry2x32(k0, k1, a, b);
  uint32_t x0 = 0u, x1 = 0u;
  threefry2x32(a, b, x0, x1);
  uint32_t bits = x0 ^ x1;
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

__global__ void phold_forward_kernel(
    const long long* __restrict__ d_t, const long long* __restrict__ d_p,
    const long long* __restrict__ keys, const long long* __restrict__ ctr,
    const int* __restrict__ seq_next, const int* __restrict__ gid,
    const int* __restrict__ vertex, const int* __restrict__ vtab,
    const long long* __restrict__ lat_vv, const float* __restrict__ rel_vv,
    long long* __restrict__ o_time, int* __restrict__ o_dst,
    int* __restrict__ o_src, int* __restrict__ o_seq,
    int* __restrict__ o_kind, long long* __restrict__ o_payload,
    long long* __restrict__ o_ctr, int* __restrict__ o_seq_next,
    long long* __restrict__ o_stats, int H, int K, int PP, int U,
    int num_hosts, long long stop_sending, long long bootstrap_end,
    long long win_end, int kind) {
  int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= H) return;
  const uint32_t k0 = (uint32_t)keys[2 * h], k1 = (uint32_t)keys[2 * h + 1];
  const uint32_t c0 = (uint32_t)ctr[h];
  const int me = gid[h];
  const uint32_t base = (uint32_t)seq_next[h];
  const int vs = vertex[h];
  const float hm1 = (float)(num_hosts - 1);
  uint32_t n_send = 0u, n_emit = 0u;
  long long n_valid = 0, n_viol = 0;
  for (int k = 0; k < K; ++k) {
    const long long i = (long long)h * K + k;
    const long long t = d_t[i];
    const bool valid = t != kNever;
    const bool send = valid && t < stop_sending;
    const uint32_t off = c0 + 2u * n_send;
    int dst = me;
    if (num_hosts > 1) {
      float f = floorf(__fmul_rn(uniform_at(k0, k1, off), hm1));
      int d = (int)f;
      d = d < 0 ? 0 : (d > num_hosts - 2 ? num_hosts - 2 : d);
      dst = d + (d >= me ? 1 : 0);
    }
    bool emit = false;
    long long te = kNever;
    if (send) {
      long long lat;
      float rel;
      if (U == 1) {
        lat = lat_vv[0];
        rel = rel_vv[0];
      } else {
        long long e = (long long)vs * U + vtab[dst];
        lat = lat_vv[e];
        rel = rel_vv[e];
      }
      emit = t < bootstrap_end || uniform_at(k0, k1, off + 1u) < rel;
      if (emit) {
        te = (long long)((unsigned long long)t + (unsigned long long)lat);
        if (dst == me && te < win_end) ++n_viol;
      }
    }
    o_time[i] = te;
    o_dst[i] = dst;
    o_src[i] = me;
    o_seq[i] = (int)(base + n_emit);
    o_kind[i] = kind;
    for (int w = 0; w < PP; ++w) o_payload[i * PP + w] = d_p[i * PP + w];
    n_valid += valid;
    n_send += send;
    n_emit += emit;
  }
  o_ctr[h] = (long long)(uint32_t)(c0 + 2u * n_send);
  o_seq_next[h] = (int)(base + n_emit);
  o_stats[4 * h + 0] = n_valid;
  o_stats[4 * h + 1] = n_send;
  o_stats[4 * h + 2] = n_emit;
  o_stats[4 * h + 3] = n_viol;
}

}  // namespace

extern "C" int phold_forward(
    const void* d_t, const void* d_p, const void* keys, const void* ctr,
    const void* seq_next, const void* gid, const void* vertex,
    const void* vtab, const void* lat_vv, const void* rel_vv, void* o_time,
    void* o_dst, void* o_src, void* o_seq, void* o_kind, void* o_payload,
    void* o_ctr, void* o_seq_next, void* o_stats, int H, int K, int PP,
    int U, int num_hosts, long long stop_sending, long long bootstrap_end,
    long long win_end, int kind, void* stream) {
  if (H > 0) {
    const int threads = 128;
    phold_forward_kernel<<<(H + threads - 1) / threads, threads, 0,
                           (cudaStream_t)stream>>>(
        (const long long*)d_t, (const long long*)d_p, (const long long*)keys,
        (const long long*)ctr, (const int*)seq_next, (const int*)gid,
        (const int*)vertex, (const int*)vtab, (const long long*)lat_vv,
        (const float*)rel_vv, (long long*)o_time, (int*)o_dst, (int*)o_src,
        (int*)o_seq, (int*)o_kind, (long long*)o_payload, (long long*)o_ctr,
        (int*)o_seq_next, (long long*)o_stats, H, K, PP, U, num_hosts,
        stop_sending, bootstrap_end, win_end, kind);
  }
  return (int)cudaGetLastError();
}
