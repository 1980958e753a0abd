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
//   dst   = pick_dst(u1) (shadow_tpu/net/apps.py:_pick_dst), in float32:
//           uniform: floor(u1 * (H - 1)), clipped to [0, H - 2], +1 at or
//             above h's own id (skip self);
//           local_span s: off = floor(u1 * 2s) clipped to [0, 2s - 1],
//             minus s, plus 1 where >= 0; (id + off) floor-mod H
//             (ring_offset_dst);
//           hot (hot_n > 0): u1 < hs ? floor(u1 * c_hot)
//             : hot_n + floor((u1 - hs) * c_cold), clipped to [0, H - 1]
//             (self-sends allowed). JAX writes u / hs * nh and
//             (u - hs) / (1 - hs) * (H - nh); XLA folds each division by a
//             constant into a multiply by its float32 reciprocal and the
//             two factors into one: c_hot and c_cold are those products,
//             computed on the host (kernels.hot_split)
//   kept  = time < bootstrap_end, or u2 < reliability with u2 drawn at the
//           next counter
//   row   = (time + latency or NEVER, dst, gid, seq_next + kept_before_k,
//            kind, payload) for every cell, sent or not: the merge's stable
//            ties see every row, and unsent rows become free pool rows.
// The draws are JAX's threefry2x32 (partitionable form) and its float32
// uniform, bit for bit (threefry.cuh). Built with --fmad=false; the float
// multiplies and the subtraction are __fmul_rn and __fsub_rn as well.
//
// Bound: bytes. It reads 16 bytes a cell (time, payload) and writes 32
// (time, dst, src, seq, kind, payload); the ~4 threefry blocks a cell are
// ~400 integer operations, under the card's integer rate at this byte
// count. Design: one warp per host, a lane per cell over chunks of 32
// columns (a host with K > 32 loops, carrying its counts in registers).
// The draw counter c0 + 2 * sends_before_k and the seq number are
// exclusive counts along k: each is the chunk's carried count plus the
// popcount of the lanes below in a __ballot_sync of the send (or emit)
// flags. A warp's loads and stores of a chunk's cells are contiguous, and
// the payload words are copied by the lanes across the host's K * PP
// contiguous words. 8 hosts a block (2 and 4 were no faster); lane 0
// writes the per-host results.

#include <cuda_runtime.h>
#include <stdint.h>

#include "threefry.cuh"

namespace {

constexpr long long kNever = 0x7FFFFFFFFFFFFFFFLL;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kHostsPerBlock = 8;  // one warp each

// the destination modes' parameters (kernels.pick_dst)
struct Pick {
  int hot_n;  // > 0: the hot split
  float hs, c_hot, c_cold;
  int span;  // > 0: the ring offset
};

__device__ __forceinline__ int clip(int d, int lo, int hi) {
  return d < lo ? lo : (d > hi ? hi : d);
}

// PHOLD's destination for one float32 draw (kernels.pick_dst)
__device__ __forceinline__ int pick_dst(float u, int me, int num_hosts,
                                        const Pick& p) {
  if (p.span > 0) {
    int off = (int)floorf(__fmul_rn(u, (float)(2 * p.span)));
    off = clip(off, 0, 2 * p.span - 1) - p.span;
    off += off >= 0 ? 1 : 0;
    const int r = (me + off) % num_hosts;  // truncated; made a floor mod
    return r < 0 ? r + num_hosts : r;
  }
  if (p.hot_n > 0) {
    const int d = u < p.hs
        ? (int)floorf(__fmul_rn(u, p.c_hot))
        : p.hot_n + (int)floorf(__fmul_rn(__fsub_rn(u, p.hs), p.c_cold));
    return clip(d, 0, num_hosts - 1);
  }
  if (num_hosts <= 1) return me;
  const float f = floorf(__fmul_rn(u, (float)(num_hosts - 1)));
  const int d = clip((int)f, 0, num_hosts - 2);
  return d + (d >= me ? 1 : 0);
}

__global__ void __launch_bounds__(32 * kHostsPerBlock) phold_forward_kernel(
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
    long long win_end, int kind, Pick pick) {
  const int lane = threadIdx.x & 31;
  const int h = blockIdx.x * kHostsPerBlock + (threadIdx.x >> 5);
  if (h >= H) return;  // the whole warp
  const unsigned below = (1u << lane) - 1u;
  const uint32_t k0 = (uint32_t)keys[2 * h], k1 = (uint32_t)keys[2 * h + 1];
  const uint32_t c0 = (uint32_t)ctr[h];
  const int me = gid[h];
  const uint32_t base = (uint32_t)seq_next[h];
  const int vs = vertex[h];
  const long long row = (long long)h * K;
  uint32_t n_send = 0u, n_emit = 0u, n_valid = 0u, n_viol = 0u;
  for (int kb = 0; kb < K; kb += 32) {
    const bool in = kb + lane < K;
    const long long i = row + kb + lane;
    const long long t = in ? d_t[i] : kNever;
    const bool valid = t != kNever;
    const bool send = valid && t < stop_sending;
    const unsigned sends = __ballot_sync(kFull, send);
    const uint32_t off = c0 + 2u * (n_send + __popc(sends & below));
    int dst = me;
    if (in)
      dst = pick_dst(rng::uniform_at(k0, k1, off), me, num_hosts, pick);
    bool emit = false;
    long long te = kNever;
    if (send) {
      long long lat;
      float rel;
      if (U == 1) {
        lat = lat_vv[0];
        rel = rel_vv[0];
      } else {
        const long long e = (long long)vs * U + vtab[dst];
        lat = lat_vv[e];
        rel = rel_vv[e];
      }
      emit = t < bootstrap_end || rng::uniform_at(k0, k1, off + 1u) < rel;
      if (emit)
        te = (long long)((unsigned long long)t + (unsigned long long)lat);
    }
    const unsigned emits = __ballot_sync(kFull, emit);
    const bool viol = emit && dst == me && te < win_end;
    if (in) {
      o_time[i] = te;
      o_dst[i] = dst;
      o_src[i] = me;
      o_seq[i] = (int)(base + n_emit + __popc(emits & below));
      o_kind[i] = kind;
    }
    n_valid += __popc(__ballot_sync(kFull, valid));
    n_send += __popc(sends);
    n_emit += __popc(emits);
    n_viol += __popc(__ballot_sync(kFull, viol));
  }
  const long long w0 = row * PP;
  for (int w = lane; w < K * PP; w += 32) o_payload[w0 + w] = d_p[w0 + w];
  if (lane == 0) {
    o_ctr[h] = (long long)(uint32_t)(c0 + 2u * n_send);
    o_seq_next[h] = (int)(base + n_emit);
    o_stats[4 * h + 0] = n_valid;
    o_stats[4 * h + 1] = n_send;
    o_stats[4 * h + 2] = n_emit;
    o_stats[4 * h + 3] = n_viol;
  }
}

// pick_dst alone, on given draws: the check entry that sweeps the float32
// draws around each split of the destination modes (kernels.phold_pick)
__global__ void phold_pick_kernel(const float* __restrict__ u,
                                  const int* __restrict__ me,
                                  int* __restrict__ out, long long n,
                                  int num_hosts, Pick pick) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = pick_dst(u[i], me[i], num_hosts, pick);
}

}  // namespace

extern "C" int phold_forward(
    const void* d_t, const void* d_p, const void* keys, const void* ctr,
    const void* seq_next, const void* gid, const void* vertex,
    const void* vtab, const void* lat_vv, const void* rel_vv, void* o_time,
    void* o_dst, void* o_src, void* o_seq, void* o_kind, void* o_payload,
    void* o_ctr, void* o_seq_next, void* o_stats, int H, int K, int PP,
    int U, int num_hosts, long long stop_sending, long long bootstrap_end,
    long long win_end, int kind, int hot_n, float hs, float c_hot,
    float c_cold, int span, void* stream) {
  if (H > 0) {
    phold_forward_kernel<<<(H + kHostsPerBlock - 1) / kHostsPerBlock,
                           32 * kHostsPerBlock, 0, (cudaStream_t)stream>>>(
        (const long long*)d_t, (const long long*)d_p, (const long long*)keys,
        (const long long*)ctr, (const int*)seq_next, (const int*)gid,
        (const int*)vertex, (const int*)vtab, (const long long*)lat_vv,
        (const float*)rel_vv, (long long*)o_time, (int*)o_dst, (int*)o_src,
        (int*)o_seq, (int*)o_kind, (long long*)o_payload, (long long*)o_ctr,
        (int*)o_seq_next, (long long*)o_stats, H, K, PP, U, num_hosts,
        stop_sending, bootstrap_end, win_end, kind,
        Pick{hot_n, hs, c_hot, c_cold, span});
  }
  return (int)cudaGetLastError();
}

extern "C" int phold_pick(const void* u, const void* me, void* out,
                          long long n, int num_hosts, int hot_n, float hs,
                          float c_hot, float c_cold, int span,
                          void* stream) {
  if (n > 0) {
    const int threads = 256;
    phold_pick_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                        (cudaStream_t)stream>>>(
        (const float*)u, (const int*)me, (int*)out, n, num_hosts,
        Pick{hot_n, hs, c_hot, c_cold, span});
  }
  return (int)cudaGetLastError();
}
