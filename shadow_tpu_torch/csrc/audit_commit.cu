// K2 audit_commit: commit one window's dense events per host.
//
// Replaces shadow_tpu/obs/audit.py:fold as run_matrix applies it, column
// by column over the [H, K] window (shadow_tpu/core/engine.py, run_matrix:
// the audit loop and the host_events / host_last_t / done_t updates).
//
// Per host h, in column order k = 0..K-1, for every real event
// (time != NEVER): digest = digest * MULT + event_key(time, src, h's gid,
// kind) in wrapping 64-bit arithmetic; count it; track the max of its
// exec time e_t (the CPU model's shifted time; the same tensor as d_t
// where the model is off). Then host_events += count, and host_last_t and
// done_t take that max where the host committed anything. The fold keys on
// the event's own time, so a chain does not depend on the model
// (engine.py:1011-1012, 1264-1268 and 1331-1340).
//
// Bound: bytes. It reads every cell's time, the exec time, src and kind of
// each committed cell (the exec time is the time itself, read once, where
// the model is off) and 36 bytes a host, and writes 40 bytes a host. Design: one thread per host running
// the chain sequentially, as the fold is order-dependent along k; hosts
// are independent. Unsigned 64-bit arithmetic gives the two's-complement
// wrap of the JAX package's int64 multiplies and its logical shift.

#include <cuda_runtime.h>

namespace {

constexpr long long kNever = 0x7FFFFFFFFFFFFFFFLL;
constexpr unsigned long long kTime = 0xBF58476D1CE4E5B9ULL;
constexpr unsigned long long kSrc = 0x94D049BB133111EBULL;
constexpr unsigned long long kDst = 0x2545F4914F6CDD1DULL;
constexpr unsigned long long kKind = 0xFF51AFD7ED558CCDULL;
constexpr unsigned long long kChainMult = 0x5851F42D4C957F2DULL;

__device__ __forceinline__ unsigned long long event_key(long long t,
                                                        long long src,
                                                        long long dst,
                                                        long long kind) {
  unsigned long long k = (unsigned long long)t * kTime;
  k ^= (unsigned long long)(src + 1) * kSrc;
  k ^= (unsigned long long)(dst + 1) * kDst;
  k ^= (unsigned long long)(kind + 1) * kKind;
  return k ^ (k >> 31);
}

__global__ void audit_commit_kernel(
    const long long* __restrict__ d_t, const long long* __restrict__ e_t,
    const int* __restrict__ d_s,
    const int* __restrict__ d_k, const int* __restrict__ gid,
    const long long* __restrict__ digest, const long long* __restrict__ events,
    const long long* __restrict__ last_t, const long long* __restrict__ done_t,
    long long* __restrict__ o_digest, long long* __restrict__ o_events,
    long long* __restrict__ o_last_t, long long* __restrict__ o_done_t,
    long long* __restrict__ o_n, int H, int K) {
  int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= H) return;
  unsigned long long dg = (unsigned long long)digest[h];
  long long me = gid[h];
  long long n = 0, last = -1;
  for (int k = 0; k < K; ++k) {
    long long i = (long long)h * K + k;
    long long t = d_t[i];
    if (t == kNever) continue;
    dg = dg * kChainMult + event_key(t, d_s[i], me, d_k[i]);
    ++n;
    const long long e = e_t == d_t ? t : e_t[i];
    last = e > last ? e : last;
  }
  o_digest[h] = (long long)dg;
  o_events[h] = events[h] + n;
  o_last_t[h] = n > 0 ? last : last_t[h];
  o_done_t[h] = n > 0 ? last : done_t[h];
  o_n[h] = n;
}

}  // namespace

extern "C" int audit_commit(const void* d_t, const void* e_t,
                            const void* d_s, const void* d_k,
                            const void* gid, const void* digest,
                            const void* events, const void* last_t,
                            const void* done_t, void* o_digest,
                            void* o_events, void* o_last_t, void* o_done_t,
                            void* o_n, int H, int K, void* stream) {
  if (H > 0) {
    const int threads = 128;
    audit_commit_kernel<<<(H + threads - 1) / threads, threads, 0,
                          (cudaStream_t)stream>>>(
        (const long long*)d_t, (const long long*)e_t, (const int*)d_s,
        (const int*)d_k,
        (const int*)gid, (const long long*)digest, (const long long*)events,
        (const long long*)last_t, (const long long*)done_t,
        (long long*)o_digest, (long long*)o_events, (long long*)o_last_t,
        (long long*)o_done_t, (long long*)o_n, H, K);
  }
  return (int)cudaGetLastError();
}
