// K5 loop_route: route one micro-step's emissions into the inbox and
// outbox of the loop path, in place.
//
// Replaces the routing loop of shadow_tpu/core/engine.py's micro-step
// (make_loop_fns.body, "route emissions"): the records are routed in the
// order the handlers emitted them, which fixes the per-source seq numbers.
//
// Per host h and record e = 0..E-1 where the record's mask is set:
//   * seq = seq_next[h]++;
//   * a self emission (dst == gid) inside the window whose key
//     (time, gid, seq) precedes the host's deferred key (dense column K)
//     goes to the first free inbox slot; with none free it is deferred
//     through the outbox and counted;
//   * every other record goes to the outbox at count (count += 1), or is
//     dropped and counted where the outbox is full.
// stats[h] = (records emitted, self emissions deferred for a full inbox,
// outbox drops).
//
// Bound: bytes. The function reads the records, each active host's inbox
// times, outbox count and deferred key, and writes one box cell per
// placed record. Design: one thread per host applies its records in
// emit order, straight into the boxes it is given; hosts are
// independent, and the record reads are coalesced (r = e * H + h). The
// boxes are the micro-step loop's own (Simulation.step_loop makes them
// fresh each window and replaces them with the result of each call; no
// snapshot or rollback sees them), so nothing needs the rows as they
// were, and the kernel writes no copy of them: a host touches only the
// cells its records fill. Inserts only fill inbox slots, so the first
// free slot moves forward only, and each inbox time is read at most once.
// The record inputs are read-only for the call (__ldg), and each thread
// reads the masks of 32 records together before it walks the set ones,
// so their loads overlap instead of waiting one on another.

#include <cuda_runtime.h>

namespace {

constexpr long long kNever = 0x7FFFFFFFFFFFFFFFLL;

__device__ __forceinline__ bool key_lt(long long t1, int s1, int q1,
                                       long long t2, int s2, int q2) {
  return t1 < t2 || (t1 == t2 && (s1 < s2 || (s1 == s2 && q1 < q2)));
}

struct Args {
  const bool* m;
  const long long* t;
  const int* d;
  const int* k;
  const long long* p;
  const int* seq_next;
  const int* gid;
  const long long* defer_t;
  const int* defer_s;
  const int* defer_q;
  long long* i_t;  // the boxes, updated in place
  int *i_s, *i_q, *i_k;
  long long* i_p;
  long long* o_t;
  int *o_d, *o_s, *o_q, *o_k;
  long long* o_p;
  int* o_count;
  int* n_seq_next;
  long long* stats;
  int E, H, B, O, PP;
  long long win_end;
};

__global__ void loop_route_kernel(Args a) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= a.H) return;
  const long long ib = (long long)h * a.B, ob = (long long)h * a.O;
  const int me = __ldg(&a.gid[h]);
  int seq_next = __ldg(&a.seq_next[h]);
  int count = -1;  // the outbox count, read at the first outbox record
  int free_slot = -1;  // the first free inbox slot, found at the first self
  long long dt = 0;
  int ds = 0, dq = 0;
  long long emitted = 0, deferred = 0, dropped = 0;
  const unsigned char* m = (const unsigned char*)a.m;
  // the masks of 32 records at a time, read together, then the set ones
  // in emit order
  for (int e0 = 0; e0 < a.E; e0 += 32) {
    const int n = min(32, a.E - e0);
    unsigned bits = 0;
#pragma unroll 8
    for (int j = 0; j < n; ++j)
      bits |= (unsigned)(__ldg(&m[(long long)(e0 + j) * a.H + h]) != 0) << j;
    for (; bits; bits &= bits - 1) {
      const long long r = (long long)(e0 + __ffs(bits) - 1) * a.H + h;
      const int seq = seq_next++;
      const long long t = __ldg(&a.t[r]);
      const int d = __ldg(&a.d[r]), k = __ldg(&a.k[r]);
      ++emitted;
      bool is_self = d == me && t < a.win_end;
      if (is_self) {
        if (free_slot < 0) {
          dt = __ldg(&a.defer_t[h]);
          ds = __ldg(&a.defer_s[h]);
          dq = __ldg(&a.defer_q[h]);
          free_slot = 0;
          while (free_slot < a.B && a.i_t[ib + free_slot] != kNever)
            ++free_slot;
        }
        is_self = key_lt(t, me, seq, dt, ds, dq);
      }
      if (is_self && free_slot < a.B) {
        const long long i = ib + free_slot;
        a.i_t[i] = t;
        a.i_s[i] = me;
        a.i_q[i] = seq;
        a.i_k[i] = k;
        for (int w = 0; w < a.PP; ++w)
          a.i_p[i * a.PP + w] = __ldg(&a.p[r * a.PP + w]);
        ++free_slot;
        while (free_slot < a.B && a.i_t[ib + free_slot] != kNever)
          ++free_slot;
        continue;
      }
      if (is_self) ++deferred;
      if (count < 0) count = a.o_count[h];
      if (count < a.O) {
        const long long i = ob + count;
        a.o_t[i] = t;
        a.o_d[i] = d;
        a.o_s[i] = me;
        a.o_q[i] = seq;
        a.o_k[i] = k;
        for (int w = 0; w < a.PP; ++w)
          a.o_p[i * a.PP + w] = __ldg(&a.p[r * a.PP + w]);
        ++count;
      } else {
        ++dropped;
      }
    }
  }
  if (count >= 0) a.o_count[h] = count;
  a.n_seq_next[h] = seq_next;
  a.stats[3LL * h] = emitted;
  a.stats[3LL * h + 1] = deferred;
  a.stats[3LL * h + 2] = dropped;
}

}  // namespace

extern "C" int loop_route(
    const void* m, const void* t, const void* d, const void* k, const void* p,
    const void* seq_next, const void* gid, const void* defer_t,
    const void* defer_s, const void* defer_q, void* i_t, void* i_s,
    void* i_q, void* i_k, void* i_p, void* o_t, void* o_d, void* o_s,
    void* o_q, void* o_k, void* o_p, void* o_count, void* n_seq_next,
    void* stats, int E, int H, int B, int O, int PP, long long win_end,
    void* stream) {
  Args a{(const bool*)m, (const long long*)t, (const int*)d, (const int*)k,
         (const long long*)p, (const int*)seq_next, (const int*)gid,
         (const long long*)defer_t, (const int*)defer_s,
         (const int*)defer_q, (long long*)i_t, (int*)i_s, (int*)i_q,
         (int*)i_k, (long long*)i_p, (long long*)o_t, (int*)o_d,
         (int*)o_s, (int*)o_q, (int*)o_k, (long long*)o_p, (int*)o_count,
         (int*)n_seq_next, (long long*)stats, E, H, B, O, PP, win_end};
  if (H > 0) {
    const int threads = 128;
    loop_route_kernel<<<(H + threads - 1) / threads, threads, 0,
                        (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}
