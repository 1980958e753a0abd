// K5 loop_route: route one micro-step's emissions into the inbox and
// outbox of the loop path.
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
// placed record. Design: one thread per host, which copies its box rows
// and applies its records in order; hosts are independent. The copy
// keeps the kernel out of place, as the engine's state is, and is not
// part of the bound; the rows are short (B, O <= 64 slots), so a
// thread's reads stay within a few cache lines.

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
  const long long *i_t;
  const int *i_s, *i_q, *i_k;
  const long long* i_p;
  const long long* o_t;
  const int *o_d, *o_s, *o_q, *o_k;
  const long long* o_p;
  const int* o_count;
  long long* n_i_t;
  int *n_i_s, *n_i_q, *n_i_k;
  long long* n_i_p;
  long long* n_o_t;
  int *n_o_d, *n_o_s, *n_o_q, *n_o_k;
  long long* n_o_p;
  int* n_o_count;
  int* n_seq_next;
  long long* stats;
  int E, H, B, O, PP;
  long long win_end;
};

__global__ void loop_route_kernel(Args a) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= a.H) return;
  const long long ib = (long long)h * a.B, ob = (long long)h * a.O;
  for (int b = 0; b < a.B; ++b) {
    a.n_i_t[ib + b] = a.i_t[ib + b];
    a.n_i_s[ib + b] = a.i_s[ib + b];
    a.n_i_q[ib + b] = a.i_q[ib + b];
    a.n_i_k[ib + b] = a.i_k[ib + b];
  }
  for (long long w = 0; w < (long long)a.B * a.PP; ++w)
    a.n_i_p[ib * a.PP + w] = a.i_p[ib * a.PP + w];
  for (int o = 0; o < a.O; ++o) {
    a.n_o_t[ob + o] = a.o_t[ob + o];
    a.n_o_d[ob + o] = a.o_d[ob + o];
    a.n_o_s[ob + o] = a.o_s[ob + o];
    a.n_o_q[ob + o] = a.o_q[ob + o];
    a.n_o_k[ob + o] = a.o_k[ob + o];
  }
  for (long long w = 0; w < (long long)a.O * a.PP; ++w)
    a.n_o_p[ob * a.PP + w] = a.o_p[ob * a.PP + w];

  const int me = a.gid[h];
  const long long dt = a.defer_t[h];
  const int ds = a.defer_s[h], dq = a.defer_q[h];
  int seq_next = a.seq_next[h], count = a.o_count[h];
  long long emitted = 0, deferred = 0, dropped = 0;
  for (int e = 0; e < a.E; ++e) {
    const long long r = (long long)e * a.H + h;
    if (!a.m[r]) continue;
    const int seq = seq_next++;
    const long long t = a.t[r];
    const int d = a.d[r], k = a.k[r];
    ++emitted;
    const bool is_self =
        d == me && t < a.win_end && key_lt(t, me, seq, dt, ds, dq);
    int free_slot = -1;
    for (int b = 0; b < a.B && free_slot < 0; ++b)
      if (a.n_i_t[ib + b] == kNever) free_slot = b;
    if (is_self && free_slot >= 0) {
      const long long i = ib + free_slot;
      a.n_i_t[i] = t;
      a.n_i_s[i] = me;
      a.n_i_q[i] = seq;
      a.n_i_k[i] = k;
      for (int w = 0; w < a.PP; ++w) a.n_i_p[i * a.PP + w] = a.p[r * a.PP + w];
      continue;
    }
    if (is_self) ++deferred;
    if (count < a.O) {
      const long long i = ob + count;
      a.n_o_t[i] = t;
      a.n_o_d[i] = d;
      a.n_o_s[i] = me;
      a.n_o_q[i] = seq;
      a.n_o_k[i] = k;
      for (int w = 0; w < a.PP; ++w) a.n_o_p[i * a.PP + w] = a.p[r * a.PP + w];
      ++count;
    } else {
      ++dropped;
    }
  }
  a.n_o_count[h] = count;
  a.n_seq_next[h] = seq_next;
  a.stats[3LL * h] = emitted;
  a.stats[3LL * h + 1] = deferred;
  a.stats[3LL * h + 2] = dropped;
}

}  // namespace

extern "C" int loop_route(
    const void* m, const void* t, const void* d, const void* k, const void* p,
    const void* seq_next, const void* gid, const void* defer_t,
    const void* defer_s, const void* defer_q, const void* i_t,
    const void* i_s, const void* i_q, const void* i_k, const void* i_p,
    const void* o_t, const void* o_d, const void* o_s, const void* o_q,
    const void* o_k, const void* o_p, const void* o_count, void* n_i_t,
    void* n_i_s, void* n_i_q, void* n_i_k, void* n_i_p, void* n_o_t,
    void* n_o_d, void* n_o_s, void* n_o_q, void* n_o_k, void* n_o_p,
    void* n_o_count, void* n_seq_next, void* stats, int E, int H, int B,
    int O, int PP, long long win_end, void* stream) {
  Args a{(const bool*)m, (const long long*)t, (const int*)d, (const int*)k,
         (const long long*)p, (const int*)seq_next, (const int*)gid,
         (const long long*)defer_t, (const int*)defer_s,
         (const int*)defer_q, (const long long*)i_t, (const int*)i_s,
         (const int*)i_q, (const int*)i_k, (const long long*)i_p,
         (const long long*)o_t, (const int*)o_d, (const int*)o_s,
         (const int*)o_q, (const int*)o_k, (const long long*)o_p,
         (const int*)o_count, (long long*)n_i_t, (int*)n_i_s, (int*)n_i_q,
         (int*)n_i_k, (long long*)n_i_p, (long long*)n_o_t, (int*)n_o_d,
         (int*)n_o_s, (int*)n_o_q, (int*)n_o_k, (long long*)n_o_p,
         (int*)n_o_count, (int*)n_seq_next, (long long*)stats, E, H, B, O,
         PP, win_end};
  if (H > 0) {
    const int threads = 128;
    loop_route_kernel<<<(H + threads - 1) / threads, threads, 0,
                        (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}
