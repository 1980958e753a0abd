// K4 loop_select: each host's event(s) for one micro-step of the loop path.
//
// Replaces the selection half of shadow_tpu/core/engine.py's micro-step,
// make_loop_fns.body (the candidate read, _inbox_min, the bulk batch plan,
// the outbox-room and pool-headroom gates, the cursor advance and the
// inbox slot clear).
//
// Per host h:
//   * the dense head at ptr[h] (time NEVER past column K or past the
//     host's events) against the inbox minimum by (time, src, seq), found
//     by the JAX package's tournament: on ties the first half wins, and an
//     odd round pads its second half with (NEVER, 0, 0, slot 0);
//   * the bulk batch: up to G - 1 further dense columns, each of the bulk
//     kind, inside the window, before the inbox head in key order, within
//     the host's gate and (with self_excluded) from another host; a column
//     joins only if every column before it did;
//   * need = need_by_kind[kind] * (1 + batch); room = count + need <= O;
//   * the pool-headroom gate: box_used + (exclusive prefix of need over
//     the hot hosts before h, in host order) + need <= pool_budget, where
//     box_used counts the rows both boxes hold, over all hosts.
// Outputs the taken events [H, G] (head in column 0, time NEVER and zeros
// where not taken), valid, stalled, the new cursor, and the inbox times
// with the taken slot cleared.
//
// Bound: bytes. It reads one or G dense cells a host plus the inbox and
// writes the taken cells. The prefix over hosts is the one step that is
// not per host. Design: a single block of 1024 threads over all H hosts,
// each thread a contiguous run of hosts. Pass 1 plans every host and sums
// its run's need and box rows; a block-wide scan in shared memory gives
// each run its exclusive prefix and the box total; pass 2 plans each host
// again (it is cheap) and writes its outputs. One block leaves the other
// SMs idle; the function is microseconds at the config-2 shape, and a
// multi-block scan is later work.

#include <cuda_runtime.h>

namespace {

constexpr long long kNever = 0x7FFFFFFFFFFFFFFFLL;
constexpr int kMaxB = 32;
constexpr int kThreads = 1024;

__device__ __forceinline__ bool key_lt(long long t1, int s1, int q1,
                                       long long t2, int s2, int q2) {
  return t1 < t2 || (t1 == t2 && (s1 < s2 || (s1 == s2 && q1 < q2)));
}

struct Args {
  const long long* d_t;
  const int* d_s;
  const int* d_q;
  const int* d_k;
  const long long* d_p;
  const int* ptr;
  const long long* i_t;
  const int* i_s;
  const int* i_q;
  const int* i_k;
  const long long* i_p;
  const int* o_count;
  const int* gate;  // null: no per-host batch limit
  const int* gid;
  const int* need_by_kind;
  long long* take_t;
  int* take_s;
  int* take_q;
  int* take_k;
  long long* take_p;
  bool* valid;
  bool* stalled;
  int* ptr_out;
  long long* inbox_t;
  int H, Kc, B, PP, NK, K, G;
  long long win_end, pool_budget;
  int O, bulk_kind, self_excluded;
};

struct Plan {
  bool use_inbox, hot, room;
  int slot, n_bulk, need;
  long long t;
  int s, q, k;
};

__device__ Plan plan_host(const Args& a, int h) {
  Plan p;
  const int pt = a.ptr[h];
  const long long cell = (long long)h * a.Kc + pt;
  const long long m_raw = a.d_t[cell];
  const long long m_t = (pt < a.K && m_raw != kNever) ? m_raw : kNever;
  const int m_s = a.d_s[cell], m_q = a.d_q[cell], m_k = a.d_k[cell];

  long long tt[kMaxB];
  int ss[kMaxB], qq[kMaxB], ii[kMaxB];
  const long long ib = (long long)h * a.B;
  for (int b = 0; b < a.B; ++b) {
    tt[b] = a.i_t[ib + b];
    ss[b] = a.i_s[ib + b];
    qq[b] = a.i_q[ib + b];
    ii[b] = b;
  }
  for (int n = a.B; n > 1;) {
    const int half = (n + 1) / 2;
    for (int j = 0; j < half; ++j) {
      long long t2 = kNever;
      int s2 = 0, q2 = 0, i2 = 0;
      if (j + half < n) {
        t2 = tt[j + half];
        s2 = ss[j + half];
        q2 = qq[j + half];
        i2 = ii[j + half];
      }
      if (key_lt(t2, s2, q2, tt[j], ss[j], qq[j])) {
        tt[j] = t2;
        ss[j] = s2;
        qq[j] = q2;
        ii[j] = i2;
      }
    }
    n = half;
  }
  const long long i_time = tt[0];
  const int i_src = ss[0], i_seq = qq[0];
  p.slot = ii[0];
  p.use_inbox = key_lt(i_time, i_src, i_seq, m_t, m_s, m_q);
  p.t = p.use_inbox ? i_time : m_t;
  p.s = p.use_inbox ? i_src : m_s;
  p.q = p.use_inbox ? i_seq : m_q;
  p.k = p.use_inbox ? a.i_k[ib + p.slot] : m_k;

  p.n_bulk = 0;
  if (a.bulk_kind >= 0 && a.G > 1) {
    const int me = a.gid[h];
    const int gate = a.gate ? a.gate[h] : 0x7FFFFFFF;
    bool prev = p.t < a.win_end && !p.use_inbox && p.k == a.bulk_kind &&
                (!a.self_excluded || m_s != me) && gate > 0;
    for (int g = 1; g < a.G && prev; ++g) {
      const int c = pt + g;
      if (c >= a.K) break;
      const long long i = (long long)h * a.Kc + c;
      const long long tg = a.d_t[i];
      const int sg = a.d_s[i], qg = a.d_q[i];
      prev = tg != kNever && a.d_k[i] == a.bulk_kind && tg < a.win_end &&
             key_lt(tg, sg, qg, i_time, i_src, i_seq) &&
             (!a.self_excluded || sg != me) && gate >= g;
      p.n_bulk += prev;
    }
  }
  const int base = (p.k >= 0 && p.k < a.NK) ? a.need_by_kind[p.k] : 0;
  p.need = base * (1 + p.n_bulk);
  p.room = a.o_count[h] + p.need <= a.O;
  p.hot = p.t < a.win_end;
  return p;
}

__global__ void __launch_bounds__(kThreads)
    loop_select_kernel(Args a) {
  __shared__ long long warp_need[kThreads / 32];
  __shared__ long long warp_box[kThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (a.H + kThreads - 1) / kThreads;
  const int h0 = min(a.H, tid * per), h1 = min(a.H, h0 + per);

  // pass 1: this run's need (hot hosts) and box rows
  long long need = 0, box = 0;
  for (int h = h0; h < h1; ++h) {
    const Plan p = plan_host(a, h);
    if (p.hot) need += p.need;
    box += a.o_count[h];
    for (int b = 0; b < a.B; ++b)
      box += a.i_t[(long long)h * a.B + b] != kNever;
  }
  // block-wide inclusive scan of need and sum of box rows
  long long inc = need, tot_box = box;
  for (int o = 1; o < 32; o <<= 1) {
    const long long v = __shfl_up_sync(0xFFFFFFFFu, inc, o);
    if (lane >= o) inc += v;
    tot_box += __shfl_xor_sync(0xFFFFFFFFu, tot_box, o);
  }
  if (lane == 31) warp_need[warp] = inc;
  if (lane == 0) warp_box[warp] = tot_box;
  __syncthreads();
  if (warp == 0) {
    long long w = warp_need[lane], wb = warp_box[lane];
    for (int o = 1; o < 32; o <<= 1) {
      const long long v = __shfl_up_sync(0xFFFFFFFFu, w, o);
      if (lane >= o) w += v;
      wb += __shfl_xor_sync(0xFFFFFFFFu, wb, o);
    }
    warp_need[lane] = w;  // inclusive over warps
    warp_box[lane] = wb;  // every lane holds the total
  }
  __syncthreads();
  long long cum = inc - need + (warp > 0 ? warp_need[warp - 1] : 0);
  const long long box_used = warp_box[0];

  // pass 2: the gates and the outputs
  for (int h = h0; h < h1; ++h) {
    const Plan p = plan_host(a, h);
    const long long need_hot = p.hot ? p.need : 0;
    const bool fits = box_used + cum + need_hot <= a.pool_budget;
    cum += need_hot;
    const bool v = p.hot && p.room && fits;
    a.valid[h] = v;
    a.stalled[h] = p.hot && !(p.room && fits);
    const int pt = a.ptr[h];
    const long long o0 = (long long)h * a.G;
    const long long src_cell = (long long)h * a.Kc + pt;
    const long long src_box = (long long)h * a.B + p.slot;
    a.take_t[o0] = v ? p.t : kNever;
    a.take_s[o0] = v ? p.s : 0;
    a.take_q[o0] = v ? p.q : 0;
    a.take_k[o0] = v ? p.k : 0;
    for (int w = 0; w < a.PP; ++w) {
      const long long x = p.use_inbox ? a.i_p[src_box * a.PP + w]
                                      : a.d_p[src_cell * a.PP + w];
      a.take_p[o0 * a.PP + w] = v ? x : 0;
    }
    const int n = v ? p.n_bulk : 0;
    for (int g = 1; g < a.G; ++g) {
      const bool tk = g <= n;
      const long long i = src_cell + g;  // in range where taken
      a.take_t[o0 + g] = tk ? a.d_t[i] : kNever;
      a.take_s[o0 + g] = tk ? a.d_s[i] : 0;
      a.take_q[o0 + g] = tk ? a.d_q[i] : 0;
      a.take_k[o0 + g] = tk ? a.d_k[i] : 0;
      for (int w = 0; w < a.PP; ++w)
        a.take_p[(o0 + g) * a.PP + w] = tk ? a.d_p[i * a.PP + w] : 0;
    }
    a.ptr_out[h] = (v && !p.use_inbox) ? pt + 1 + n : pt;
    for (int b = 0; b < a.B; ++b) {
      const long long i = (long long)h * a.B + b;
      a.inbox_t[i] = (v && p.use_inbox && b == p.slot) ? kNever : a.i_t[i];
    }
  }
}

}  // namespace

extern "C" int loop_select(
    const void* d_t, const void* d_s, const void* d_q, const void* d_k,
    const void* d_p, const void* ptr, const void* i_t, const void* i_s,
    const void* i_q, const void* i_k, const void* i_p, const void* o_count,
    const void* gate, const void* gid, const void* need_by_kind,
    void* take_t, void* take_s, void* take_q, void* take_k, void* take_p,
    void* valid, void* stalled, void* ptr_out, void* inbox_t, int H, int Kc,
    int B, int PP, int NK, int K, int G, long long win_end,
    long long pool_budget, int O, int bulk_kind, int self_excluded,
    void* stream) {
  if (B < 1 || B > kMaxB) return (int)cudaErrorInvalidValue;
  Args a{(const long long*)d_t, (const int*)d_s, (const int*)d_q,
         (const int*)d_k, (const long long*)d_p, (const int*)ptr,
         (const long long*)i_t, (const int*)i_s, (const int*)i_q,
         (const int*)i_k, (const long long*)i_p, (const int*)o_count,
         (const int*)gate, (const int*)gid, (const int*)need_by_kind,
         (long long*)take_t, (int*)take_s, (int*)take_q, (int*)take_k,
         (long long*)take_p, (bool*)valid, (bool*)stalled, (int*)ptr_out,
         (long long*)inbox_t, H, Kc, B, PP, NK, K, G, win_end, pool_budget,
         O, bulk_kind, self_excluded};
  if (H > 0)
    loop_select_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
