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
//     odd round pads its second half with (NEVER, 0, 0, slot 0); empty
//     slots keep their stale src and seq, which decide ties at NEVER;
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
// writes the taken cells; the prefix over hosts is the one step that is
// not per host. Design: one thread a host in blocks of kThreads, over as
// many blocks as H needs (80 at H = 10,240, 392 at 50,176, 784 at
// 100,352), in two launches:
//   1. plan: each thread plans its host once (for B up to kMaxB the
//      tournament templated on B and unrolled, so its keys stay in
//      registers; a wider inbox walks the same tournament's tree from
//      device memory, a stack of its rounds in local memory), writes
//      the plan (use_inbox, hot, room, batch), the slot and need_hot to
//      [H] scratch, and each block writes its sums of need_hot and of
//      the box rows;
//   2. apply: each block sums the need of the blocks before it and the
//      box rows of all blocks (at most a few hundred totals, read from
//      L2), scans its hosts' need in shared memory, gives each host its
//      verdict, and then writes its hosts' output rows together, thread
//      i on element i of the block's contiguous run of take_* and inbox
//      cells, so the stores and the dense payload reads are coalesced;
//      an apply block has four threads a host, so that four times as
//      many of those loads are in flight.
// The gate needs the box total of every host before any verdict, so one
// pass cannot finish it: a decoupled look-back gives the prefix but not
// the total, and a cooperative grid-wide sync would tie the grid to the
// blocks that fit on the card at once. A third launch for the scan of the
// block totals would cost a launch to save each block a few hundred L2
// reads, so the apply kernel does that scan itself. All sums are of
// integers, so their order does not change a bit.

#include <cuda_runtime.h>

#include <utility>

namespace {

constexpr long long kNever = 0x7FFFFFFFFFFFFFFFLL;
constexpr int kMaxB = 32;  // the widest inbox held in registers
constexpr int kDepth = 32;  // rounds of a wider inbox's tournament, at most
constexpr int kThreads = 128;  // hosts a block; kernels.SELECT_BLOCK
constexpr int kWarps = kThreads / 32;
// threads of an apply block: four to a host for the output rows
constexpr int kApply = 4 * kThreads;

// the plan word: use_inbox, hot, room, the batch size
constexpr int kUseInbox = 1, kHot = 2, kRoom = 4, kBulkShift = 3;

__device__ __forceinline__ bool key_lt(long long t1, int s1, int q1,
                                       long long t2, int s2, int q2) {
  return t1 < t2 || (t1 == t2 && (s1 < s2 || (s1 == s2 && q1 < q2)));
}

struct Args {
  const long long* __restrict__ d_t;
  const int* __restrict__ d_s;
  const int* __restrict__ d_q;
  const int* __restrict__ d_k;
  const long long* __restrict__ d_p;
  const int* __restrict__ ptr;
  const long long* __restrict__ i_t;
  const int* __restrict__ i_s;
  const int* __restrict__ i_q;
  const int* __restrict__ i_k;
  const long long* __restrict__ i_p;
  const int* __restrict__ o_count;
  const int* __restrict__ gate;  // null: no per-host batch limit
  const int* __restrict__ gid;
  const int* __restrict__ need_by_kind;
  long long* take_t;
  int* take_s;
  int* take_q;
  int* take_k;
  long long* take_p;
  bool* valid;
  bool* stalled;
  int* ptr_out;
  long long* inbox_t;
  long long* totals;  // [blocks, 2]: need_hot, box rows
  int* plan;          // [H] plan words
  int* need;          // [H] need of the hot hosts, 0 elsewhere
  int* slot;          // [H] the inbox slot of the minimum
  int H, Kc, PP, NK, K, G, B;
  long long win_end, pool_budget;
  int O, bulk_kind, self_excluded, blocks;
};

// one round of the tournament over the first N keys, then the rest
template <int N, int B>
__device__ __forceinline__ void tournament(long long (&tt)[B], int (&ss)[B],
                                           int (&qq)[B], int (&ii)[B]) {
  if constexpr (N > 1) {
    constexpr int half = (N + 1) / 2;
#pragma unroll
    for (int j = 0; j < half; ++j) {
      long long t2 = kNever;
      int s2 = 0, q2 = 0, i2 = 0;
      if (j + half < N) {
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
    tournament<half, B>(tt, ss, qq, ii);
  }
}

struct Key {
  long long t;
  int s, q, i;
};

// The same tournament over B slots of any width: position p after round
// r pairs positions p and p + N[r] of round r - 1 (N[r] = ceil(N[r-1] /
// 2), N[0] = B), or p and the pad where p + N[r] >= N[r-1]; the second
// wins only when strictly less. Its tree is walked depth first, first
// half before second, each pending first value on a stack of at most
// kDepth rounds, so every slot is read once.
__device__ Key tournament_wide(const Args& a, long long ib, int B) {
  int N[kDepth + 1];
  int R = 0;
  N[0] = B;
  while (N[R] > 1) {
    N[R + 1] = (N[R] + 1) / 2;
    ++R;
  }
  int fp[kDepth], fr[kDepth];
  bool second[kDepth];
  Key first[kDepth];
  int sp = 0, p = 0, r = R;
  for (;;) {
    while (r > 0) {  // down to the first slot under (p, r)
      fp[sp] = p;
      fr[sp] = r;
      second[sp] = false;
      ++sp;
      --r;
    }
    Key cur{a.i_t[ib + p], a.i_s[ib + p], a.i_q[ib + p], p};
    for (;;) {  // up through every pair whose second half is done
      if (sp == 0) return cur;
      const int top = sp - 1;
      if (!second[top]) {
        const int q = fp[top] + N[fr[top]];
        if (q < N[fr[top] - 1]) {  // the second half is a subtree
          first[top] = cur;
          second[top] = true;
          p = q;
          r = fr[top] - 1;
          break;
        }
        if (key_lt(kNever, 0, 0, cur.t, cur.s, cur.q))  // the pad
          cur = Key{kNever, 0, 0, 0};
      } else {
        const Key& f = first[top];
        if (!key_lt(cur.t, cur.s, cur.q, f.t, f.s, f.q)) cur = f;
      }
      --sp;
    }
  }
}

// the sum of v over a block of T threads, in every thread
template <int T>
__device__ __forceinline__ long long block_sum(long long v, long long* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
  __syncthreads();  // red may still be read from an earlier call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  long long s = 0;
#pragma unroll
  for (int w = 0; w < T / 32; ++w) s += red[w];
  return s;
}

// B = 0: the inbox is wider than kMaxB (a.B slots)
template <int B>
__global__ void __launch_bounds__(kThreads) plan_kernel(Args a) {
  __shared__ long long red[kWarps];
  const int h = blockIdx.x * kThreads + threadIdx.x;
  long long need_hot = 0, box = 0;
  if (h < a.H) {
    const int pt = a.ptr[h];
    const long long cell = (long long)h * a.Kc + pt;
    const long long m_raw = a.d_t[cell];
    const long long m_t = (pt < a.K && m_raw != kNever) ? m_raw : kNever;
    const int m_s = a.d_s[cell], m_q = a.d_q[cell], m_k = a.d_k[cell];

    const long long ib = (long long)h * a.B;
    long long i_time;
    int i_src, i_seq, slot;
    if constexpr (B > 0) {
      long long tt[B];
      int ss[B], qq[B], ii[B];
#pragma unroll
      for (int b = 0; b < B; ++b) {
        tt[b] = a.i_t[ib + b];
        ss[b] = a.i_s[ib + b];
        qq[b] = a.i_q[ib + b];
        ii[b] = b;
        box += tt[b] != kNever;
      }
      tournament<B, B>(tt, ss, qq, ii);
      i_time = tt[0];
      i_src = ss[0];
      i_seq = qq[0];
      slot = ii[0];
    } else {
      for (int b = 0; b < a.B; ++b) box += a.i_t[ib + b] != kNever;
      const Key m = tournament_wide(a, ib, a.B);
      i_time = m.t;
      i_src = m.s;
      i_seq = m.q;
      slot = m.i;
    }
    box += a.o_count[h];
    const bool use_inbox = key_lt(i_time, i_src, i_seq, m_t, m_s, m_q);
    const long long t = use_inbox ? i_time : m_t;
    const int k = use_inbox ? a.i_k[ib + slot] : m_k;

    int n_bulk = 0;
    if (a.bulk_kind >= 0 && a.G > 1) {
      const int me = a.gid[h];
      const int gate = a.gate ? a.gate[h] : 0x7FFFFFFF;
      bool prev = t < a.win_end && !use_inbox && k == a.bulk_kind &&
                  (!a.self_excluded || m_s != me) && gate > 0;
      // every column in range is read, whatever the columns before it
      // gave, so the loads of an unrolled run of columns overlap
      const int g_end = prev ? min(a.G, a.K - pt) : 1;
#pragma unroll 4
      for (int g = 1; g < g_end; ++g) {
        const long long i = cell + g;
        const long long tg = a.d_t[i];
        const int sg = a.d_s[i], qg = a.d_q[i], kg = a.d_k[i];
        prev = prev && tg != kNever && kg == a.bulk_kind &&
               tg < a.win_end && key_lt(tg, sg, qg, i_time, i_src, i_seq) &&
               (!a.self_excluded || sg != me) && gate >= g;
        n_bulk += prev;
      }
    }
    const int base = (k >= 0 && k < a.NK) ? a.need_by_kind[k] : 0;
    const int need = base * (1 + n_bulk);
    const bool hot = t < a.win_end;
    const bool room = a.o_count[h] + need <= a.O;
    need_hot = hot ? need : 0;
    a.plan[h] = (use_inbox ? kUseInbox : 0) | (hot ? kHot : 0) |
                (room ? kRoom : 0) | (n_bulk << kBulkShift);
    a.need[h] = (int)need_hot;
    a.slot[h] = slot;
  }
  const long long block_need = block_sum<kThreads>(need_hot, red);
  const long long block_box = block_sum<kThreads>(box, red);
  if (threadIdx.x == 0) {
    a.totals[2LL * blockIdx.x] = block_need;
    a.totals[2LL * blockIdx.x + 1] = block_box;
  }
}

// threads 0..kThreads-1 give the block's hosts their verdicts; then all
// kApply threads write the block's output rows
__global__ void __launch_bounds__(kApply) apply_kernel(Args a) {
  __shared__ long long red[kApply / 32];
  __shared__ int s_word[kThreads];  // verdict, use_inbox, taken batch
  __shared__ int s_pt[kThreads];
  __shared__ int s_slot[kThreads];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h0 = blockIdx.x * kThreads, h = h0 + tid;
  const bool mine = tid < kThreads && h < a.H;  // a host of this block

  // the need of the blocks before this one, and every block's box rows
  long long before = 0, box = 0;
  for (int j = tid; j < a.blocks; j += kApply) {
    if (j < (int)blockIdx.x) before += a.totals[2LL * j];
    box += a.totals[2LL * j + 1];
  }
  before = block_sum<kApply>(before, red);
  const long long box_used = block_sum<kApply>(box, red);

  int word = 0, pt = 0, slot = 0;
  long long need_hot = 0;
  if (mine) {
    word = a.plan[h];
    need_hot = a.need[h];
    pt = a.ptr[h];
    slot = a.slot[h];
  }
  // the exclusive prefix of need_hot over the block's hosts
  long long inc = need_hot;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long v = __shfl_up_sync(0xFFFFFFFFu, inc, o);
    if (lane >= o) inc += v;
  }
  __syncthreads();  // red was read by block_sum
  if (lane == 31 && warp < kWarps) red[warp] = inc;
  __syncthreads();
  long long cum = before + inc - need_hot;
  for (int w = 0; w < warp && w < kWarps; ++w) cum += red[w];

  if (mine) {
    const bool hot = word & kHot, room = word & kRoom;
    const bool use_inbox = word & kUseInbox;
    const bool fits = box_used + cum + need_hot <= a.pool_budget;
    const bool v = hot && room && fits;
    const int n = v ? (word >> kBulkShift) : 0;
    a.valid[h] = v;
    a.stalled[h] = hot && !(room && fits);
    a.ptr_out[h] = (v && !use_inbox) ? pt + 1 + n : pt;
    s_word[tid] = (v ? 1 : 0) | (use_inbox ? 2 : 0) | (n << 2);
    s_pt[tid] = pt;
    s_slot[tid] = slot;
  }
  __syncthreads();

  // the block's rows of the outputs, one element a thread in turn
  const int nh = min(kThreads, a.H - h0);
  const long long ob = (long long)h0 * a.G;
  for (int i = tid; i < nh * a.G; i += kApply) {
    const int hl = i / a.G, g = i - hl * a.G;
    const int w = s_word[hl];
    const long long hh = h0 + hl;
    const bool from_inbox = g == 0 && (w & 2);
    const bool tk = (w & 1) && g <= (w >> 2);
    long long t = kNever;
    int s = 0, q = 0, k = 0;
    if (tk) {
      if (from_inbox) {
        const long long j = hh * a.B + s_slot[hl];
        t = a.i_t[j];
        s = a.i_s[j];
        q = a.i_q[j];
        k = a.i_k[j];
      } else {
        const long long j = hh * a.Kc + s_pt[hl] + g;
        t = a.d_t[j];
        s = a.d_s[j];
        q = a.d_q[j];
        k = a.d_k[j];
      }
    }
    a.take_t[ob + i] = t;
    a.take_s[ob + i] = s;
    a.take_q[ob + i] = q;
    a.take_k[ob + i] = k;
  }
  const int gpp = a.G * a.PP;
  for (int i = tid; i < nh * gpp; i += kApply) {
    const int hl = i / gpp, r = i - hl * gpp;
    const int g = r / a.PP, wd = r - g * a.PP;
    const int w = s_word[hl];
    const long long hh = h0 + hl;
    long long x = 0;
    if ((w & 1) && g <= (w >> 2)) {
      x = (g == 0 && (w & 2))
              ? a.i_p[(hh * a.B + s_slot[hl]) * a.PP + wd]
              : a.d_p[(hh * a.Kc + s_pt[hl] + g) * a.PP + wd];
    }
    a.take_p[ob * a.PP + i] = x;
  }
  const long long ib = (long long)h0 * a.B;
  for (int i = tid; i < nh * a.B; i += kApply) {
    const int hl = i / a.B, b = i - hl * a.B;
    const int w = s_word[hl];
    const bool clear = (w & 1) && (w & 2) && b == s_slot[hl];
    a.inbox_t[ib + i] = clear ? kNever : a.i_t[ib + i];
  }
}

using PlanLaunch = void (*)(const Args&, cudaStream_t);

template <int B>
void launch_plan(const Args& a, cudaStream_t s) {
  plan_kernel<B><<<a.blocks, kThreads, 0, s>>>(a);
}

// launch the plan kernel instantiated for this B (1..kMaxB; 0 above)
template <int... I>
void launch_plan(int B, const Args& a, cudaStream_t s,
                 std::integer_sequence<int, I...>) {
  static constexpr PlanLaunch table[] = {&launch_plan<I>...};
  table[B <= kMaxB ? B : 0](a, s);
}

// bytes of the scratch for H hosts: the block totals, the plan words,
// the needs and the slots (kernels.loop_select allocates it)
long long scratch_bytes_for(int H) {
  const long long blocks = (H + kThreads - 1) / kThreads;
  return 16 * blocks + 12LL * H;
}

}  // namespace

extern "C" int loop_select(
    const void* d_t, const void* d_s, const void* d_q, const void* d_k,
    const void* d_p, const void* ptr, const void* i_t, const void* i_s,
    const void* i_q, const void* i_k, const void* i_p, const void* o_count,
    const void* gate, const void* gid, const void* need_by_kind,
    void* take_t, void* take_s, void* take_q, void* take_k, void* take_p,
    void* valid, void* stalled, void* ptr_out, void* inbox_t, void* scratch,
    long long scratch_bytes, int H, int Kc, int B, int PP, int NK, int K,
    int G, long long win_end, long long pool_budget, int O, int bulk_kind,
    int self_excluded, void* stream) {
  if (B < 1 || G < 1 || G - 1 >= (1 << 23) ||
      scratch_bytes < scratch_bytes_for(H))
    return (int)cudaErrorInvalidValue;
  if (H <= 0) return (int)cudaGetLastError();
  const int blocks = (H + kThreads - 1) / kThreads;
  long long* totals = (long long*)scratch;
  int* plan = (int*)(totals + 2LL * blocks);
  Args a{(const long long*)d_t, (const int*)d_s, (const int*)d_q,
         (const int*)d_k, (const long long*)d_p, (const int*)ptr,
         (const long long*)i_t, (const int*)i_s, (const int*)i_q,
         (const int*)i_k, (const long long*)i_p, (const int*)o_count,
         (const int*)gate, (const int*)gid, (const int*)need_by_kind,
         (long long*)take_t, (int*)take_s, (int*)take_q, (int*)take_k,
         (long long*)take_p, (bool*)valid, (bool*)stalled, (int*)ptr_out,
         (long long*)inbox_t, totals, plan, plan + H, plan + 2LL * H, H, Kc,
         PP, NK, K, G,
         B, win_end, pool_budget, O, bulk_kind, self_excluded, blocks};
  const cudaStream_t s = (cudaStream_t)stream;
  launch_plan(B, a, s, std::make_integer_sequence<int, kMaxB + 1>{});
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  apply_kernel<<<blocks, kApply, 0, s>>>(a);
  return (int)cudaGetLastError();
}
