// K23 qdisc_dequeue: one packet from each wanting host's device-queue
// discipline (pifo or eiffel), with no hook or the CoDel hook, in place.
//
// Replaces shadow_tpu/net/qdisc/pifo.py:DeviceQueueDiscipline.dequeue
// (200) with its parts: the pop (pifo.py:_pop, 154: slot 0 and the left
// shift of the whole row; eiffel.py:_pop, 81: the circular argmin over
// ((bucket - cur_bucket) mod B) * 2^40 + seq, slot 0 where no slot is
// valid), plain_dequeue or codel_dequeue (drops.py:94-183 with
// DROP_UNROLL = 1: the sojourn bookkeeping of _pop_bookkeeping, the
// drop-mode step, the transition to drop mode; the control law of
// codel_common.cuh, which K6 codel_dequeue shares) and the counters.
//
// A pop reads its slot whether or not it pops (the packet in hand where
// `have` is false: slot 0, or the argmin's slot 0 of an empty Eiffel
// row), and the result hands up the packet of the last pop the hook ran,
// as the JAX package's selects do. A pop that pops takes its wire bytes
// off q_bytes, raises vtime to its rank and, for Eiffel, moves cur_bucket
// to its bucket; the sojourn test reads q_bytes after the pop. Every sum
// or comparison with `now` runs only where a packet is in hand (lanes
// without an event carry now = NEVER). PIFO's shift copies slot j + 1 to
// j for every j < Q - 1, the cells past q_len too, as
// pifo.py:_shift_left does.
//
// Bound: bytes. The function reads each host's per-host state and the
// slots it pops (Eiffel: the row's valid flags, buckets and seqs for the
// scan) and writes the state, the popped slots (PIFO: the whole row,
// shifted) and one packet a host. Design: one thread a host; the row is
// walked by its thread (rows hold at most Q = 64 slots); coalescing the
// walk across a warp is later work.

#include "qdisc_common.cuh"

#include <climits>

namespace {

using namespace qdisc;

struct Args {
  Plane s;
  const long long* now;
  const bool* want;
  bool* o_have;
  int* o_payload;
  int* o_dst;
  long long now_stride, buckets;
  int H, Q, P, eiffel, codel;
};

struct Host {
  const Args& a;
  long long row, now;
  int len;
  long long cur_bucket, q_bytes, vtime, ie;
  // the packet in hand: the slot the last pop read
  int payload[kMaxP];
  int dst;
  long long enq_ts;

  // one masked pop; returns have, and empty_hit through its argument
  __device__ bool pop(bool want, bool& empty_hit) {
    const Plane& s = a.s;
    const int Q = a.Q, P = a.P;
    int slot = 0;
    bool present;
    if (a.eiffel) {
      long long best = LLONG_MAX;
      present = false;
      for (int j = 0; j < Q; ++j) {
        if (!s.q_valid[row + j]) continue;
        present = true;
        const long long rel =
            floor_mod(wsub(s.q_bucket[row + j], cur_bucket), a.buckets);
        const long long key = wadd(wmul(rel, 1LL << 40), s.q_seq[row + j]);
        if (key < best) {
          best = key;
          slot = j;
        }
      }
    } else {
      present = len > 0;
    }
    const bool have = want && present;
    empty_hit = want && !present;
    const long long cell = row + slot;
    copy_words(payload, s.q_payload + cell * P, P);
    dst = s.q_dst[cell];
    enq_ts = s.q_enq_ts[cell];
    const long long rank = s.q_rank[cell];
    if (have) {
      if (a.eiffel) {
        s.q_valid[cell] = false;
        cur_bucket = s.q_bucket[cell];
      } else {
        for (int j = 0; j < Q - 1; ++j) {
          int* to = s.q_payload + (row + j) * P;
          copy_words(to, to + P, P);
          s.q_dst[row + j] = s.q_dst[row + j + 1];
          s.q_rank[row + j] = s.q_rank[row + j + 1];
          s.q_seq[row + j] = s.q_seq[row + j + 1];
          s.q_enq_ts[row + j] = s.q_enq_ts[row + j + 1];
        }
        len -= 1;
      }
      q_bytes = wsub(q_bytes, codel::wire_bytes(payload));
      vtime = lmax(vtime, rank);
    }
    return have;
  }

  // a pop with CoDel's sojourn bookkeeping (_pop_bookkeeping): returns
  // have, and ok_to_drop through its argument
  __device__ bool pop_checked(bool want, bool& ok) {
    const long long ie0 = ie;
    bool empty_hit;
    const bool have = pop(want, empty_hit);
    ok = false;
    if (have) {
      const bool good =
          wsub(now, enq_ts) < codel::kTarget || q_bytes < codel::kMtu;
      if (good)
        ie = 0;
      else if (ie0 == 0)
        ie = now + codel::kInterval;
      ok = !good && ie0 != 0 && now >= ie0;
    }
    if (empty_hit) ie = 0;
    return have;
  }
};

__global__ void __launch_bounds__(kBlock) qdisc_dequeue_kernel(Args a) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= a.H) return;
  const Plane& s = a.s;
  Host x{a, (long long)h * a.Q, a.now[(long long)h * a.now_stride],
         a.eiffel ? 0 : s.q_len[h], a.eiffel ? s.cur_bucket[h] : 0,
         s.q_bytes[h], s.vtime[h], s.interval_expire[h]};
  const bool m = a.want[h];
  bool have;
  if (!a.codel) {
    bool empty_hit;
    have = x.pop(m, empty_hit);
  } else {
    bool dm = s.drop_mode[h];
    long long nd = s.next_drop[h];
    int dc = s.drop_count[h], dcl = s.drop_count_last[h];
    long long dropped = 0;
    bool ok;
    have = x.pop_checked(m, ok);
    if (m && !have) dm = false;  // empty: store mode
    if (m && have && dm && !ok) dm = false;  // delays low again
    if (m && have && dm && x.now >= nd) {  // drop-mode step
      ++dropped;
      ++dc;
      bool ok2;
      have = x.pop_checked(true, ok2);
      ok = ok2;
      if (ok2)
        nd = codel::control_law(dc, nd);
      else
        dm = false;
    }
    if (m && have && !dm && ok) {  // store mode, but this one drops
      ++dropped;
      bool ok3;
      have = x.pop_checked(true, ok3);
      const int delta = dc - dcl;
      const bool recently = x.now < nd + 16 * codel::kInterval;
      const int nc = (recently && delta > 1) ? delta : 1;
      dm = true;
      dc = nc;
      nd = codel::control_law(nc, x.now);
      dcl = nc;
    }
    s.drop_mode[h] = dm;
    s.next_drop[h] = nd;
    s.drop_count[h] = dc;
    s.drop_count_last[h] = dcl;
    s.drops_codel[h] += dropped;
    s.interval_expire[h] = x.ie;
  }
  if (have) {
    s.dequeues[h] += 1;
    s.sojourn_sum[h] = wadd(s.sojourn_sum[h], wsub(x.now, x.enq_ts));
  }
  if (a.eiffel)
    s.cur_bucket[h] = x.cur_bucket;
  else
    s.q_len[h] = x.len;
  s.q_bytes[h] = x.q_bytes;
  s.vtime[h] = x.vtime;
  a.o_have[h] = have;
  copy_words(a.o_payload + (long long)h * a.P, x.payload, a.P);
  a.o_dst[h] = x.dst;
}

}  // namespace

// a: the kFields field pointers (kernels.QDISC_FIELDS), then now,
// now_stride, want, have, payload, dst, H, Q, P, eiffel, codel, buckets
// (kernels.qdisc_dequeue packs them in this order)
extern "C" int qdisc_dequeue(const long long* a, void* stream) {
  Args k;
  k.s = unpack(a);
  const long long* b = a + kFields;
  k.now = (const long long*)b[0];
  k.now_stride = b[1];
  k.want = (const bool*)b[2];
  k.o_have = (bool*)b[3];
  k.o_payload = (int*)b[4];
  k.o_dst = (int*)b[5];
  k.H = (int)b[6];
  k.Q = (int)b[7];
  k.P = (int)b[8];
  k.eiffel = (int)b[9];
  k.codel = (int)b[10];
  k.buckets = b[11];
  if (k.P > kMaxP || k.Q < 1) return (int)cudaErrorInvalidValue;
  if (k.H > 0) {
    qdisc_dequeue_kernel<<<blocks(k.H), kBlock, 0, (cudaStream_t)stream>>>(k);
  }
  return (int)cudaGetLastError();
}
