// K6 codel_dequeue: the CoDel router's dequeue, one deliverable packet per
// masked host.
//
// Replaces shadow_tpu/net/codel.py:dequeue with DROP_UNROLL = 1: the
// sojourn-checked pop (_pop_helper), the drop-mode loop (at most one
// control-law drop and re-pop), the transition from store to drop mode,
// and the drop count. aqm = 0 is the drop-tail pop alone (the static and
// single router variants). _record_drop writes only with packet trails
// (P > 12), which the port does not run, so the trail registers are
// untouched.
//
// The control law (codel_common.cuh, shared with K23 qdisc_dequeue's
// CoDel hook) is next = ts + round(INTERVAL / sqrt(max(count, 1))) in
// float64 with ties to even. Every time comparison and sum that involves `now` is taken only on a lane
// that has a packet in hand: lanes without an event carry now = NEVER, and
// now + INTERVAL would overflow there.
//
// Bound: bytes. The function reads the per-host CoDel state and at most
// three ring slots a host, and writes the state and one packet a host.
// Design: one thread per host; the ring is read in place at head % Q.

#include "codel_common.cuh"

namespace {

using codel::control_law;
using codel::kInterval;
using codel::kMtu;
using codel::kProtoTcp;
using codel::kTarget;
using codel::kWLen;
using codel::kWProto;

struct Args {
  const int* q_payload;
  const int* q_src;
  const long long* q_enq_ts;
  const int* q_head;
  const int* q_tail;
  const bool* drop_mode;
  const long long* interval_expire;
  const long long* next_drop;
  const int* drop_count;
  const int* drop_count_last;
  const long long* total_size;
  const long long* now;
  const bool* mask;
  int* o_head;
  long long* o_total;
  long long* o_ie;
  bool* o_drop_mode;
  long long* o_next_drop;
  int* o_drop_count;
  int* o_drop_count_last;
  int* o_dropped;
  bool* o_have;
  int* o_payload;
  int* o_src;
  int H, Q, P, aqm;
};

struct Ring {
  const Args& a;
  int h, head, tail;
  long long total, ie, now;

  // one masked pop with sojourn bookkeeping; `slot` is the ring slot whose
  // packet is in hand afterwards (the head slot, popped or not)
  __device__ void pop(bool want, bool& have, int& slot, bool& ok) {
    const bool nonempty = head < tail;
    have = want && nonempty;
    slot = ((head % a.Q) + a.Q) % a.Q;
    ok = false;
    if (have) {
      const long long cell = (long long)h * a.Q + slot;
      const int* pl = a.q_payload + cell * a.P;
      const long long size =
          (long long)pl[kWLen] + (pl[kWProto] == kProtoTcp ? 40 : 28);
      const long long new_total = total - size;
      const bool good = now - a.q_enq_ts[cell] < kTarget || new_total < kMtu;
      const long long ie0 = ie;
      if (good)
        ie = 0;
      else if (ie0 == 0)
        ie = now + kInterval;
      ok = !good && ie0 != 0 && now >= ie0;
      head += 1;
      total = new_total;
    } else if (want) {
      ie = 0;  // an empty queue resets the interval
    }
  }
};

__global__ void codel_dequeue_kernel(Args a) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= a.H) return;
  Ring r{a, h, a.q_head[h], a.q_tail[h], a.total_size[h],
         a.interval_expire[h], a.now[h]};
  bool dm = a.drop_mode[h];
  long long nd = a.next_drop[h];
  int dc = a.drop_count[h], dcl = a.drop_count_last[h];
  const bool m = a.mask[h];
  int dropped = 0;
  bool have, ok;
  int slot;
  r.pop(m, have, slot, ok);
  if (a.aqm) {
    if (m && !have) dm = false;  // empty: store mode
    if (m && have && dm && !ok) dm = false;  // delays low again
    if (m && have && dm && r.now >= nd) {
      ++dropped;
      ++dc;
      bool have2, ok2;
      r.pop(true, have2, slot, ok2);
      have = have2;
      ok = ok2;
      if (ok2)
        nd = control_law(dc, nd);
      else
        dm = false;
    }
    if (m && have && !dm && ok) {  // store mode, but this one drops
      ++dropped;
      bool have3, ok3;
      r.pop(true, have3, slot, ok3);
      have = have3;
      const int delta = dc - dcl;
      const bool recently = r.now < nd + 16 * kInterval;
      const int nc = (recently && delta > 1) ? delta : 1;
      dm = true;
      dc = nc;
      nd = control_law(nc, r.now);
      dcl = nc;
    }
  }
  a.o_head[h] = r.head;
  a.o_total[h] = r.total;
  a.o_ie[h] = r.ie;
  a.o_drop_mode[h] = dm;
  a.o_next_drop[h] = nd;
  a.o_drop_count[h] = dc;
  a.o_drop_count_last[h] = dcl;
  a.o_dropped[h] = dropped;
  a.o_have[h] = have;
  const long long cell = (long long)h * a.Q + slot;
  for (int w = 0; w < a.P; ++w)
    a.o_payload[(long long)h * a.P + w] = a.q_payload[cell * a.P + w];
  a.o_src[h] = a.q_src[cell];
}

}  // namespace

extern "C" int codel_dequeue(
    const void* q_payload, const void* q_src, const void* q_enq_ts,
    const void* q_head, const void* q_tail, const void* drop_mode,
    const void* interval_expire, const void* next_drop,
    const void* drop_count, const void* drop_count_last,
    const void* total_size, const void* now, const void* mask, void* o_head,
    void* o_total, void* o_ie, void* o_drop_mode, void* o_next_drop,
    void* o_drop_count, void* o_drop_count_last, void* o_dropped,
    void* o_have, void* o_payload, void* o_src, int H, int Q, int P,
    int aqm, void* stream) {
  Args a{(const int*)q_payload, (const int*)q_src,
         (const long long*)q_enq_ts, (const int*)q_head, (const int*)q_tail,
         (const bool*)drop_mode, (const long long*)interval_expire,
         (const long long*)next_drop, (const int*)drop_count,
         (const int*)drop_count_last, (const long long*)total_size,
         (const long long*)now, (const bool*)mask, (int*)o_head,
         (long long*)o_total, (long long*)o_ie, (bool*)o_drop_mode,
         (long long*)o_next_drop, (int*)o_drop_count,
         (int*)o_drop_count_last, (int*)o_dropped, (bool*)o_have,
         (int*)o_payload, (int*)o_src, H, Q, P, aqm};
  if (H > 0) {
    const int threads = 128;
    codel_dequeue_kernel<<<(H + threads - 1) / threads, threads, 0,
                           (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}
