// K17 nic_rx: the admission of every arriving packet, in one launch.
//
// Replaces the device work of shadow_tpu/net/stack.py:
// NetStack.on_pkt_deliver (293) ahead of its enqueue and delivery: the
// receive bucket's lazy refill (shadow_tpu/net/nic.py:lazy_refill, K13's)
// on the remote arrivals, the direct-delivery test, the token charge, the
// CoDel state of a zero-sojourn dequeue where a packet goes straight
// through, and the masks of what the router queues, what finds its ring
// full and what is delivered now. The caller keeps the ring append, the
// delivery and the receive pump.
//
// Per host h:
//   loopback   = mask && src == gid;  remote = mask && src != gid
//   rem, tick  = the rx bucket refilled to now, where remote (nic_common.cuh)
//   boot       = now < bootstrap_end
//   direct     = remote && !(q_head < q_tail) && (boot || rem >= MTU)
//   rem       -= wire size where direct && !boot            (debt allowed)
//   interval_expire = 0, drop_mode = false where direct
//   queued     = remote && !direct
//   no_room    = queued && !(q_tail - q_head < Q)   (int32, wrapping)
//   local      = loopback || direct
// Everything is written out of place, into one int64 allocation that the
// wrapper slices into views: three rows [H] (rem, tick, interval_expire),
// then four bool rows [H] (drop_mode, queued, no_room, local).
//
// Bound: bytes (each host's mask, src, gid, now, bucket, ring head and
// tail, two payload words and CoDel interval and mode in; the rows out).
// The arguments come packed in one host array of int64, as nic_tx's.
// A few microseconds of device time: what it saves is K13's launch and
// the dozen PyTorch operations around it. Design: one thread a host, all
// its loads in one round, the stores at the end.

#include "nic_common.cuh"

namespace {

struct Args {
  const bool* mask;
  const int* src;
  const int* gid;
  const long long* now;
  const long long *rem, *tick, *refill, *cap;
  const int *q_head, *q_tail;
  const int* payload;
  const long long* interval_expire;
  const bool* drop_mode;
  long long bootstrap_end;
  long long payload_stride;
  long long* out;
  int now_stride, Q, H;
};

__global__ void __launch_bounds__(nic::kBlock) nic_rx_kernel(Args a) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  const int H = a.H;
  if (h >= H) return;
  // every load first
  const bool mask = a.mask[h];
  const int src = a.src[h], gid = a.gid[h];
  const long long now = a.now[(long long)h * a.now_stride];
  const long long rem0 = a.rem[h], tick0 = a.tick[h];
  const long long refill = a.refill[h], cap = a.cap[h];
  const int head = a.q_head[h], tail = a.q_tail[h];
  const int* w = a.payload + (long long)h * a.payload_stride;
  const int proto = w[nic::kWProto], len = w[nic::kWLen];
  const long long ie = a.interval_expire[h];
  const bool dm = a.drop_mode[h];

  const bool remote = mask && src != gid;
  long long rem = rem0, tick = tick0;
  if (remote) nic::refill(rem0, tick0, refill, cap, now, rem, tick);
  const bool boot = now < a.bootstrap_end;
  const bool direct = remote && !(head < tail) && (boot || rem >= nic::kMtu);
  if (direct && !boot) rem = nic::wsub(rem, nic::wire_bytes(proto, len));
  const bool queued = remote && !direct;
  const int count = (int)((unsigned)tail - (unsigned)head);

  long long* o = a.out;
  o[h] = rem;
  o[H + h] = tick;
  o[2LL * H + h] = direct ? 0 : ie;
  bool* b = (bool*)(o + 3LL * H);
  b[h] = direct ? false : dm;
  b[H + h] = queued;
  b[2LL * H + h] = queued && !(count < a.Q);
  b[3LL * H + h] = (mask && src == gid) || direct;
}

}  // namespace

// a: mask, src, gid, now, now_stride, rem, tick, refill, cap, q_head,
// q_tail, Q, payload, payload_stride, interval_expire, drop_mode,
// bootstrap_end, out, H (kernels.nic_rx packs them in this order)
extern "C" int nic_rx(const long long* a, void* stream) {
  const int H = (int)a[18];
  Args k{(const bool*)a[0],
         (const int*)a[1],
         (const int*)a[2],
         (const long long*)a[3],
         (const long long*)a[5],
         (const long long*)a[6],
         (const long long*)a[7],
         (const long long*)a[8],
         (const int*)a[9],
         (const int*)a[10],
         (const int*)a[12],
         (const long long*)a[14],
         (const bool*)a[15],
         a[16],
         a[13],
         (long long*)a[17],
         (int)a[4],
         (int)a[11],
         H};
  if (H > 0) {
    nic_rx_kernel<<<nic::blocks(H), nic::kBlock, 0, (cudaStream_t)stream>>>(k);
  }
  return (int)cudaGetLastError();
}
