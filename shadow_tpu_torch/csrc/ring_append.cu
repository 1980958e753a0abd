// K7 ring_append: a masked append to a per-host ring.
//
// Replaces the ring writes of shadow_tpu/net/codel.py:enqueue (payload,
// src, enqueue timestamp, total_size; the caller counts overflow drops
// from `ok`) and shadow_tpu/net/nic.py:enqueue_send (payload, dst; the
// caller counts sendq drops), both soa.set_at one-hot writes at slot
// tail % Q of the rings' [H, Q] planes.
//
// Per host h: ok = mask[h] && tail - head < Q; where ok the packet lands
// at slot tail % Q (payload words, the int32 column, the int64 timestamp
// where the ring has one) and the tail advances; total_size (where given)
// adds the packet's wire size (length word + 28 or 40 header bytes).
//
// Bound: bytes. The function needs the mask, head and tail of every host
// and reads and writes one slot per appended host. This kernel is out of
// place, like the engine's state: it also writes a full copy of the ring
// planes, which dominates its time (the config-2 NIC ring is H x 64 x 12
// words) and is not part of the bound. Design: a block of 256 threads
// owns 32 hosts, whose ring rows are contiguous: the threads copy them
// with coalesced loads and stores, synchronise, then one thread per host
// writes its appended slot. Appending in place is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kHostsPerBlock = 32;
constexpr int kThreads = 256;
constexpr int kWProto = 0, kWLen = 3, kProtoTcp = 6;

struct Args {
  const int* q_payload;
  const int* q_col;
  const long long* q_ts;  // null: no timestamp column
  const int* q_head;
  const int* q_tail;
  const bool* mask;
  const int* payload;
  const int* col;
  const long long* ts;
  const long long* total;  // null: no byte tally
  int* o_payload;
  int* o_col;
  long long* o_ts;
  int* o_tail;
  long long* o_total;
  bool* o_ok;
  int H, Q, P;
};

__global__ void __launch_bounds__(kThreads) ring_append_kernel(Args a) {
  const int h0 = blockIdx.x * kHostsPerBlock;
  const int nh = min(kHostsPerBlock, a.H - h0);
  const long long rows = (long long)nh * a.Q;
  const long long base = (long long)h0 * a.Q;
  for (long long i = threadIdx.x; i < rows * a.P; i += kThreads)
    a.o_payload[base * a.P + i] = a.q_payload[base * a.P + i];
  for (long long i = threadIdx.x; i < rows; i += kThreads) {
    a.o_col[base + i] = a.q_col[base + i];
    if (a.q_ts) a.o_ts[base + i] = a.q_ts[base + i];
  }
  __syncthreads();
  if (threadIdx.x >= nh) return;
  const int h = h0 + threadIdx.x;
  const int tail = a.q_tail[h];
  const bool ok = a.mask[h] && tail - a.q_head[h] < a.Q;
  a.o_ok[h] = ok;
  a.o_tail[h] = tail + ok;
  const int* pl = a.payload + (long long)h * a.P;
  if (a.total) {
    const long long size =
        (long long)pl[kWLen] + (pl[kWProto] == kProtoTcp ? 40 : 28);
    a.o_total[h] = a.total[h] + (ok ? size : 0);
  }
  if (!ok) return;
  const long long cell = (long long)h * a.Q + ((tail % a.Q) + a.Q) % a.Q;
  for (int w = 0; w < a.P; ++w) a.o_payload[cell * a.P + w] = pl[w];
  a.o_col[cell] = a.col[h];
  if (a.q_ts) a.o_ts[cell] = a.ts[h];
}

}  // namespace

extern "C" int ring_append(const void* q_payload, const void* q_col,
                           const void* q_ts, const void* q_head,
                           const void* q_tail, const void* mask,
                           const void* payload, const void* col,
                           const void* ts, const void* total,
                           void* o_payload, void* o_col, void* o_ts,
                           void* o_tail, void* o_total, void* o_ok, int H,
                           int Q, int P, void* stream) {
  Args a{(const int*)q_payload, (const int*)q_col, (const long long*)q_ts,
         (const int*)q_head, (const int*)q_tail, (const bool*)mask,
         (const int*)payload, (const int*)col, (const long long*)ts,
         (const long long*)total, (int*)o_payload, (int*)o_col,
         (long long*)o_ts, (int*)o_tail, (long long*)o_total, (bool*)o_ok,
         H, Q, P};
  if (H > 0) {
    const int blocks = (H + kHostsPerBlock - 1) / kHostsPerBlock;
    ring_append_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}
