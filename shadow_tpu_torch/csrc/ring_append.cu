// K7 ring_append: a masked append to a per-host ring, in place.
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
// The ring planes are written in place: the kernel stores each appended
// slot into the planes it is given and touches no other cell; tail,
// total_size and ok go to fresh [H] outputs. The input tail is not
// written, so a repeated call on the same inputs writes the same cells.
//
// Bound: bytes. The function needs the mask, head and tail of every host
// and writes one slot per appended host. Design: one thread a host in
// blocks of 256; the per-host reads coalesce, and an appended host
// stores its slot's payload words as 16-byte words where the row length
// and the pointers allow (P = 12: a 48-byte slot in three int4 stores).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWProto = 0, kWLen = 3, kProtoTcp = 6;

struct Args {
  int* q_payload;      // [H, Q, P], written in place
  int* q_col;          // [H, Q], written in place
  long long* q_ts;     // [H, Q], written in place; null: no timestamps
  const int* q_head;
  const int* q_tail;
  const bool* mask;
  const int* payload;  // [H, P]
  const int* col;
  const long long* ts;
  const long long* total;  // null: no byte tally
  int* o_tail;
  long long* o_total;
  bool* o_ok;
  int H, Q, P;
  bool vec;  // P % 4 == 0 and both payload pointers 16-byte aligned
};

__global__ void __launch_bounds__(kThreads) ring_append_kernel(Args a) {
  const int h = blockIdx.x * kThreads + threadIdx.x;
  if (h >= a.H) return;
  const int tail = a.q_tail[h];
  const bool ok = a.mask[h] && tail - a.q_head[h] < a.Q;
  a.o_ok[h] = ok;
  a.o_tail[h] = tail + ok;
  const int* pl = a.payload + (long long)h * a.P;
  if (a.total) {
    long long size = 0;
    if (ok) size = (long long)pl[kWLen] + (pl[kWProto] == kProtoTcp ? 40 : 28);
    a.o_total[h] = a.total[h] + size;
  }
  if (!ok) return;
  const long long cell = (long long)h * a.Q + ((tail % a.Q) + a.Q) % a.Q;
  if (a.vec) {
    const int4* src = reinterpret_cast<const int4*>(pl);
    int4* dst = reinterpret_cast<int4*>(a.q_payload + cell * a.P);
    for (int w = 0; w < a.P / 4; ++w) dst[w] = src[w];
  } else {
    for (int w = 0; w < a.P; ++w) a.q_payload[cell * a.P + w] = pl[w];
  }
  a.q_col[cell] = a.col[h];
  if (a.q_ts) a.q_ts[cell] = a.ts[h];
}

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" int ring_append(void* q_payload, void* q_col, void* q_ts,
                           const void* q_head, const void* q_tail,
                           const void* mask, const void* payload,
                           const void* col, const void* ts,
                           const void* total, void* o_tail, void* o_total,
                           void* o_ok, int H, int Q, int P, void* stream) {
  Args a{(int*)q_payload, (int*)q_col, (long long*)q_ts,
         (const int*)q_head, (const int*)q_tail, (const bool*)mask,
         (const int*)payload, (const int*)col, (const long long*)ts,
         (const long long*)total, (int*)o_tail, (long long*)o_total,
         (bool*)o_ok, H, Q, P,
         P % 4 == 0 && aligned16(q_payload) && aligned16(payload)};
  if (H > 0) {
    const int blocks = (H + kThreads - 1) / kThreads;
    ring_append_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}
