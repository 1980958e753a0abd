// K14 send_dequeue: the fifo qdisc's dequeue from the NIC send ring.
//
// Replaces shadow_tpu/net/qdisc/__init__.py:FifoDiscipline.dequeue (93),
// which is shadow_tpu/net/nic.py:peek_send (170) then pop_send (180): the
// send pump's one packet per invocation.
//
// Per host h: slot = q_head % NQ; the head slot's payload row and dst are
// handed up whether or not the host sends (the caller masks every use);
// do = want && q_head < q_tail; q_head' = q_head + do.
//
// Bound: bytes: the head, tail and want of every host, and one slot's
// payload row and dst read and written out a host. Design: one thread a
// host; the ring is read in place and nothing else of it is copied.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) send_dequeue_kernel(
    const int* __restrict__ q_payload, const int* __restrict__ q_dst,
    const int* __restrict__ q_head, const int* __restrict__ q_tail,
    const bool* __restrict__ want, int* __restrict__ o_payload,
    int* __restrict__ o_dst, bool* __restrict__ o_do,
    int* __restrict__ o_head, int H, int NQ, int P) {
  const int h = blockIdx.x * kThreads + threadIdx.x;
  if (h >= H) return;
  const int head = q_head[h];
  const int slot = ((head % NQ) + NQ) % NQ;
  const long long cell = (long long)h * NQ + slot;
  for (int w = 0; w < P; ++w)
    o_payload[(long long)h * P + w] = q_payload[cell * P + w];
  o_dst[h] = q_dst[cell];
  const bool d = want[h] && head < q_tail[h];
  o_do[h] = d;
  o_head[h] = head + (d ? 1 : 0);
}

}  // namespace

extern "C" int send_dequeue(const void* q_payload, const void* q_dst,
                            const void* q_head, const void* q_tail,
                            const void* want, void* o_payload, void* o_dst,
                            void* o_do, void* o_head, int H, int NQ, int P,
                            void* stream) {
  if (H > 0) {
    send_dequeue_kernel<<<(H + kThreads - 1) / kThreads, kThreads, 0,
                          (cudaStream_t)stream>>>(
        (const int*)q_payload, (const int*)q_dst, (const int*)q_head,
        (const int*)q_tail, (const bool*)want, (int*)o_payload, (int*)o_dst,
        (bool*)o_do, (int*)o_head, H, NQ, P);
  }
  return (int)cudaGetLastError();
}
