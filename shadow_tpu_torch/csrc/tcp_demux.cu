// K8 tcp_demux: the socket each host's incoming segment belongs to.
//
// Replaces shadow_tpu/net/tcp.py:demux (called from Tcp.on_segment): over
// the host's S sockets, score 2 for a used non-listener whose local port,
// peer host and peer port match the segment, 1 for a listener on the
// destination port; the first socket of the highest score wins (jnp.argmax),
// slot 0 when none scores. Outputs slot, found = mask & score > 0 and
// is_listener = found & score == 1.
//
// Bound: bytes (the [H, S] port, peer and state columns, read once). One
// thread a host walks its S sockets; neighbouring threads read rows S
// elements apart, which the L1 and L2 absorb at S = 8.

#include "tcp_common.cuh"

namespace {

__global__ void __launch_bounds__(tcp::kThreads)
    tcp_demux_kernel(const bool* used, const int* local_port,
                     const int* peer_host, const int* peer_port,
                     const int* state, const bool* mask, const int* dport,
                     const int* sport, const int* src, int* slot, bool* found,
                     bool* is_listener, int H, int S) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= H) return;
  const long long r = (long long)h * S;
  const int dp = dport[h], sp = sport[h], sh = src[h];
  int best = 0, arg = 0;
  for (int s = 0; s < S; ++s) {
    const long long i = r + s;
    const bool port_ok = used[i] && local_port[i] == dp;
    const bool listener = state[i] == tcp::kListen;
    const int score =
        (port_ok && !listener && peer_host[i] == sh && peer_port[i] == sp)
            ? 2
            : (port_ok && listener ? 1 : 0);
    if (score > best) {
      best = score;
      arg = s;
    }
  }
  const bool f = mask[h] && best > 0;
  slot[h] = arg;
  found[h] = f;
  is_listener[h] = f && best == 1;
}

}  // namespace

extern "C" int tcp_demux(const void* used, const void* local_port,
                         const void* peer_host, const void* peer_port,
                         const void* state, const void* mask,
                         const void* dport, const void* sport,
                         const void* src, void* slot, void* found,
                         void* is_listener, int H, int S, void* stream) {
  if (H > 0)
    tcp_demux_kernel<<<tcp::blocks(H), tcp::kThreads, 0,
                       (cudaStream_t)stream>>>(
        (const bool*)used, (const int*)local_port, (const int*)peer_host,
        (const int*)peer_port, (const int*)state, (const bool*)mask,
        (const int*)dport, (const int*)sport, (const int*)src, (int*)slot,
        (bool*)found, (bool*)is_listener, H, S);
  return (int)cudaGetLastError();
}
