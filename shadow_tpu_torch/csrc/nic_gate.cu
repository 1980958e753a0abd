// K18 nic_gate: the bulk gate of a micro-step, in one launch.
//
// Replaces shadow_tpu/net/stack.py:NetStack.bulk_gate (483): how many
// extra consecutive arrivals each host may batch this micro-step such
// that every one provably takes the direct paths. It ran two lazy refills
// (shadow_tpu/net/nic.py:lazy_refill, K13's) and a dozen PyTorch
// operations.
//
// Per host h:
//   rx, tx     = the rx and tx buckets refilled to win_start, in
//                registers only (the ticks are not written back)
//                                                        (nic_common.cuh)
//   rx_ev      = G where the whole window lies in bootstrap (`free`),
//                else floor(rx / MTU) (floors on token debt, as JAX's //)
//   tx_ev      likewise
//   quiet      = router ring empty && !queued && !recv_pending
//                && !send_pending
//   gate       = quiet ? clamp(min(rx_ev, tx_ev) - 1, 0, G - 1) : 0
//
// Bound: bytes (two buckets, the router ring's head and tail and three
// flags a host in; the int32 gate out). Design: one thread a host, all
// its loads in one round. The arguments come packed in one host array of
// int64, as nic_tx's.

#include "nic_common.cuh"

namespace {

struct Args {
  const long long *rx_rem, *rx_tick, *rx_refill, *rx_cap;
  const long long *tx_rem, *tx_tick, *tx_refill, *tx_cap;
  const int *r_head, *r_tail;
  const bool *queued, *recv_pending, *send_pending;
  long long win_start;
  int* out;
  int free_window, G, H;
};

__global__ void __launch_bounds__(nic::kBlock) nic_gate_kernel(Args a) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= a.H) return;
  const long long rx0 = a.rx_rem[h], rxt = a.rx_tick[h];
  const long long rxr = a.rx_refill[h], rxc = a.rx_cap[h];
  const long long tx0 = a.tx_rem[h], txt = a.tx_tick[h];
  const long long txr = a.tx_refill[h], txc = a.tx_cap[h];
  const int head = a.r_head[h], tail = a.r_tail[h];
  const bool busy = a.queued[h] || a.recv_pending[h] || a.send_pending[h];

  long long rx, tx, tick;
  nic::refill(rx0, rxt, rxr, rxc, a.win_start, rx, tick);
  nic::refill(tx0, txt, txr, txc, a.win_start, tx, tick);
  const long long G = a.G;
  const long long rx_ev = a.free_window ? G : nic::floordiv(rx, nic::kMtu);
  const long long tx_ev = a.free_window ? G : nic::floordiv(tx, nic::kMtu);
  long long cap = (rx_ev < tx_ev ? rx_ev : tx_ev) - 1;
  cap = cap < 0 ? 0 : (cap > G - 1 ? G - 1 : cap);
  a.out[h] = (!(head < tail) && !busy) ? (int)cap : 0;
}

}  // namespace

// a: rx_rem, rx_tick, rx_refill, rx_cap, tx_rem, tx_tick, tx_refill,
// tx_cap, r_head, r_tail, queued, recv_pending, send_pending, win_start,
// free, G, out, H (kernels.nic_gate packs them in this order)
extern "C" int nic_gate(const long long* a, void* stream) {
  const int H = (int)a[17];
  Args k{(const long long*)a[0],
         (const long long*)a[1],
         (const long long*)a[2],
         (const long long*)a[3],
         (const long long*)a[4],
         (const long long*)a[5],
         (const long long*)a[6],
         (const long long*)a[7],
         (const int*)a[8],
         (const int*)a[9],
         (const bool*)a[10],
         (const bool*)a[11],
         (const bool*)a[12],
         a[13],
         (int*)a[16],
         (int)a[14],
         (int)a[15],
         H};
  if (H > 0) {
    nic_gate_kernel<<<nic::blocks(H), nic::kBlock, 0,
                      (cudaStream_t)stream>>>(k);
  }
  return (int)cudaGetLastError();
}
