// K10 tcp_reorder: the data-receive block of one incoming segment per host.
//
// Replaces the reorder scoreboard of shadow_tpu/net/tcp.py:Tcp.on_segment
// (lines 1001-1048) and _pack_sack (340-349) of the ACK reply. The board
// is a host's [S, W] bool array; chunk k of a socket's row is
// [rcv_nxt + k*MSS, +MSS). On a socket that can receive (ESTABLISHED,
// FIN_WAIT_1, FIN_WAIT_2): an in-order segment advances rcv_nxt by its
// length and, when it is a full MSS, by the run of chunks already held
// after it, shifting the row down by 1 + that run (a short segment clears
// the row); an out-of-order segment that is MSS long, MSS-aligned and
// within the board sets its chunk, any other is counted as dropped.
// bytes_received gains what was delivered in order. The SACK word is the
// first 32 chunks of the slot's row after the update, as the int32 bit
// pattern of a uint32.
//
// Outputs new rcv_nxt, ooo_map and bytes_received (the inputs but at each
// masked host's slot), and per host the decision bits (RO_* in
// kernels.py), the bytes delivered up and the SACK word. A masked-off
// host's values are read from its clipped slot and nothing of it is
// written.
//
// Bound: bytes, chiefly the [H, S, W] board copied out. One thread a host
// copies its S*W bytes of board in 16-byte words where the row length
// allows, then rewrites the slot's row; the run of held chunks is a scan
// that stops at the first hole.

#include "tcp_common.cuh"

namespace {

using namespace tcp;

__global__ void __launch_bounds__(kThreads)
    tcp_reorder_kernel(const bool* mask, const int* slot, const int* seg_seq,
                       const int* seg_len, const int* state,
                       const int* rcv_nxt, const long long* bytes_received,
                       const bool* ooo_map, int* o_rcv_nxt, bool* o_ooo_map,
                       long long* o_bytes_received, int* o_flags, int* o_adv,
                       int* o_sack, int H, int S, int W, int mss) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= H) return;
  const long long r = (long long)h * S;
  copy_row(o_rcv_nxt, rcv_nxt, r, S);
  copy_row(o_bytes_received, bytes_received, r, S);
  const long long nb = (long long)S * W;
  if (nb % 16 == 0) {
    const uint4* src = (const uint4*)(ooo_map + r * W);
    uint4* dst = (uint4*)(o_ooo_map + r * W);
    for (long long k = 0; k < nb / 16; ++k) dst[k] = src[k];
  } else {
    for (long long k = 0; k < nb; ++k)
      o_ooo_map[r * W + k] = ooo_map[r * W + k];
  }

  const int sl = slot[h];
  const long long i = r + clip_slot(sl, S);
  const bool* om = ooo_map + i * W;
  const int st = state[i];
  const int len = seg_len[h];
  const bool m_data = mask[h] && len > 0 &&
                      (st == kEstablished || st == kFinWait1 ||
                       st == kFinWait2);
  const int rn = rcv_nxt[i];
  const int d = wsub(seg_seq[h], rn);
  const bool in_order = m_data && d == 0;
  const bool full = len == mss;
  int n_absorb = 0;
  if (full)
    while (1 + n_absorb < W && om[1 + n_absorb]) ++n_absorb;
  const int adv = in_order ? wadd(len, n_absorb * mss) : 0;
  const int shift = full ? 1 + n_absorb : W;
  const bool m_ooo = m_data && d > 0;
  const int kchunk = floordiv(d, mss);
  const bool aligned = m_ooo && d - kchunk * mss == 0 && full &&
                       kchunk >= 1 && kchunk < W;
  const bool touched = in_order || aligned;

  // the slot's row after the update, written where touched, packed for
  // the SACK word either way
  bool* orow = o_ooo_map + i * W;
  const bool write = touched && sl >= 0 && sl < S;
  unsigned sack = 0u;
  for (int j = 0; j < W; ++j) {
    bool v = om[j];
    if (in_order) v = j + shift < W ? om[j + shift] : false;
    if (aligned && j == kchunk) v = true;
    if (write) orow[j] = v;
    if (j < 32 && v) sack |= 1u << j;
  }
  if (in_order && sl >= 0 && sl < S) {
    o_rcv_nxt[r + sl] = wadd(rn, adv);
    o_bytes_received[r + sl] = bytes_received[r + sl] + (long long)adv;
  }
  o_flags[h] = (int)in_order | (int)aligned << 1 |
               (int)(m_ooo && !aligned) << 2 |
               (int)(in_order && n_absorb > 0) << 3;
  o_adv[h] = adv;
  o_sack[h] = (int)sack;
}

}  // namespace

extern "C" int tcp_reorder(const void* mask, const void* slot,
                           const void* seg_seq, const void* seg_len,
                           const void* state, const void* rcv_nxt,
                           const void* bytes_received, const void* ooo_map,
                           void* o_rcv_nxt, void* o_ooo_map,
                           void* o_bytes_received, void* o_flags, void* o_adv,
                           void* o_sack, int H, int S, int W, int mss,
                           void* stream) {
  if (H > 0)
    tcp_reorder_kernel<<<blocks(H), kThreads, 0, (cudaStream_t)stream>>>(
        (const bool*)mask, (const int*)slot, (const int*)seg_seq,
        (const int*)seg_len, (const int*)state, (const int*)rcv_nxt,
        (const long long*)bytes_received, (const bool*)ooo_map,
        (int*)o_rcv_nxt, (bool*)o_ooo_map, (long long*)o_bytes_received,
        (int*)o_flags, (int*)o_adv, (int*)o_sack, H, S, W, mss);
  return (int)cudaGetLastError();
}
