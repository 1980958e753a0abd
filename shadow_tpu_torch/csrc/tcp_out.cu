// K11 tcp_out: the TCP output pump of one self-event per host.
//
// Replaces shadow_tpu/net/tcp.py:Tcp.on_out (lines 1132-1236) without its
// emissions: clear out_pending at the event's slot; on a used socket in a
// sending state (ESTABLISHED, CLOSE_WAIT, FIN_WAIT_1, CLOSING, LAST_ACK)
// send one data segment of min(MSS, data left, usable window), skip a
// chunk the peer SACKed while re-walking the flight (snd_nxt < snd_max),
// or send the FIN once the data is out; advance snd_nxt and snd_max, move
// the state on the FIN, arm an RTT sample on fresh data, and decide
// whether the pump re-arms (more data in the window, or the FIN).
//
// Inputs (a host array of device pointers, in tcp_out's order in
// kernels.py): per host mask, slot, now; then the [H, S] fields OUT_IN.
// In place: the fields of OUT_OUT (a subset of OUT_IN) are updated in the
// tensors given, at each masked host's slot and nowhere else, each only
// where the block changes it. Per host the kernel writes fresh decision
// bits (OUT_* in kernels.py), the segment's length, seq, ack and
// destination host. A masked-off host's values are read from its clipped
// slot and nothing of it is written. The emitter sends the segments in
// the JAX package's order.
//
// Bound: bytes, each host's inputs and its slot's cells read once, and
// the masked hosts' written cells. One thread a host loads its inputs and
// the 14 cells the block reads (out_pending, fin_seq, rtt_seq and
// rtt_start are only written) into registers, all in flight together,
// works the block out and only then stores: nothing is read after a
// store, so reading and writing through one pointer is safe. Blocks of
// kBlock threads spread config 3's 10,240 hosts over the card's SMs.

#include "tcp_common.cuh"

namespace {

using namespace tcp;

constexpr int kBlock = 128;

struct Args {
  const bool* mask;
  const int* slot;
  const long long* now;
  // OUT_IN, read at the slot; those of OUT_OUT written there in place
  bool* out_pending;
  const bool* used;
  int* state;
  const int* snd_una;
  int *snd_nxt, *snd_max;
  const int *snd_buf_end, *cwnd, *snd_wnd, *sack_bits;
  const bool* fin_pending;
  bool* fin_sent;
  const int *rcv_nxt, *peer_host;
  bool* rtt_armed;
  int* rtt_seq;
  long long* rtt_start;
  int* fin_seq;
  // per host
  int *o_flags, *o_seg_len, *o_seq, *o_ack, *o_dst;
  int H, S, mss;
};

__global__ void __launch_bounds__(kBlock) tcp_out_kernel(Args a) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= a.H) return;
  const int S = a.S, mss = a.mss;

  // every load first: the host's inputs, then its slot's cells
  const int sl = a.slot[h];
  const bool mask = a.mask[h];
  const long long now = a.now[h];
  const long long i = (long long)h * S + clip_slot(sl, S);
  const bool used = a.used[i];
  const int st = a.state[i];
  const int una = a.snd_una[i], nxt = a.snd_nxt[i], smax = a.snd_max[i];
  const int buf = a.snd_buf_end[i];
  const int cwnd = a.cwnd[i], snd_wnd = a.snd_wnd[i];
  const unsigned sb = (unsigned)a.sack_bits[i];
  const bool fin_p = a.fin_pending[i], fin_s = a.fin_sent[i];
  const int rcv_nxt = a.rcv_nxt[i], peer = a.peer_host[i];
  const bool rtt_armed = a.rtt_armed[i];

  const bool m = mask && used;
  const bool can_send = st == kEstablished || st == kCloseWait ||
                        st == kFinWait1 || st == kClosing || st == kLastAck;
  const int wnd = min(cwnd, snd_wnd);
  const int avail = wsub(wadd(una, wnd), nxt);
  const bool have_data = seq_lt(nxt, buf);
  const int left = min(wsub(buf, nxt), mss);
  const int seg_len = min(left, avail);
  bool send_data = m && can_send && have_data && seg_len > 0;
  const int ch = floordiv(wsub(nxt, una), mss);
  const bool sacked = ch >= 0 && ch < 32 && ((sb >> ch) & 1u);
  const bool skip = send_data && seq_lt(nxt, smax) && sacked;
  send_data = send_data && !skip;
  const bool send_fin = m && can_send && !have_data && fin_p && !fin_s;
  const bool sent_any = send_data || send_fin;
  const bool advanced = sent_any || skip;
  const int nxt1 = send_data ? wadd(nxt, seg_len)
                             : (skip ? wadd(nxt, left)
                                     : (send_fin ? wadd(nxt, 1) : nxt));
  const bool is_rtx = sent_any && seq_lt(nxt, smax);
  const int smax1 = seq_lt(smax, nxt1) ? nxt1 : smax;
  const bool arm_rtt = send_data && !rtt_armed && !is_rtx;
  const int avail1 = wsub(wadd(una, wnd), nxt1);
  const bool more =
      m && can_send && advanced &&
      ((seq_lt(nxt1, buf) && avail1 > 0) ||
       (fin_p && !(fin_s || send_fin) && !seq_lt(nxt1, buf)));

  // the stores, after every load (each condition implies the mask)
  if (sl >= 0 && sl < S) {
    if (mask) a.out_pending[i] = false;
    if (advanced) a.snd_nxt[i] = nxt1;
    if (sent_any) a.snd_max[i] = smax1;
    if (send_fin) {
      a.fin_seq[i] = nxt;
      a.fin_sent[i] = true;
      a.state[i] = st == kEstablished ? kFinWait1
                                      : (st == kCloseWait ? kLastAck : st);
    }
    if (arm_rtt) {
      a.rtt_armed[i] = true;
      a.rtt_seq[i] = nxt1;
      a.rtt_start[i] = now;
    }
  }
  a.o_flags[h] = (int)send_data | (int)send_fin << 1 | (int)skip << 2 |
                 (int)is_rtx << 3 | (int)more << 4;
  a.o_seg_len[h] = max(seg_len, 0);
  a.o_seq[h] = nxt;
  a.o_ack[h] = rcv_nxt;
  a.o_dst[h] = peer;
}

}  // namespace

// ``in``: the 3 per-host inputs, then the 18 OUT_IN fields (those of
// OUT_OUT updated in place); ``out``: the 5 per-host outputs.
extern "C" int tcp_out(void* const* in, void* const* out, int H, int S,
                       int mss, void* stream) {
  Args a;
  int k = 0;
  a.mask = (const bool*)in[k++];
  a.slot = (const int*)in[k++];
  a.now = (const long long*)in[k++];
  a.out_pending = (bool*)in[k++];
  a.used = (const bool*)in[k++];
  a.state = (int*)in[k++];
  a.snd_una = (const int*)in[k++];
  a.snd_nxt = (int*)in[k++];
  a.snd_max = (int*)in[k++];
  a.snd_buf_end = (const int*)in[k++];
  a.cwnd = (const int*)in[k++];
  a.snd_wnd = (const int*)in[k++];
  a.sack_bits = (const int*)in[k++];
  a.fin_pending = (const bool*)in[k++];
  a.fin_sent = (bool*)in[k++];
  a.rcv_nxt = (const int*)in[k++];
  a.peer_host = (const int*)in[k++];
  a.rtt_armed = (bool*)in[k++];
  a.rtt_seq = (int*)in[k++];
  a.rtt_start = (long long*)in[k++];
  a.fin_seq = (int*)in[k++];
  k = 0;
  a.o_flags = (int*)out[k++];
  a.o_seg_len = (int*)out[k++];
  a.o_seq = (int*)out[k++];
  a.o_ack = (int*)out[k++];
  a.o_dst = (int*)out[k++];
  a.H = H;
  a.S = S;
  a.mss = mss;
  if (H > 0)
    tcp_out_kernel<<<blocks(H, kBlock), kBlock, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
