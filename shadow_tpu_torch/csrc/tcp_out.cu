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
// Inputs (host arrays of device pointers, in tcp_out's order in
// kernels.py): per host mask, slot, now; then the [H, S] fields OUT_IN.
// Outputs: the [H, S] fields OUT_OUT (new arrays, written at each masked
// host's slot) and per host the decision bits (OUT_* in kernels.py), the
// segment's length, seq, ack and destination host. The emitter sends the
// segments in the JAX package's order.
//
// Bound: bytes (each host's rows of 9 fields copied out, 18 read). One
// thread a host.

#include "tcp_common.cuh"

namespace {

using namespace tcp;

struct Args {
  const bool* mask;
  const int* slot;
  const long long* now;
  // OUT_IN
  const bool *out_pending, *used;
  const int *state, *snd_una, *snd_nxt, *snd_max, *snd_buf_end, *cwnd,
      *snd_wnd, *sack_bits;
  const bool *fin_pending, *fin_sent;
  const int *rcv_nxt, *peer_host;
  const bool* rtt_armed;
  const int* rtt_seq;
  const long long* rtt_start;
  const int* fin_seq;
  // OUT_OUT
  bool* o_out_pending;
  int *o_snd_nxt, *o_snd_max, *o_fin_seq;
  bool* o_fin_sent;
  int* o_state;
  bool* o_rtt_armed;
  int* o_rtt_seq;
  long long* o_rtt_start;
  // per host
  int *o_flags, *o_seg_len, *o_seq, *o_ack, *o_dst;
  int H, S, mss;
};

__global__ void __launch_bounds__(kThreads) tcp_out_kernel(Args a) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= a.H) return;
  const int S = a.S, mss = a.mss;
  const long long r = (long long)h * S;
  copy_row(a.o_out_pending, a.out_pending, r, S);
  copy_row(a.o_snd_nxt, a.snd_nxt, r, S);
  copy_row(a.o_snd_max, a.snd_max, r, S);
  copy_row(a.o_fin_seq, a.fin_seq, r, S);
  copy_row(a.o_fin_sent, a.fin_sent, r, S);
  copy_row(a.o_state, a.state, r, S);
  copy_row(a.o_rtt_armed, a.rtt_armed, r, S);
  copy_row(a.o_rtt_seq, a.rtt_seq, r, S);
  copy_row(a.o_rtt_start, a.rtt_start, r, S);

  const int sl = a.slot[h];
  const long long i = r + clip_slot(sl, S);
  const bool in_range = sl >= 0 && sl < S;
  const long long j = r + sl;
  if (a.mask[h] && in_range) a.o_out_pending[j] = false;
  const bool m = a.mask[h] && a.used[i];
  const int st = a.state[i];
  const bool can_send = st == kEstablished || st == kCloseWait ||
                        st == kFinWait1 || st == kClosing || st == kLastAck;
  const int una = a.snd_una[i], nxt = a.snd_nxt[i], smax = a.snd_max[i];
  const int buf = a.snd_buf_end[i];
  const int wnd = min(a.cwnd[i], a.snd_wnd[i]);
  const int avail = wsub(wadd(una, wnd), nxt);
  const bool have_data = seq_lt(nxt, buf);
  const int left = min(wsub(buf, nxt), mss);
  const int seg_len = min(left, avail);
  bool send_data = m && can_send && have_data && seg_len > 0;
  const int ch = floordiv(wsub(nxt, una), mss);
  const unsigned sb = (unsigned)a.sack_bits[i];
  const bool sacked = ch >= 0 && ch < 32 && ((sb >> ch) & 1u);
  const bool skip = send_data && seq_lt(nxt, smax) && sacked;
  send_data = send_data && !skip;
  const bool fin_p = a.fin_pending[i], fin_s = a.fin_sent[i];
  const bool send_fin = m && can_send && !have_data && fin_p && !fin_s;
  const bool sent_any = send_data || send_fin;
  const bool advanced = sent_any || skip;
  const int nxt1 = send_data ? wadd(nxt, seg_len)
                             : (skip ? wadd(nxt, left)
                                     : (send_fin ? wadd(nxt, 1) : nxt));
  const bool is_rtx = sent_any && seq_lt(nxt, smax);
  const int smax1 = seq_lt(smax, nxt1) ? nxt1 : smax;
  const bool arm_rtt = send_data && !a.rtt_armed[i] && !is_rtx;
  const int avail1 = wsub(wadd(una, wnd), nxt1);
  const bool more =
      m && can_send && advanced &&
      ((seq_lt(nxt1, buf) && avail1 > 0) ||
       (fin_p && !(fin_s || send_fin) && !seq_lt(nxt1, buf)));

  if (in_range) {
    if (advanced) a.o_snd_nxt[j] = nxt1;
    if (sent_any) a.o_snd_max[j] = smax1;
    if (send_fin) {
      a.o_fin_seq[j] = nxt;
      a.o_fin_sent[j] = true;
      a.o_state[j] = st == kEstablished
                         ? kFinWait1
                         : (st == kCloseWait ? kLastAck : st);
    }
    if (arm_rtt) {
      a.o_rtt_armed[j] = true;
      a.o_rtt_seq[j] = nxt1;
      a.o_rtt_start[j] = a.now[h];
    }
  }
  a.o_flags[h] = (int)send_data | (int)send_fin << 1 | (int)skip << 2 |
                 (int)is_rtx << 3 | (int)more << 4;
  a.o_seg_len[h] = max(seg_len, 0);
  a.o_seq[h] = nxt;
  a.o_ack[h] = a.rcv_nxt[i];
  a.o_dst[h] = a.peer_host[i];
}

}  // namespace

extern "C" int tcp_out(const void* const* in, void* const* out, int H, int S,
                       int mss, void* stream) {
  Args a;
  int k = 0;
  a.mask = (const bool*)in[k++];
  a.slot = (const int*)in[k++];
  a.now = (const long long*)in[k++];
  a.out_pending = (const bool*)in[k++];
  a.used = (const bool*)in[k++];
  a.state = (const int*)in[k++];
  a.snd_una = (const int*)in[k++];
  a.snd_nxt = (const int*)in[k++];
  a.snd_max = (const int*)in[k++];
  a.snd_buf_end = (const int*)in[k++];
  a.cwnd = (const int*)in[k++];
  a.snd_wnd = (const int*)in[k++];
  a.sack_bits = (const int*)in[k++];
  a.fin_pending = (const bool*)in[k++];
  a.fin_sent = (const bool*)in[k++];
  a.rcv_nxt = (const int*)in[k++];
  a.peer_host = (const int*)in[k++];
  a.rtt_armed = (const bool*)in[k++];
  a.rtt_seq = (const int*)in[k++];
  a.rtt_start = (const long long*)in[k++];
  a.fin_seq = (const int*)in[k++];
  k = 0;
  a.o_out_pending = (bool*)out[k++];
  a.o_snd_nxt = (int*)out[k++];
  a.o_snd_max = (int*)out[k++];
  a.o_fin_seq = (int*)out[k++];
  a.o_fin_sent = (bool*)out[k++];
  a.o_state = (int*)out[k++];
  a.o_rtt_armed = (bool*)out[k++];
  a.o_rtt_seq = (int*)out[k++];
  a.o_rtt_start = (long long*)out[k++];
  a.o_flags = (int*)out[k++];
  a.o_seg_len = (int*)out[k++];
  a.o_seq = (int*)out[k++];
  a.o_ack = (int*)out[k++];
  a.o_dst = (int*)out[k++];
  a.H = H;
  a.S = S;
  a.mss = mss;
  if (H > 0)
    tcp_out_kernel<<<blocks(H), kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
