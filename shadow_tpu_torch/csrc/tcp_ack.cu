// K9 tcp_ack: the ACK block of one incoming segment per host.
//
// Replaces the ACK processing of shadow_tpu/net/tcp.py:Tcp.on_segment
// (lines 779-969, up to its two _tx_segment calls) with _rtt_update and
// _push_back_rtx: SYN_RECEIVED → ESTABLISHED on the ack of our SYN;
// duplicate-ACK counting and Reno / NewReno (fast recovery entry at the
// third duplicate, window inflation, full and partial acks); the
// bytes_acked tally without SYN / FIN phantom bytes; the snd_nxt >= snd_una
// drag; the RTT sample (RFC 6298, floor division) and the retransmit
// deadline push-back; the FIN-acked state moves; the sender SACK scoreboard
// (a pure ACK's bitmap, or the old board shifted by the chunks acked); and
// the choice of a fast, partial or SACK retransmission of the first
// unsacked chunk at or after rtx_high (trailing ones, bit length) or of the
// FIN.
//
// Inputs (host arrays of device pointers, in tcp_ack's order in
// kernels.py): per host mask, slot, flags, seg_ack, seg_len, seg_wnd,
// seg_sack, st (the slot's state before the block), now; then the [H, S]
// fields ACK_IN. Outputs: the [H, S] fields ACK_OUT, new arrays equal to
// the inputs but at each masked host's slot, and per host the decision
// bits (ACK_* in kernels.py), the retransmission's seq and length and the
// slot's fin_seq. A masked-off host's values are read from its clipped
// slot, as JAX reads them, and nothing of it is written.
//
// Bound: bytes (each host's S-wide rows of 17 fields copied out, 24 read).
// One thread a host; the block's arithmetic is a few hundred integer
// operations a host, far below the bytes. Sequence arithmetic is uint32;
// the SACK bitmap is a uint32, shifted logically.

#include "tcp_common.cuh"

namespace {

using namespace tcp;

struct Args {
  // per host
  const bool* mask;
  const int *slot, *flags, *seg_ack, *seg_len, *seg_wnd, *seg_sack, *st;
  const long long* now;
  // ACK_IN
  const int *state, *snd_una, *snd_nxt, *snd_max, *snd_wnd, *snd_buf_end,
      *fin_seq;
  const bool* fin_sent;
  const int *cwnd, *ssthresh, *dup_acks;
  const bool* fast_recovery;
  const int *recover, *sack_bits, *rtx_high;
  const long long *srtt, *rttvar, *rto;
  const bool* rtt_armed;
  const int* rtt_seq;
  const long long* rtt_start;
  const bool* rtx_armed;
  const long long *rtx_expire, *bytes_acked;
  // ACK_OUT
  int *o_state, *o_snd_una, *o_snd_nxt, *o_snd_wnd, *o_cwnd, *o_ssthresh,
      *o_dup_acks;
  bool* o_fast_recovery;
  int *o_recover, *o_sack_bits, *o_rtx_high;
  long long *o_srtt, *o_rttvar, *o_rto;
  bool* o_rtt_armed;
  long long *o_rtx_expire, *o_bytes_acked;
  // per host
  int *o_flags, *o_rtx_seq, *o_rtx_len, *o_fin_seq;
  int H, S, mss;
};

__global__ void __launch_bounds__(kThreads) tcp_ack_kernel(Args a) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= a.H) return;
  const int S = a.S, mss = a.mss;
  const long long r = (long long)h * S;
  copy_row(a.o_state, a.state, r, S);
  copy_row(a.o_snd_una, a.snd_una, r, S);
  copy_row(a.o_snd_nxt, a.snd_nxt, r, S);
  copy_row(a.o_snd_wnd, a.snd_wnd, r, S);
  copy_row(a.o_cwnd, a.cwnd, r, S);
  copy_row(a.o_ssthresh, a.ssthresh, r, S);
  copy_row(a.o_dup_acks, a.dup_acks, r, S);
  copy_row(a.o_fast_recovery, a.fast_recovery, r, S);
  copy_row(a.o_recover, a.recover, r, S);
  copy_row(a.o_sack_bits, a.sack_bits, r, S);
  copy_row(a.o_rtx_high, a.rtx_high, r, S);
  copy_row(a.o_srtt, a.srtt, r, S);
  copy_row(a.o_rttvar, a.rttvar, r, S);
  copy_row(a.o_rto, a.rto, r, S);
  copy_row(a.o_rtt_armed, a.rtt_armed, r, S);
  copy_row(a.o_rtx_expire, a.rtx_expire, r, S);
  copy_row(a.o_bytes_acked, a.bytes_acked, r, S);

  const int sl = a.slot[h];
  const long long i = r + clip_slot(sl, S);
  const bool m = a.mask[h];
  const int fl = a.flags[h];
  const bool has_syn = fl & kSyn, has_fin = fl & kFin, has_ack = fl & kAck;
  const int seg_ack = a.seg_ack[h], seg_len = a.seg_len[h];
  const long long now = a.now[h];
  const int una = a.snd_una[i], nxt = a.snd_nxt[i], smax = a.snd_max[i];

  const bool m_ack = m && has_ack;
  const bool acceptable =
      m_ack && seq_leq(una, seg_ack) && seq_leq(seg_ack, smax);
  const bool new_acked = acceptable && seq_lt(una, seg_ack);
  const bool sr_est = new_acked && a.st[h] == kSynReceived;
  const int st_now = sr_est ? kEstablished : a.state[i];

  // duplicate ACKs and Reno / NewReno, before una moves
  const bool is_dup = m_ack && seg_ack == una && seg_len == 0 && !has_syn &&
                      !has_fin && seq_lt(una, nxt);
  const bool fr = a.fast_recovery[i];
  const int dups0 = a.dup_acks[i];
  const int dups1 = (is_dup && !fr) ? wadd(dups0, 1) : dups0;
  const bool trigger = is_dup && !fr && dups1 == 3;
  const int flight = wsub(nxt, una);
  const int ssth_loss = max(floordiv(flight, 2), 2 * mss);
  const bool inflate = is_dup && fr;
  const int cwnd0 = a.cwnd[i], ssth0 = a.ssthresh[i];
  const int cwnd1 = trigger ? wadd(ssth_loss, 3 * mss)
                            : (inflate ? wadd(cwnd0, mss) : cwnd0);
  const int ssth1 = trigger ? ssth_loss : ssth0;
  const bool fr1 = fr || trigger;
  const int rec1 = trigger ? smax : a.recover[i];
  const bool full_ack = new_acked && fr1 && seq_leq(rec1, seg_ack);
  const bool partial = new_acked && fr1 && !full_ack;
  const int cwnd2 = full_ack ? ssth1 : cwnd1;
  const bool fr2 = fr1 && !full_ack;
  const int dups2 = new_acked ? 0 : dups1;
  const bool grow = new_acked && !fr1;
  const int acked = wsub(seg_ack, una);
  int cwnd3 = cwnd2;
  if (grow && cwnd2 < ssth1)
    cwnd3 = wadd(cwnd2, min(acked, mss));
  else if (grow)
    cwnd3 = wadd(cwnd2, max(1, floordiv(mss * mss, max(cwnd2, 1))));

  // bytes_acked without the SYN / FIN phantom bytes; the snd_nxt drag
  const int fin_seq = a.fin_seq[i];
  const bool fin_sent = a.fin_sent[i];
  const bool syn_ph = new_acked && una == 0;
  const bool fin_acked = new_acked && fin_sent && seq_leq(una, fin_seq) &&
                         seq_lt(fin_seq, seg_ack);
  const int app_bytes = wsub(wsub(acked, (int)syn_ph), (int)fin_acked);
  const int nxt1 = (new_acked && seq_lt(nxt, seg_ack)) ? seg_ack : nxt;
  const int una2 = new_acked ? seg_ack : una;

  // _rtt_update, then _push_back_rtx with the new rto
  bool armed = a.rtt_armed[i];
  long long srtt = a.srtt[i], rttvar = a.rttvar[i], rto = a.rto[i];
  if (new_acked && armed && seq_leq(a.rtt_seq[i], seg_ack)) {
    const long long rr = now - a.rtt_start[i];
    const long long s0 = srtt, v0 = rttvar;
    if (s0 == 0) {
      srtt = rr;
      rttvar = floordiv(rr, 2LL);
    } else {
      srtt = s0 + floordiv(rr - s0, 8LL);
      const long long dev = s0 - rr < 0 ? rr - s0 : s0 - rr;
      rttvar = v0 + floordiv(dev - v0, 4LL);
    }
    const long long r4 = srtt + 4 * rttvar;
    rto = r4 < kRtoMin ? kRtoMin : (r4 > kRtoMax ? kRtoMax : r4);
    armed = false;
  }
  const long long expire =
      (new_acked && a.rtx_armed[i]) ? now + rto : a.rtx_expire[i];

  // our FIN acked
  int st_n = st_now;
  if (fin_acked) {
    if (st_now == kFinWait1) st_n = kFinWait2;
    else if (st_now == kClosing) st_n = kTimeWait;
    else if (st_now == kLastAck) st_n = kClosed;
  }
  const bool tw_enter = fin_acked && st_now == kClosing;
  const bool m_free = fin_acked && st_now == kLastAck;

  // sender SACK scoreboard
  const bool pure = m_ack && seg_len == 0 && !has_syn && !has_fin;
  const unsigned sb0 = (unsigned)a.sack_bits[i];
  const int nch = floordiv(acked, mss);
  const int ach = nch < 0 ? 0 : (nch > 31 ? 31 : nch);
  const unsigned sb_shift = new_acked ? (nch >= 32 ? 0u : sb0 >> ach) : sb0;
  const unsigned sb1 = (pure && acceptable) ? (unsigned)a.seg_sack[h]
                                            : sb_shift;

  // fast / partial / SACK retransmission
  const int rtx_high0 = a.rtx_high[i];
  const int rtx_high_eff = trigger ? una2 : rtx_high0;
  int done_ch = floordiv(wsub(rtx_high_eff, una2), mss);
  done_ch = done_ch < 0 ? 0 : (done_ch > 32 ? 32 : done_ch);
  const unsigned done_mask =
      done_ch >= 32 ? 0xFFFFFFFFu : ((1u << done_ch) - 1u);
  const unsigned holes = ~(sb1 | done_mask);
  const int fh = holes == 0u ? 32 : __ffs(holes) - 1;  // trailing ones
  const int blen = sb1 == 0u ? 0 : 32 - __clz(sb1);
  const bool newreno = trigger || partial;
  const bool hole_visible = sb1 != 0u && fh < blen && fh < 32;
  const bool sack_rtx = inflate && hole_visible;
  const bool do_rtx = (newreno && (hole_visible || fh == 0)) || sack_rtx;
  const int f_eff = hole_visible ? min(fh, 31) : 0;
  const int rtx_seq = wadd(una2, f_eff * mss);
  const int buf = a.snd_buf_end[i];
  const int rtx_len = min(wsub(buf, rtx_seq), mss);
  const bool data_rtx = do_rtx && rtx_len > 0;
  const bool fin_rtx = newreno && min(wsub(buf, una2), mss) <= 0 && fin_sent;
  armed = armed && !do_rtx;  // Karn

  if (m && sl >= 0 && sl < S) {
    const long long j = r + sl;
    a.o_state[j] = st_n;
    a.o_snd_una[j] = una2;
    a.o_snd_nxt[j] = nxt1;
    a.o_snd_wnd[j] = acceptable ? a.seg_wnd[h] : a.snd_wnd[i];
    a.o_cwnd[j] = cwnd3;
    a.o_ssthresh[j] = ssth1;
    a.o_dup_acks[j] = dups2;
    a.o_fast_recovery[j] = fr2;
    a.o_recover[j] = rec1;
    a.o_sack_bits[j] = (int)sb1;
    a.o_rtx_high[j] = data_rtx ? wadd(rtx_seq, rtx_len) : rtx_high_eff;
    a.o_srtt[j] = srtt;
    a.o_rttvar[j] = rttvar;
    a.o_rto[j] = rto;
    a.o_rtt_armed[j] = armed;
    a.o_rtx_expire[j] = expire;
    a.o_bytes_acked[j] =
        a.bytes_acked[i] + (new_acked ? (long long)app_bytes : 0LL);
  }
  a.o_flags[h] = (int)sr_est | (int)new_acked << 1 | (int)inflate << 2 |
                 (int)data_rtx << 3 | (int)fin_rtx << 4 | (int)tw_enter << 5 |
                 (int)m_free << 6 | (int)is_dup << 7 | (int)trigger << 8 |
                 (int)partial << 9 | (int)sack_rtx << 10;
  a.o_rtx_seq[h] = rtx_seq;
  a.o_rtx_len[h] = rtx_len;
  a.o_fin_seq[h] = fin_seq;
}

}  // namespace

extern "C" int tcp_ack(const void* const* in, void* const* out, int H, int S,
                       int mss, void* stream) {
  Args a;
  int k = 0;
  a.mask = (const bool*)in[k++];
  a.slot = (const int*)in[k++];
  a.flags = (const int*)in[k++];
  a.seg_ack = (const int*)in[k++];
  a.seg_len = (const int*)in[k++];
  a.seg_wnd = (const int*)in[k++];
  a.seg_sack = (const int*)in[k++];
  a.st = (const int*)in[k++];
  a.now = (const long long*)in[k++];
  a.state = (const int*)in[k++];
  a.snd_una = (const int*)in[k++];
  a.snd_nxt = (const int*)in[k++];
  a.snd_max = (const int*)in[k++];
  a.snd_wnd = (const int*)in[k++];
  a.snd_buf_end = (const int*)in[k++];
  a.fin_seq = (const int*)in[k++];
  a.fin_sent = (const bool*)in[k++];
  a.cwnd = (const int*)in[k++];
  a.ssthresh = (const int*)in[k++];
  a.dup_acks = (const int*)in[k++];
  a.fast_recovery = (const bool*)in[k++];
  a.recover = (const int*)in[k++];
  a.sack_bits = (const int*)in[k++];
  a.rtx_high = (const int*)in[k++];
  a.srtt = (const long long*)in[k++];
  a.rttvar = (const long long*)in[k++];
  a.rto = (const long long*)in[k++];
  a.rtt_armed = (const bool*)in[k++];
  a.rtt_seq = (const int*)in[k++];
  a.rtt_start = (const long long*)in[k++];
  a.rtx_armed = (const bool*)in[k++];
  a.rtx_expire = (const long long*)in[k++];
  a.bytes_acked = (const long long*)in[k++];
  k = 0;
  a.o_state = (int*)out[k++];
  a.o_snd_una = (int*)out[k++];
  a.o_snd_nxt = (int*)out[k++];
  a.o_snd_wnd = (int*)out[k++];
  a.o_cwnd = (int*)out[k++];
  a.o_ssthresh = (int*)out[k++];
  a.o_dup_acks = (int*)out[k++];
  a.o_fast_recovery = (bool*)out[k++];
  a.o_recover = (int*)out[k++];
  a.o_sack_bits = (int*)out[k++];
  a.o_rtx_high = (int*)out[k++];
  a.o_srtt = (long long*)out[k++];
  a.o_rttvar = (long long*)out[k++];
  a.o_rto = (long long*)out[k++];
  a.o_rtt_armed = (bool*)out[k++];
  a.o_rtx_expire = (long long*)out[k++];
  a.o_bytes_acked = (long long*)out[k++];
  a.o_flags = (int*)out[k++];
  a.o_rtx_seq = (int*)out[k++];
  a.o_rtx_len = (int*)out[k++];
  a.o_fin_seq = (int*)out[k++];
  a.H = H;
  a.S = S;
  a.mss = mss;
  if (H > 0)
    tcp_ack_kernel<<<blocks(H), kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
