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
// Inputs (a host array of device pointers, in tcp_ack's order in
// kernels.py): per host mask, slot, flags, seg_ack, seg_len, seg_wnd,
// seg_sack, st (the slot's state before the block), now; then the [H, S]
// fields ACK_IN. In place: the fields of ACK_OUT (a subset of ACK_IN) are
// updated in the tensors given, at each masked host's slot and nowhere
// else. Per host the kernel writes fresh decision bits (ACK_* in
// kernels.py), the retransmission's seq and length and the slot's fin_seq.
// A masked-off host's values are read from its clipped slot, as JAX reads
// them, and nothing of it is written.
//
// Bound: bytes, each host's inputs and its slot's cell of the 24 fields
// read once, and the masked hosts' 17 written cells. One thread a host
// loads all of these into registers first (the slot, then every cell, each
// load independent of the others, so they are in flight together), works
// the block out there (a few hundred integer operations, far below the
// bytes), and only then stores the slot's cells: nothing is read after a
// store, so reading and writing through one pointer is safe, and the
// latency is two rounds of loads. Blocks of kBlock threads spread
// config 3's 10,240 hosts over the card's SMs. Sequence arithmetic is
// uint32; the SACK bitmap is a uint32, shifted logically.

#include "tcp_common.cuh"

namespace {

using namespace tcp;

constexpr int kBlock = 128;

struct Args {
  // per host
  const bool* mask;
  const int *slot, *flags, *seg_ack, *seg_len, *seg_wnd, *seg_sack, *st;
  const long long* now;
  // ACK_IN, read at the slot; those of ACK_OUT written there in place
  int *state, *snd_una, *snd_nxt;
  const int* snd_max;
  int* snd_wnd;
  const int *snd_buf_end, *fin_seq;
  const bool* fin_sent;
  int *cwnd, *ssthresh, *dup_acks;
  bool* fast_recovery;
  int *recover, *sack_bits, *rtx_high;
  long long *srtt, *rttvar, *rto;
  bool* rtt_armed;
  const int* rtt_seq;
  const long long* rtt_start;
  const bool* rtx_armed;
  long long *rtx_expire, *bytes_acked;
  // per host
  int *o_flags, *o_rtx_seq, *o_rtx_len, *o_fin_seq;
  int H, S, mss;
};

__global__ void __launch_bounds__(kBlock) tcp_ack_kernel(Args a) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= a.H) return;
  const int S = a.S, mss = a.mss;

  // every load first: the host's inputs, then its slot's cells
  const int sl = a.slot[h];
  const bool m = a.mask[h];
  const int fl = a.flags[h];
  const int seg_ack = a.seg_ack[h], seg_len = a.seg_len[h];
  const int seg_wnd = a.seg_wnd[h], seg_sack = a.seg_sack[h];
  const int st_h = a.st[h];
  const long long now = a.now[h];
  const long long i = (long long)h * S + clip_slot(sl, S);
  const int state0 = a.state[i];
  const int una = a.snd_una[i], nxt = a.snd_nxt[i], smax = a.snd_max[i];
  const int wnd0 = a.snd_wnd[i], buf = a.snd_buf_end[i];
  const int fin_seq = a.fin_seq[i];
  const bool fin_sent = a.fin_sent[i];
  const int cwnd0 = a.cwnd[i], ssth0 = a.ssthresh[i], dups0 = a.dup_acks[i];
  const bool fr = a.fast_recovery[i];
  const int rec0 = a.recover[i];
  const unsigned sb0 = (unsigned)a.sack_bits[i];
  const int rtx_high0 = a.rtx_high[i];
  const long long srtt0 = a.srtt[i], rttvar0 = a.rttvar[i], rto0 = a.rto[i];
  const bool armed0 = a.rtt_armed[i];
  const int rtt_seq = a.rtt_seq[i];
  const long long rtt_start = a.rtt_start[i];
  const bool rtx_armed = a.rtx_armed[i];
  const long long expire0 = a.rtx_expire[i];
  const long long bytes_acked0 = a.bytes_acked[i];

  const bool has_syn = fl & kSyn, has_fin = fl & kFin, has_ack = fl & kAck;
  const bool m_ack = m && has_ack;
  const bool acceptable =
      m_ack && seq_leq(una, seg_ack) && seq_leq(seg_ack, smax);
  const bool new_acked = acceptable && seq_lt(una, seg_ack);
  const bool sr_est = new_acked && st_h == kSynReceived;
  const int st_now = sr_est ? kEstablished : state0;

  // duplicate ACKs and Reno / NewReno, before una moves
  const bool is_dup = m_ack && seg_ack == una && seg_len == 0 && !has_syn &&
                      !has_fin && seq_lt(una, nxt);
  const int dups1 = (is_dup && !fr) ? wadd(dups0, 1) : dups0;
  const bool trigger = is_dup && !fr && dups1 == 3;
  const int flight = wsub(nxt, una);
  const int ssth_loss = max(floordiv(flight, 2), 2 * mss);
  const bool inflate = is_dup && fr;
  const int cwnd1 = trigger ? wadd(ssth_loss, 3 * mss)
                            : (inflate ? wadd(cwnd0, mss) : cwnd0);
  const int ssth1 = trigger ? ssth_loss : ssth0;
  const bool fr1 = fr || trigger;
  const int rec1 = trigger ? smax : rec0;
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
  const bool syn_ph = new_acked && una == 0;
  const bool fin_acked = new_acked && fin_sent && seq_leq(una, fin_seq) &&
                         seq_lt(fin_seq, seg_ack);
  const int app_bytes = wsub(wsub(acked, (int)syn_ph), (int)fin_acked);
  const int nxt1 = (new_acked && seq_lt(nxt, seg_ack)) ? seg_ack : nxt;
  const int una2 = new_acked ? seg_ack : una;

  // _rtt_update, then _push_back_rtx with the new rto
  bool armed = armed0;
  long long srtt = srtt0, rttvar = rttvar0, rto = rto0;
  if (new_acked && armed && seq_leq(rtt_seq, seg_ack)) {
    const long long rr = now - rtt_start;
    if (srtt0 == 0) {
      srtt = rr;
      rttvar = floordiv(rr, 2LL);
    } else {
      srtt = srtt0 + floordiv(rr - srtt0, 8LL);
      const long long dev = srtt0 - rr < 0 ? rr - srtt0 : srtt0 - rr;
      rttvar = rttvar0 + floordiv(dev - rttvar0, 4LL);
    }
    const long long r4 = srtt + 4 * rttvar;
    rto = r4 < kRtoMin ? kRtoMin : (r4 > kRtoMax ? kRtoMax : r4);
    armed = false;
  }
  const long long expire = (new_acked && rtx_armed) ? now + rto : expire0;

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
  const int nch = floordiv(acked, mss);
  const int ach = nch < 0 ? 0 : (nch > 31 ? 31 : nch);
  const unsigned sb_shift = new_acked ? (nch >= 32 ? 0u : sb0 >> ach) : sb0;
  const unsigned sb1 = (pure && acceptable) ? (unsigned)seg_sack : sb_shift;

  // fast / partial / SACK retransmission
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
  const int rtx_len = min(wsub(buf, rtx_seq), mss);
  const bool data_rtx = do_rtx && rtx_len > 0;
  const bool fin_rtx = newreno && min(wsub(buf, una2), mss) <= 0 && fin_sent;
  armed = armed && !do_rtx;  // Karn

  // the stores, after every load: the slot's cells, then the host's
  if (m && sl >= 0 && sl < S) {
    a.state[i] = st_n;
    a.snd_una[i] = una2;
    a.snd_nxt[i] = nxt1;
    a.snd_wnd[i] = acceptable ? seg_wnd : wnd0;
    a.cwnd[i] = cwnd3;
    a.ssthresh[i] = ssth1;
    a.dup_acks[i] = dups2;
    a.fast_recovery[i] = fr2;
    a.recover[i] = rec1;
    a.sack_bits[i] = (int)sb1;
    a.rtx_high[i] = data_rtx ? wadd(rtx_seq, rtx_len) : rtx_high_eff;
    a.srtt[i] = srtt;
    a.rttvar[i] = rttvar;
    a.rto[i] = rto;
    a.rtt_armed[i] = armed;
    a.rtx_expire[i] = expire;
    a.bytes_acked[i] = bytes_acked0 + (new_acked ? (long long)app_bytes : 0LL);
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

// ``in``: the 9 per-host inputs, then the 24 ACK_IN fields (those of
// ACK_OUT updated in place); ``out``: the 4 per-host outputs.
extern "C" int tcp_ack(void* const* in, void* const* out, int H, int S,
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
  a.state = (int*)in[k++];
  a.snd_una = (int*)in[k++];
  a.snd_nxt = (int*)in[k++];
  a.snd_max = (const int*)in[k++];
  a.snd_wnd = (int*)in[k++];
  a.snd_buf_end = (const int*)in[k++];
  a.fin_seq = (const int*)in[k++];
  a.fin_sent = (const bool*)in[k++];
  a.cwnd = (int*)in[k++];
  a.ssthresh = (int*)in[k++];
  a.dup_acks = (int*)in[k++];
  a.fast_recovery = (bool*)in[k++];
  a.recover = (int*)in[k++];
  a.sack_bits = (int*)in[k++];
  a.rtx_high = (int*)in[k++];
  a.srtt = (long long*)in[k++];
  a.rttvar = (long long*)in[k++];
  a.rto = (long long*)in[k++];
  a.rtt_armed = (bool*)in[k++];
  a.rtt_seq = (const int*)in[k++];
  a.rtt_start = (const long long*)in[k++];
  a.rtx_armed = (const bool*)in[k++];
  a.rtx_expire = (long long*)in[k++];
  a.bytes_acked = (long long*)in[k++];
  k = 0;
  a.o_flags = (int*)out[k++];
  a.o_rtx_seq = (int*)out[k++];
  a.o_rtx_len = (int*)out[k++];
  a.o_fin_seq = (int*)out[k++];
  a.H = H;
  a.S = S;
  a.mss = mss;
  if (H > 0)
    tcp_ack_kernel<<<blocks(H, kBlock), kBlock, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
