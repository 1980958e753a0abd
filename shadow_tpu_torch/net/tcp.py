"""Vectorized TCP: per-socket state machines stepped for all hosts at once.

The JAX package's ``net/tcp.py``. Every socket of every host lives in one
[H, S] struct-of-arrays table; each handler takes at most one segment or
self-event per host and updates the (host, slot) it names. Sequence
numbers are int32 with two's-complement wraparound; the SACK bitmap is a
uint32 held in an int32 field (here in int64 while it is worked on, masked
to 32 bits). Retransmit timers are lazy: the expiry lives in the table and
a firing timer whose expiry moved re-emits itself.

Four blocks run as kernels (``kernels.py``), each a function of the
selected socket that returns its decisions: ``tcp_demux`` (the socket
match), ``tcp_ack`` (the ACK block of ``on_segment``: RTT, Reno/NewReno,
the SACK scoreboard and the retransmit choice), ``tcp_reorder`` (the
reorder board and the SACK word of the reply) and ``tcp_out`` (the output
pump). The emissions and the app hooks stay here, called in the JAX
package's order, so the records, their sequence numbers and the audit
chain come out the same. The handshake, RST, FIN and TIME_WAIT blocks and
``on_timer`` are PyTorch ops.
"""

from __future__ import annotations

import dataclasses

import torch

from shadow_tpu_torch import kernels
from shadow_tpu_torch.core import simtime, soa
from shadow_tpu_torch.core import state as state_mod
from shadow_tpu_torch.core.state import PAYLOAD_WORDS
from shadow_tpu_torch.kernels import (  # states and flags, JAX's numbers
    FLAG_ACK as ACK,
    TCP_CLOSE_WAIT as CLOSE_WAIT,
    TCP_CLOSED as CLOSED,
    TCP_CLOSING as CLOSING,
    TCP_ESTABLISHED as ESTABLISHED,
    FLAG_FIN as FIN,
    TCP_FIN_WAIT_1 as FIN_WAIT_1,
    TCP_FIN_WAIT_2 as FIN_WAIT_2,
    TCP_LAST_ACK as LAST_ACK,
    TCP_LISTEN as LISTEN,
    FLAG_RST as RST,
    FLAG_SYN as SYN,
    TCP_SYN_RECEIVED as SYN_RECEIVED,
    TCP_SYN_SENT as SYN_SENT,
    TCP_TIME_WAIT as TIME_WAIT,
    RTO_MAX_NS,
    RTO_MIN_NS,
    seq_leq,
    seq_lt,
)
from shadow_tpu_torch.net import packet as pkt

SUB = "tcp"

MSS = pkt.MTU - pkt.TCP_HEADER_BYTES  # 1460
INIT_CWND_SEGS = 10
INIT_SSTHRESH = 1 << 30
RTO_INIT_NS = simtime.NS_PER_SEC
TIME_WAIT_NS = 60 * simtime.NS_PER_SEC
RECV_WND = 1 << 20
OOO_BITS = 32
OOO_CHUNKS = 64

TIMER_RTX = 0
TIMER_TIMEWAIT = 1

# payload words of TCP self-events (output pump / timers)
EV_SLOT = 0
EV_TKIND = 1
EV_GEN = 2

ANY_PEER = -1


@dataclasses.dataclass
class TcpState:
    gid: torch.Tensor  # [H] int32
    used: torch.Tensor  # [H, S] bool
    local_port: torch.Tensor  # [H, S] int32
    peer_host: torch.Tensor  # [H, S] int32 (ANY_PEER for listeners)
    peer_port: torch.Tensor  # [H, S] int32
    state: torch.Tensor  # [H, S] int32
    snd_una: torch.Tensor  # [H, S] int32
    snd_nxt: torch.Tensor
    snd_max: torch.Tensor
    snd_wnd: torch.Tensor
    snd_buf_end: torch.Tensor
    fin_pending: torch.Tensor  # bool
    fin_seq: torch.Tensor
    fin_sent: torch.Tensor  # bool
    rcv_nxt: torch.Tensor
    ooo_map: torch.Tensor  # [H, S, W] bool
    fin_rcvd_seq: torch.Tensor
    fin_rcvd: torch.Tensor  # bool
    cwnd: torch.Tensor
    ssthresh: torch.Tensor
    dup_acks: torch.Tensor
    fast_recovery: torch.Tensor  # bool
    sack_bits: torch.Tensor  # int32 holding a uint32 bitmap
    rtx_high: torch.Tensor
    recover: torch.Tensor
    srtt: torch.Tensor  # int64 ns
    rttvar: torch.Tensor  # int64 ns
    rto: torch.Tensor  # int64 ns
    rtt_armed: torch.Tensor  # bool
    rtt_seq: torch.Tensor
    rtt_start: torch.Tensor  # int64
    rtx_armed: torch.Tensor  # bool
    rtx_expire: torch.Tensor  # int64
    gen: torch.Tensor
    out_pending: torch.Tensor  # bool
    bytes_acked: torch.Tensor  # int64
    bytes_received: torch.Tensor  # int64
    drop_no_socket: torch.Tensor  # [] int64
    drop_ooo: torch.Tensor
    retransmits: torch.Tensor
    timeouts: torch.Tensor
    accept_overflow: torch.Tensor
    rtx_fast: torch.Tensor
    rtx_sack: torch.Tensor
    rtx_walk: torch.Tensor

    def replace(self, **fields) -> "TcpState":
        return state_mod.replace(self, **fields)


def init(num_hosts: int, sockets_per_host: int = 8,
         ooo_chunks: int = OOO_CHUNKS, device=None) -> TcpState:
    H, S = num_hosts, sockets_per_host

    def full(v, dt=torch.int32):
        return torch.full((H, S), v, dtype=dt, device=device)

    def b():
        return torch.zeros((H, S), dtype=torch.bool, device=device)

    def scalar():
        return torch.zeros((), dtype=torch.int64, device=device)

    return TcpState(
        gid=torch.arange(H, dtype=torch.int32, device=device),
        used=b(), local_port=full(0), peer_host=full(ANY_PEER),
        peer_port=full(0), state=full(CLOSED),
        snd_una=full(0), snd_nxt=full(0), snd_max=full(0),
        snd_wnd=full(RECV_WND), snd_buf_end=full(0), fin_pending=b(),
        fin_seq=full(0), fin_sent=b(), rcv_nxt=full(0),
        ooo_map=torch.zeros((H, S, ooo_chunks), dtype=torch.bool,
                            device=device),
        fin_rcvd_seq=full(0), fin_rcvd=b(),
        cwnd=full(INIT_CWND_SEGS * MSS), ssthresh=full(INIT_SSTHRESH),
        dup_acks=full(0), fast_recovery=b(), sack_bits=full(0),
        rtx_high=full(0), recover=full(0),
        srtt=full(0, torch.int64), rttvar=full(0, torch.int64),
        rto=full(RTO_INIT_NS, torch.int64), rtt_armed=b(),
        rtt_seq=full(0), rtt_start=full(0, torch.int64), rtx_armed=b(),
        rtx_expire=full(simtime.NEVER, torch.int64), gen=full(0),
        out_pending=b(),
        bytes_acked=full(0, torch.int64),
        bytes_received=full(0, torch.int64),
        drop_no_socket=scalar(), drop_ooo=scalar(), retransmits=scalar(),
        timeouts=scalar(), accept_overflow=scalar(), rtx_fast=scalar(),
        rtx_sack=scalar(), rtx_walk=scalar(),
    )


def listen_static(tcp: TcpState, host: int, slot: int, port: int) -> None:
    """Build-time passive open, written in place into the build's table."""
    tcp.used[host, slot] = True
    tcp.local_port[host, slot] = port
    tcp.peer_host[host, slot] = ANY_PEER
    tcp.state[host, slot] = LISTEN


# ---------------------------------------------------------------------------
# per-host slot access
# ---------------------------------------------------------------------------


_g = kernels.slot_gather  # arr[h, clip(slot[h], 0, S - 1)]


def _s(arr, mask, slot, val):
    """arr[h, slot[h]] = val[h] where mask[h] (never outside [0, S))."""
    return soa.set_at(arr, mask, slot, val)


# ---------------------------------------------------------------------------
# demux, segment assembly, RTT
# ---------------------------------------------------------------------------


def demux(tcp: TcpState, mask, payload, src_host, ops=kernels.PLAIN_OPS):
    """(slot, found, is_listener), [H] each: an established 4-tuple match
    outranks a listener port match; the lowest slot wins ties."""
    out = ops.tcp_demux(
        tcp.used, tcp.local_port, tcp.peer_host, tcp.peer_port, tcp.state,
        mask, payload[:, pkt.W_DST_PORT].contiguous(),
        payload[:, pkt.W_SRC_PORT].contiguous(),
        src_host.to(torch.int32).contiguous())
    return out.slot, out.found, out.is_listener


def make_segment(src_port, dst_port, length, flags, seq, ack, wnd, src_host,
                 socket_slot, sack=None, payload_words=PAYLOAD_WORDS):
    if payload_words > pkt.W_TRAIL:
        raise NotImplementedError("packet_trails are not ported to "
                                  "shadow_tpu_torch yet (ROADMAP.md queue "
                                  "A 7)")
    H = src_port.shape[0]
    pl = torch.zeros((H, payload_words), dtype=torch.int32,
                     device=src_port.device)
    pl[:, pkt.W_PROTO] = pkt.PROTO_TCP
    pl[:, pkt.W_SRC_PORT] = src_port
    pl[:, pkt.W_DST_PORT] = dst_port
    pl[:, pkt.W_LEN] = length
    pl[:, pkt.W_FLAGS] = flags
    pl[:, pkt.W_SEQ] = seq
    pl[:, pkt.W_ACK] = ack
    pl[:, pkt.W_WND] = wnd
    pl[:, pkt.W_SRC_HOST] = src_host
    pl[:, pkt.W_SOCKET] = socket_slot
    if sack is not None:
        pl[:, pkt.W_SACK] = sack
    return pl


def _rtt_update(tcp: TcpState, mask, slot, now) -> TcpState:
    """Close the in-flight timing sample where the new ack covers
    rtt_seq (RFC 6298; ``//`` floors as JAX's does)."""
    take = mask & _g(tcp.rtt_armed, slot)
    srtt1, rttvar1, rto1 = kernels.rtt_sample(
        (now - _g(tcp.rtt_start, slot)).to(torch.int64), _g(tcp.srtt, slot),
        _g(tcp.rttvar, slot))
    return tcp.replace(srtt=_s(tcp.srtt, take, slot, srtt1),
                       rttvar=_s(tcp.rttvar, take, slot, rttvar1),
                       rto=_s(tcp.rto, take, slot, rto1),
                       rtt_armed=_s(tcp.rtt_armed, take, slot, False))


# ---------------------------------------------------------------------------
# bitmap helpers (uint32 values held in int64; shared with the kernels'
# plain versions)
# ---------------------------------------------------------------------------

_popcount = kernels.popcount
_bit_length = kernels.bit_length
_pack_sack = kernels.pack_sack
_trailing_ones = kernels.trailing_ones


# ---------------------------------------------------------------------------
# The vectorized TCP machine
# ---------------------------------------------------------------------------


def _bit(flags: torch.Tensor, b: int) -> torch.Tensor:
    return ((flags >> b) & 1).to(torch.bool)


def _free(t: TcpState, mask, slot) -> TcpState:
    """Free (host, slot): unused, CLOSED, its generation advanced (which
    invalidates the socket's timer events in flight)."""
    return t.replace(used=_s(t.used, mask, slot, False),
                     state=_s(t.state, mask, slot, CLOSED),
                     gen=soa.add_at(t.gen, mask, slot, 1))


class Tcp:
    """The stack feeds it demuxed segments; it sends segments through
    ``stack._tx`` and schedules its own output-pump and timer events.

    Hooks: established (state, mask, slot, is_accept, src, now, emitter,
    params), receive (state, mask, slot, nbytes, src, now, emitter,
    params), peer_fin / reset / closed (state, mask, slot, now, emitter,
    params); each returns the state."""

    KIND_OUT = 101
    KIND_TIMER = 102

    def __init__(self, num_hosts: int, sockets_per_host: int = 8,
                 payload_words: int = PAYLOAD_WORDS, device=None):
        self.payload_words = payload_words
        self._init = init(num_hosts, sockets_per_host, device=device)
        self.established_hooks = []
        self.receive_hooks = []
        self.peer_fin_hooks = []
        self.reset_hooks = []
        self.closed_hooks = []

    def attach(self, stack):
        self.stack = stack

    # ---- build-time API ----

    def listen(self, host: int, slot: int, port: int):
        listen_static(self._init, host, slot, port)

    def init_sub(self) -> TcpState:
        return self._init

    def on_established(self, hook):
        self.established_hooks.append(hook)

    def on_receive(self, hook):
        self.receive_hooks.append(hook)

    def on_peer_fin(self, hook):
        self.peer_fin_hooks.append(hook)

    def on_reset(self, hook):
        self.reset_hooks.append(hook)

    def on_closed(self, hook):
        self.closed_hooks.append(hook)

    # ---- internal helpers ----

    def _ev_payload(self, slot, tkind=None, gen=None):
        H = slot.shape[0]
        pl = torch.zeros((H, self.payload_words), dtype=torch.int32,
                         device=slot.device)
        pl[:, EV_SLOT] = slot
        if tkind is not None:
            pl[:, EV_TKIND] = tkind
            pl[:, EV_GEN] = gen
        return pl

    def _arm_out(self, t: TcpState, emitter, mask, slot, now) -> TcpState:
        """Schedule the output pump for (host, slot) unless pending."""
        need = mask & ~_g(t.out_pending, slot)
        emitter.emit(need, now, t.gid, self.KIND_OUT, self._ev_payload(slot))
        return t.replace(out_pending=_s(t.out_pending, need, slot, True))

    def _arm_rtx(self, t: TcpState, emitter, mask, slot, now) -> TcpState:
        """Start the lazy retransmit timer where not already running."""
        need = mask & ~_g(t.rtx_armed, slot)
        expire = now + _g(t.rto, slot)
        emitter.emit(need, torch.where(need, expire, 0), t.gid,
                     self.KIND_TIMER,
                     self._ev_payload(slot, TIMER_RTX, _g(t.gen, slot)))
        return t.replace(rtx_armed=_s(t.rtx_armed, need, slot, True),
                         rtx_expire=_s(t.rtx_expire, need, slot, expire))

    def _tx_segment(self, state, emitter, mask, now, dst_host, *, slot,
                    length, flags, seq, ack, dst_port=None, src_port=None,
                    params=None, sack=None):
        """Assemble a segment and hand it to the stack's transmit path."""
        t = state.subs[SUB]
        sp = src_port if src_port is not None else _g(t.local_port, slot)
        dp = dst_port if dst_port is not None else _g(t.peer_port, slot)
        H = t.gid.shape[0]
        dev = t.gid.device

        def col(x):
            return torch.as_tensor(x, dtype=torch.int32,
                                   device=dev).expand(H)

        seg = make_segment(
            src_port=sp, dst_port=dp, length=col(length), flags=col(flags),
            seq=seq, ack=ack, wnd=col(RECV_WND), src_host=t.gid,
            socket_slot=slot, sack=sack, payload_words=self.payload_words)
        state, _ok = self.stack._tx(state, emitter, mask, now, dst_host, seg,
                                    params=params)
        return state

    def _emit_timer(self, emitter, mask, slot, tkind, gen, time, gid):
        emitter.emit(mask, torch.where(mask, time, 0), gid, self.KIND_TIMER,
                     self._ev_payload(slot, tkind, gen))

    @staticmethod
    def _reset_socket(t: TcpState, mask, slot, H: int, dev, *, snd_wnd,
                      rcv_nxt, now, local_port, peer_host, peer_port,
                      state) -> dict:
        """The field writes shared by connect and the passive open: a used
        socket with ISS 0, an RTT sample armed at ``now``, a fresh window
        and board, and its generation advanced."""
        def put(name, val):
            return _s(getattr(t, name), mask, slot, val)

        board = torch.zeros((H, t.ooo_map.shape[2]), dtype=torch.bool,
                            device=dev)
        return dict(
            used=put("used", True), local_port=put("local_port", local_port),
            peer_host=put("peer_host", peer_host),
            peer_port=put("peer_port", peer_port), state=put("state", state),
            snd_una=put("snd_una", 0), snd_nxt=put("snd_nxt", 1),
            snd_max=put("snd_max", 1), snd_wnd=put("snd_wnd", snd_wnd),
            snd_buf_end=put("snd_buf_end", 1),
            fin_pending=put("fin_pending", False),
            fin_sent=put("fin_sent", False), rcv_nxt=put("rcv_nxt", rcv_nxt),
            ooo_map=put("ooo_map", board), fin_rcvd=put("fin_rcvd", False),
            cwnd=put("cwnd", INIT_CWND_SEGS * MSS),
            ssthresh=put("ssthresh", INIT_SSTHRESH),
            dup_acks=put("dup_acks", 0),
            fast_recovery=put("fast_recovery", False),
            sack_bits=put("sack_bits", 0), rtx_high=put("rtx_high", 0),
            srtt=put("srtt", 0), rttvar=put("rttvar", 0),
            rto=put("rto", RTO_INIT_NS), rtt_armed=put("rtt_armed", True),
            rtt_seq=put("rtt_seq", 1), rtt_start=put("rtt_start", now),
            rtx_armed=put("rtx_armed", False),
            gen=soa.add_at(t.gen, mask, slot, 1),
            out_pending=put("out_pending", False),
            bytes_acked=put("bytes_acked", 0),
            bytes_received=put("bytes_received", 0),
        )

    # ---- runtime app API ----

    def connect(self, state, emitter, mask, slot, dst_host, dst_port,
                local_port, now, params=None):
        """Active open: full slot re-init, SYN, retransmit timer (ISS 0)."""
        t = state.subs[SUB]
        H = t.gid.shape[0]
        dev = t.gid.device

        def col(x, dt=torch.int32):
            return torch.as_tensor(x, dtype=dt, device=dev).expand(H)

        slot, dst_host = col(slot), col(dst_host)
        dst_port, local_port = col(dst_port), col(local_port)
        now64 = col(now, torch.int64)
        f = self._reset_socket(
            t, mask, slot, H, dev, snd_wnd=RECV_WND, rcv_nxt=0, now=now64,
            local_port=local_port, peer_host=dst_host, peer_port=dst_port,
            state=SYN_SENT)
        # a reused slot may carry a stale timer: disarm and invalidate
        f["rtx_expire"] = _s(t.rtx_expire, mask, slot, simtime.NEVER)
        t = t.replace(**f)
        state = state.with_sub(SUB, t)
        z32 = torch.zeros(H, dtype=torch.int32, device=dev)
        state = self._tx_segment(
            state, emitter, mask, now64, dst_host, slot=slot, length=0,
            flags=SYN, seq=z32, ack=z32, dst_port=dst_port,
            src_port=local_port, params=params)
        t = self._arm_rtx(state.subs[SUB], emitter, mask, slot, now64)
        return state.with_sub(SUB, t)

    @staticmethod
    def _can_write(t: TcpState, mask, slot):
        st = _g(t.state, slot)
        return (mask & _g(t.used, slot)
                & ((st == ESTABLISHED) | (st == CLOSE_WAIT)
                   | (st == SYN_SENT) | (st == SYN_RECEIVED))
                & ~_g(t.fin_pending, slot))

    def send_app(self, state, emitter, mask, slot, nbytes, now):
        """The app writes nbytes into the stream (sequence space only)."""
        t = state.subs[SUB]
        ok = self._can_write(t, mask, slot)
        nb = torch.as_tensor(nbytes, dtype=torch.int32,
                             device=ok.device).expand(ok.shape[0])
        t = t.replace(snd_buf_end=_s(t.snd_buf_end, ok, slot,
                                     _g(t.snd_buf_end, slot) + nb))
        t = self._arm_out(t, emitter, ok, slot, now)
        return state.with_sub(SUB, t)

    def close_app(self, state, emitter, mask, slot, now):
        """App close: the FIN goes out after all buffered data."""
        t = state.subs[SUB]
        ok = self._can_write(t, mask, slot)
        t = t.replace(fin_pending=_s(t.fin_pending, ok, slot, True))
        t = self._arm_out(t, emitter, ok, slot, now)
        return state.with_sub(SUB, t)

    # ---- segment processing ----

    def on_segment(self, state, mask, src, payload, emitter, now, params):
        """Process one incoming segment per host."""
        ops = emitter.ops
        t = state.subs[SUB]
        H = t.gid.shape[0]
        S = t.used.shape[1]
        dev = t.gid.device
        def word(w):
            return payload[:, w].contiguous()

        fl = word(pkt.W_FLAGS)
        has_syn = (fl & SYN) != 0
        has_ack = (fl & ACK) != 0
        has_fin = (fl & FIN) != 0
        has_rst = (fl & RST) != 0
        seg_seq, seg_ack = word(pkt.W_SEQ), word(pkt.W_ACK)
        seg_wnd, seg_len = word(pkt.W_WND), word(pkt.W_LEN)
        sport, dport = word(pkt.W_SRC_PORT), word(pkt.W_DST_PORT)
        src = src.to(torch.int32).contiguous()
        now64 = torch.as_tensor(now, dtype=torch.int64,
                                device=dev).expand(H).contiguous()
        z32 = torch.zeros(H, dtype=torch.int32, device=dev)
        fb = torch.zeros(H, dtype=torch.bool, device=dev)
        tb = torch.ones(H, dtype=torch.bool, device=dev)

        slot, found, is_listener = demux(t, mask, payload, src, ops)
        t = t.replace(drop_no_socket=t.drop_no_socket + (mask & ~found).sum())

        # ---------- RST for segments matching no socket ----------
        no_sock = mask & ~found & ~has_rst
        rst_seq = torch.where(has_ack, seg_ack, z32)
        rst_ack = (seg_seq + seg_len + has_syn.to(torch.int32)
                   + has_fin.to(torch.int32))
        state = state.with_sub(SUB, t)
        state = self._tx_segment(
            state, emitter, no_sock, now64, src, slot=torch.zeros_like(slot),
            length=0, flags=RST | ACK, seq=rst_seq, ack=rst_ack,
            dst_port=sport, src_port=dport, params=params)
        t = state.subs[SUB]

        # ---------- passive open: SYN to a listener → child socket ---------
        m_syn = found & is_listener & has_syn & ~has_ack
        free = ~t.used
        has_free = free.any(dim=1)
        child = free.to(torch.int8).argmax(dim=1).to(torch.int32)
        mc = m_syn & has_free
        t = t.replace(accept_overflow=t.accept_overflow
                      + (m_syn & ~has_free).sum())
        t = t.replace(**self._reset_socket(
            t, mc, child, H, dev, snd_wnd=seg_wnd, rcv_nxt=seg_seq + 1,
            now=now64, local_port=dport, peer_host=src, peer_port=sport,
            state=SYN_RECEIVED))
        state = state.with_sub(SUB, t)
        state = self._tx_segment(
            state, emitter, mc, now64, src, slot=child, length=0,
            flags=SYN | ACK, seq=z32, ack=seg_seq + 1, dst_port=sport,
            src_port=dport, params=params)
        t = self._arm_rtx(state.subs[SUB], emitter, mc, child, now64)

        # ---------- active open completes: SYN+ACK in SYN_SENT ----------
        st = _g(t.state, slot)
        m_conn = found & ~is_listener
        m_ss = (m_conn & (st == SYN_SENT) & has_syn & has_ack
                & (seg_ack == _g(t.snd_nxt, slot)))
        t = t.replace(state=_s(t.state, m_ss, slot, ESTABLISHED),
                      rcv_nxt=_s(t.rcv_nxt, m_ss, slot, seg_seq + 1),
                      snd_una=_s(t.snd_una, m_ss, slot, seg_ack),
                      snd_wnd=_s(t.snd_wnd, m_ss, slot, seg_wnd))
        t = _rtt_update(t, m_ss & seq_leq(_g(t.rtt_seq, slot), seg_ack),
                        slot, now64)
        state = state.with_sub(SUB, t)
        state = self._tx_segment(
            state, emitter, m_ss, now64, src, slot=slot, length=0, flags=ACK,
            seq=_g(t.snd_nxt, slot), ack=_g(t.rcv_nxt, slot), params=params)
        for hook in self.established_hooks:
            state = hook(state, m_ss, slot, fb, src, now64, emitter, params)
        t = state.subs[SUB]
        # the app may have queued data inside the hook: pump if so
        want_out = m_ss & (
            seq_lt(_g(t.snd_nxt, slot), _g(t.snd_buf_end, slot))
            | (_g(t.fin_pending, slot) & ~_g(t.fin_sent, slot)))
        t = self._arm_out(t, emitter, want_out, slot, now64)

        # ---------- connection-state processing ----------
        st = _g(t.state, slot)
        m_proc = m_conn & ~m_ss & (st >= SYN_RECEIVED)
        # RST tears the connection down; in SYN_SENT it is a refusal
        m_rst = (m_proc | (m_conn & ~m_ss & (st == SYN_SENT))) & has_rst
        t = _free(t, m_rst, slot)
        state = state.with_sub(SUB, t)
        for hook in self.reset_hooks:
            state = hook(state, m_rst, slot, now64, emitter, params)
        t = state.subs[SUB]
        m_proc = m_proc & ~m_rst
        # a retransmitted SYN to a SYN_RECEIVED child: re-send SYN+ACK
        resyn = m_proc & has_syn & ~has_ack & (st == SYN_RECEIVED)

        # ---------- ACK processing (kernel tcp_ack) ----------
        ak = ops.tcp_ack(
            m_proc, slot, fl, seg_ack, seg_len, seg_wnd,
            word(pkt.W_SACK), st, now64,
            *(getattr(t, f) for f in kernels.ACK_IN), mss=MSS)
        t = t.replace(**dict(zip(kernels.ACK_OUT, ak.fields)))
        af = ak.flags
        data_rtx = _bit(af, kernels.ACK_DATA_RTX)
        fin_rtx = _bit(af, kernels.ACK_FIN_RTX)
        newreno = _bit(af, kernels.ACK_TRIGGER_FR) | _bit(
            af, kernels.ACK_PARTIAL)
        sack_rtx = _bit(af, kernels.ACK_SACK_RTX)
        t = t.replace(
            retransmits=t.retransmits + (data_rtx | fin_rtx).sum(),
            rtx_fast=t.rtx_fast + ((data_rtx | fin_rtx) & newreno).sum(),
            rtx_sack=t.rtx_sack + (data_rtx & sack_rtx & ~newreno).sum(),
        )
        state = state.with_sub(SUB, t)
        rn = _g(t.rcv_nxt, slot)
        state = self._tx_segment(
            state, emitter, data_rtx, now64, src, slot=slot,
            length=ak.rtx_len, flags=ACK, seq=ak.rtx_seq, ack=rn,
            params=params)
        state = self._tx_segment(
            state, emitter, fin_rtx, now64, src, slot=slot, length=0,
            flags=FIN | ACK, seq=ak.fin_seq, ack=rn, params=params)

        # accept-side established hooks (after accounting, so hooks can send)
        m_sr_est = _bit(af, kernels.ACK_SR_EST)
        for hook in self.established_hooks:
            state = hook(state, m_sr_est, slot, tb, src, now64, emitter,
                         params)
        t = state.subs[SUB]
        # the window may have opened: pump
        can_more = (
            (_bit(af, kernels.ACK_NEW_ACKED) | _bit(af, kernels.ACK_INFLATE))
            & (seq_lt(_g(t.snd_nxt, slot), _g(t.snd_buf_end, slot))
               | (_g(t.fin_pending, slot) & ~_g(t.fin_sent, slot))))
        t = self._arm_out(t, emitter, can_more, slot, now64)

        # ---------- data receive (kernel tcp_reorder) ----------
        st2 = _g(t.state, slot)
        rk = ops.tcp_reorder(m_proc, slot, seg_seq, seg_len, t.state,
                             t.rcv_nxt, t.ooo_map, t.bytes_received,
                             mss=MSS)
        rf = rk.flags
        in_order = _bit(rf, kernels.RO_IN_ORDER)
        t = t.replace(
            rcv_nxt=rk.rcv_nxt, ooo_map=rk.ooo_map,
            bytes_received=rk.bytes_received,
            drop_ooo=t.drop_ooo + _bit(rf, kernels.RO_DROP).sum())

        # ---------- peer FIN ----------
        estab2 = ((st2 == ESTABLISHED) | (st2 == FIN_WAIT_1)
                  | (st2 == FIN_WAIT_2))
        m_fin = m_proc & has_fin & estab2
        t = t.replace(fin_rcvd=_s(t.fin_rcvd, m_fin, slot, True),
                      fin_rcvd_seq=_s(t.fin_rcvd_seq, m_fin, slot,
                                          seg_seq + seg_len))
        # consume the FIN once all data before it has arrived
        frs = _g(t.fin_rcvd_seq, slot)
        rn_now = _g(t.rcv_nxt, slot)
        st3 = _g(t.state, slot)
        consume = (m_proc & _g(t.fin_rcvd, slot) & (rn_now == frs)
                   & ((st3 == ESTABLISHED) | (st3 == FIN_WAIT_1)
                      | (st3 == FIN_WAIT_2)))
        t = t.replace(
            rcv_nxt=_s(t.rcv_nxt, consume, slot, rn_now + 1),
            state=_s(t.state, consume, slot, torch.where(
                st3 == ESTABLISHED, CLOSE_WAIT,
                torch.where(st3 == FIN_WAIT_1, CLOSING, TIME_WAIT))),
            fin_rcvd=_s(t.fin_rcvd, consume, slot, False))
        m_tw_enter = (_bit(af, kernels.ACK_TW_ENTER)
                      | (consume & (st3 == FIN_WAIT_2)))
        m_free = _bit(af, kernels.ACK_FREE)

        # ---------- TIME_WAIT timer + socket free ----------
        self._emit_timer(emitter, m_tw_enter, slot, TIMER_TIMEWAIT,
                         _g(t.gen, slot), now64 + TIME_WAIT_NS, t.gid)
        t = _free(t, m_free, slot)
        state = state.with_sub(SUB, t)
        for hook in self.closed_hooks:
            state = hook(state, m_free, slot, now64, emitter, params)
        t = state.subs[SUB]

        # ---------- ACK reply ----------
        # reply to anything that consumed sequence space or was a
        # (re)transmitted SYN, never to a pure ACK; a SYN+ACK seen in
        # ESTABLISHED means our handshake ACK was lost: re-ACK it
        resynack = m_proc & has_syn & has_ack & (st == ESTABLISHED)
        need_ack = (m_proc & ((seg_len > 0) | has_fin)) | resyn | resynack
        reply_flags = torch.where(resyn, SYN | ACK, ACK).to(torch.int32)
        reply_seq = torch.where(resyn, z32, _g(t.snd_nxt, slot))
        # the board (which no hook since tcp_reorder has touched) rides
        # pure ACKs as a bounded SACK bitmap relative to rcv_nxt
        state = self._tx_segment(
            state, emitter, need_ack, now64, src, slot=slot, length=0,
            flags=reply_flags, seq=reply_seq, ack=_g(t.rcv_nxt, slot),
            sack=torch.where(resyn | resynack, z32, rk.sack), params=params)

        # ---------- app hooks ----------
        for hook in self.receive_hooks:
            state = hook(state, in_order, slot, rk.adv, src, now64, emitter,
                         params)
        for hook in self.peer_fin_hooks:
            state = hook(state, consume, slot, now64, emitter, params)
        return state

    # ---- output pump (kernel tcp_out) ----

    def on_out(self, state, ev, emitter, params):
        """Send at most one segment per (host, slot) per micro-step; re-arm
        while the window and the stream allow more."""
        t = state.subs[SUB]
        slot = ev.payload[:, EV_SLOT].contiguous()
        now64 = ev.time.to(torch.int64)
        ok = emitter.ops.tcp_out(ev.mask, slot, now64,
                                 *(getattr(t, f) for f in kernels.OUT_IN),
                                 mss=MSS)
        t = t.replace(**dict(zip(kernels.OUT_OUT, ok.fields)))
        f = ok.flags
        send_data = _bit(f, kernels.OUT_SEND_DATA)
        send_fin = _bit(f, kernels.OUT_SEND_FIN)
        is_rtx = _bit(f, kernels.OUT_RTX)
        t = t.replace(retransmits=t.retransmits + is_rtx.sum(),
                      rtx_walk=t.rtx_walk + is_rtx.sum())
        state = state.with_sub(SUB, t)
        state = self._tx_segment(
            state, emitter, send_data, now64, ok.dst, slot=slot,
            length=ok.seg_len, flags=ACK, seq=ok.seq, ack=ok.ack,
            params=params)
        state = self._tx_segment(
            state, emitter, send_fin, now64, ok.dst, slot=slot, length=0,
            flags=FIN | ACK, seq=ok.seq, ack=ok.ack, params=params)
        t = state.subs[SUB]
        t = self._arm_rtx(t, emitter, send_data | send_fin, slot, now64)
        t = self._arm_out(t, emitter, _bit(f, kernels.OUT_MORE), slot, now64)
        return state.with_sub(SUB, t)

    # ---- timers (lazy retransmit + TIME_WAIT) ----

    def on_timer(self, state, ev, emitter, params):
        t = state.subs[SUB]
        H = t.gid.shape[0]
        S = t.used.shape[1]
        slot = ev.payload[:, EV_SLOT]
        tkind = ev.payload[:, EV_TKIND]
        egen = ev.payload[:, EV_GEN]
        now64 = ev.time.to(torch.int64)
        z32 = torch.zeros(H, dtype=torch.int32, device=slot.device)
        m = ev.mask & (_g(t.gen, slot) == egen) & _g(t.used, slot)

        # TIME_WAIT expiry frees the slot
        m_tw = m & (tkind == TIMER_TIMEWAIT) & (_g(t.state, slot) == TIME_WAIT)
        t = _free(t, m_tw, slot)
        state = state.with_sub(SUB, t)
        for hook in self.closed_hooks:
            state = hook(state, m_tw, slot, now64, emitter, params)
        t = state.subs[SUB]

        # retransmit timer
        m_rtx = m & (tkind == TIMER_RTX)
        una = _g(t.snd_una, slot)
        nxt = _g(t.snd_nxt, slot)
        outstanding = seq_lt(una, nxt)
        # all acked: quietly disarm
        t = t.replace(rtx_armed=_s(t.rtx_armed, m_rtx & ~outstanding, slot,
                                   False))
        # the deadline was pushed back by ACKs: re-check at the new one
        exp = _g(t.rtx_expire, slot)
        pushed = m_rtx & outstanding & (now64 < exp)
        self._emit_timer(emitter, pushed, slot, TIMER_RTX, egen, exp, t.gid)

        # expired: timeout (Reno timeout hooks + RFC 6298 backoff)
        fire = m_rtx & outstanding & (now64 >= exp)
        flight = (nxt - una).to(torch.int32)
        rto2 = (_g(t.rto, slot) * 2).clamp(max=RTO_MAX_NS)
        st = _g(t.state, slot)
        # an unacked FIN goes out again through the pump after the data
        fin_rewind = fire & _g(t.fin_sent, slot) & seq_leq(
            una, _g(t.fin_seq, slot))
        hs = (st == SYN_SENT) | (st == SYN_RECEIVED)
        t = t.replace(
            ssthresh=_s(t.ssthresh, fire, slot, torch.clamp(flight // 2,
                                                    min=2 * MSS)),
            cwnd=_s(t.cwnd, fire, slot, MSS),
            dup_acks=_s(t.dup_acks, fire, slot, 0),
            fast_recovery=_s(t.fast_recovery, fire, slot, False),
            rtt_armed=_s(t.rtt_armed, fire, slot, False),
            rto=_s(t.rto, fire, slot, rto2),
            rtx_expire=_s(t.rtx_expire, fire, slot, now64 + rto2),
            snd_nxt=_s(t.snd_nxt, fire & ~hs, slot, una),
            # sack_bits survive the RTO: the pump skips sacked chunks
            rtx_high=_s(t.rtx_high, fire, slot, 0),
            fin_sent=_s(t.fin_sent, fin_rewind, slot, False),
            timeouts=t.timeouts + fire.sum(),
            retransmits=t.retransmits + fire.sum(),
        )
        self._emit_timer(emitter, fire, slot, TIMER_RTX, egen, now64 + rto2,
                         t.gid)

        # handshake retransmits go out directly; data goes via the pump
        state = state.with_sub(SUB, t)
        dst = _g(t.peer_host, slot)
        state = self._tx_segment(
            state, emitter, fire & (st == SYN_SENT), now64, dst, slot=slot,
            length=0, flags=SYN, seq=z32, ack=z32, params=params)
        state = self._tx_segment(
            state, emitter, fire & (st == SYN_RECEIVED), now64, dst,
            slot=slot, length=0, flags=SYN | ACK, seq=z32,
            ack=_g(state.subs[SUB].rcv_nxt, slot), params=params)
        t = self._arm_out(state.subs[SUB], emitter, fire & ~hs, slot, now64)
        return state.with_sub(SUB, t)

    def handlers(self) -> dict:
        return {self.KIND_OUT: self.on_out, self.KIND_TIMER: self.on_timer}
