"""Device-side application models: PHOLD, the UDP flood, UDP echo and the
TCP bulk transfer.

The JAX package's ``net/apps.py``:

* PHOLD (the reference's PDES canary, src/test/phold): each received
  message is forwarded to a random peer over the simulated network; the
  message population is hosts × msgload; senders stop once simulated time
  passes ``runtime``. It runs on the matrix path (``handle_msg_matrix``)
  and the loop path (``handle_msg``), with uniform destinations or one of
  two variants: a hot spot (``hot_frac``/``hot_share``) or a ring
  neighbourhood (``local_span``).
* ``UdpFloodApp`` (BASELINE config 2): clients send a datagram to a
  server every interval through the full NIC / router / token-bucket
  path.
* ``UdpEchoApp``: clients send a timestamped datagram to one server,
  which echoes it; clients sum the round trips.
* ``TcpBulkApp`` (BASELINE config 3): each client pushes a fixed stream
  to a server over TCP and closes.
"""

from __future__ import annotations

import numpy as np
import torch

from shadow_tpu_torch import kernels
from shadow_tpu_torch.core import simtime
from shadow_tpu_torch.core.engine import Emitter, EventView, draw_uniform
from shadow_tpu_torch.core.state import (
    KIND_APP_MSG,
    KIND_APP_TIMER,
    NetParams,
    SimState,
    tally,
)
from shadow_tpu_torch.net import link
from shadow_tpu_torch.net import packet as pkt


def locality_targets(num_hosts, anchors, local_span):
    """Static host → anchor table: hosts within ``local_span`` circular
    hops of an anchor target their nearest one (ties to the earlier
    anchor), the rest round-robin; 0 is pure round-robin. [H] int32."""
    anchors = list(anchors)
    tgt = np.array([anchors[i % len(anchors)] for i in range(num_hosts)],
                   dtype=np.int32)
    if local_span <= 0:
        return tgt
    for h in range(num_hosts):
        best, bd = None, None
        for a in anchors:
            d = abs(h - a)
            d = min(d, num_hosts - d)
            if bd is None or d < bd:
                best, bd = a, d
        if bd <= local_span:
            tgt[h] = best
    return tgt


class PholdApp:
    SUB = "phold"
    # PHOLD events carry only a message size: two payload words, packed
    # into one int64 column
    PAYLOAD_WORDS = 2

    def __init__(
        self,
        num_hosts: int,
        msgload: int = 1,
        size_bytes: int = 64,
        start_time: int = simtime.NS_PER_SEC,
        runtime: int = 5 * simtime.NS_PER_SEC,
        hot_frac: float = 0.0,
        hot_share: float = 0.0,
        local_span: int = 0,
    ):
        self.num_hosts = num_hosts
        self.msgload = msgload
        self.size_bytes = size_bytes
        self.start_time = start_time
        self.stop_sending = start_time + runtime
        # the locality-biased variant: forwards target a ring neighbourhood
        # of +-local_span host ids around the sender; 0 = classic PHOLD
        self.local_span = int(local_span)
        if self.local_span < 0 or self.local_span >= num_hosts:
            raise ValueError("phold local_span must be in [0, num_hosts)")
        if self.local_span and (hot_frac > 0 or hot_share > 0):
            raise ValueError(
                "phold local_span and hot_frac/hot_share are exclusive")
        # the skewed variant: hot_share of all messages target the first
        # hot_frac of the hosts (self-sends allowed: they arrive at
        # +latency, inside the bulk contract); 0 = classic PHOLD
        self.hot_frac = float(hot_frac)
        self.hot_share = float(hot_share)
        if (self.hot_frac > 0) != (self.hot_share > 0):
            raise ValueError(
                "phold hot_frac and hot_share must be set together")
        if not (0.0 <= self.hot_share < 1.0) or not (
                0.0 <= self.hot_frac <= 1.0):
            raise ValueError("hot_share must be in [0,1), hot_frac in [0,1]")
        self.hot_n = (max(1, int(num_hosts * self.hot_frac))
                      if self.hot_frac > 0 else 0)
        # pick_dst's keyword arguments
        self.pick = dict(hot_n=self.hot_n, hot_share=self.hot_share,
                         local_span=self.local_span)

    def init_sub(self, device=None) -> dict:
        H = self.num_hosts
        return {
            "received": torch.zeros(H, dtype=torch.int64, device=device),
            "forwarded": torch.zeros(H, dtype=torch.int64, device=device),
        }

    def bulk_kinds(self) -> dict[int, int]:
        """PHOLD's message kind never emits a self event inside the window
        (forwards land at +latency >= the window end), so every window of
        it can take the engine's matrix path."""
        return {KIND_APP_MSG: min(2 * self.msgload, 16)}

    def initial_events(self):
        """msgload seed messages per host, self-delivered at start_time."""
        out = []
        for h in range(self.num_hosts):
            for _ in range(self.msgload):
                out.append(
                    (self.start_time, h, h, KIND_APP_MSG, [self.size_bytes])
                )
        return out

    def handle_msg(self, state: SimState, ev: EventView, emitter: Emitter,
                   params: NetParams) -> SimState:
        """The loop path's per-event forward: one draw picks the
        destination, ``link.send`` rolls the loss with a second."""
        sub = dict(state.subs[self.SUB])
        sub["received"] = sub["received"] + ev.mask.to(torch.int64)
        send = ev.mask & (ev.time < self.stop_sending)
        state, u = draw_uniform(state, send)
        dst = kernels.pick_dst(u, state.host.gid, self.num_hosts,
                               **self.pick)
        sub["forwarded"] = sub["forwarded"] + send.to(torch.int64)
        state = state.with_sub(self.SUB, sub)
        return link.send(state, emitter, send, dst, ev.time, KIND_APP_MSG,
                         ev.payload, params, self.size_bytes)

    def handlers(self):
        return {KIND_APP_MSG: self.handle_msg}

    def handle_msg_matrix(self, state: SimState, dense, params: NetParams,
                          win_end: int,
                          ops: kernels.WindowOps) -> kernels.ForwardOut:
        """Forward every message of the window's dense [H, K] matrix (the
        kernel ``phold_forward``), each at ``dense.time``: the time it
        executes at (the engine's CPU model shifts it where the model is
        on). Updates the draw counters, the app
        sub-state and the packet counters; returns the numbered emission
        rows for the engine. Event k's draws sit at counters
        c0 + 2·(sends before k) and +1, which needs every destination
        reachable (``sim.py`` registers this handler only then)."""
        h = state.host
        fw = ops.phold_forward(
            dense.time, dense.payload, state.rng_keys, h.rng_counter,
            h.seq_next, h.gid, h.vertex, params.latency_vv,
            params.reliability_vv, params.vertex_g,
            num_hosts=self.num_hosts, stop_sending=self.stop_sending,
            bootstrap_end=params.bootstrap_end, win_end=win_end,
            kind=KIND_APP_MSG, **self.pick,
        )
        h.rng_counter = fw.rng_counter
        sub = state.subs[self.SUB]
        state.subs[self.SUB] = {
            "received": sub["received"] + fw.stats[:, 0],
            "forwarded": sub["forwarded"] + fw.stats[:, 1],
        }
        c = state.counters
        # one sum, or one a shard under islands
        sent = tally(fw.stats[:, 1], c.packets_sent)
        c.packets_sent = c.packets_sent + sent
        c.packets_dropped_loss = (c.packets_dropped_loss + sent
                                  - tally(fw.stats[:, 2], c.packets_sent))
        c.bytes_sent = c.bytes_sent + self.size_bytes * sent
        return fw


SERVER_PORT = 9000
CLIENT_PORT_BASE = 40000


class UdpFloodApp:
    """BASELINE config 2: client hosts flood servers with UDP datagrams at
    a fixed rate. Servers bind SERVER_PORT; clients target the servers
    round-robin (locality-biased with ``local_span``)."""

    SUB = "udp_flood"

    def __init__(self, num_hosts: int, server_hosts, interval_ns: int,
                 size_bytes: int = 1024,
                 start_time: int = simtime.NS_PER_SEC,
                 stop_sending: int | None = None, local_span: int = 0):
        self.num_hosts = num_hosts
        self.server_hosts = list(server_hosts)
        self.interval_ns = int(interval_ns)
        self.size_bytes = int(size_bytes)
        self.local_span = int(local_span)
        if self.local_span < 0 or self.local_span >= num_hosts:
            raise ValueError("udp_flood local_span must be in "
                             "[0, num_hosts)")
        if self.size_bytes > pkt.MTU - pkt.UDP_HEADER_BYTES:
            raise ValueError(
                f"datagram size {self.size_bytes} exceeds MTU payload "
                f"{pkt.MTU - pkt.UDP_HEADER_BYTES} (fragmentation "
                f"unsupported)")
        self.start_time = int(start_time)
        self.stop_sending = stop_sending

    def attach(self, stack):
        self.stack = stack
        role = np.ones(self.num_hosts, dtype=np.int32)
        role[self.server_hosts] = 0
        self._role = role
        self._target = locality_targets(self.num_hosts, self.server_hosts,
                                        self.local_span)
        for s in self.server_hosts:
            stack.bind_udp(s, 0, SERVER_PORT)
        for h in range(self.num_hosts):
            if role[h] == 1:
                stack.bind_udp(h, 0, CLIENT_PORT_BASE)

    def init_sub(self, device=None) -> dict:
        H = self.num_hosts
        return {
            "sent": torch.zeros(H, dtype=torch.int64, device=device),
            "recv": torch.zeros(H, dtype=torch.int64, device=device),
            "role": torch.as_tensor(self._role, device=device),
            "target": torch.as_tensor(self._target, device=device),
        }

    def initial_events(self):
        return [(self.start_time, h, h, KIND_APP_TIMER, [])
                for h in range(self.num_hosts) if int(self._role[h]) == 1]

    def on_timer(self, state, ev, emitter, params):
        sub = dict(state.subs[self.SUB])
        send = ev.mask & (sub["role"] == 1)
        if self.stop_sending is not None:
            send = send & (ev.time < self.stop_sending)
        sub["sent"] = sub["sent"] + send.to(torch.int64)
        state = state.with_sub(self.SUB, sub)
        state = self.stack.udp_sendto(
            state, emitter, send, ev.time, sub["target"], SERVER_PORT,
            CLIENT_PORT_BASE, self.size_bytes, 0, params=params)
        emitter.emit(send, ev.time + self.interval_ns, state.host.gid,
                     KIND_APP_TIMER, ev.payload)
        return state

    def on_receive(self, state, mask, slot, src, payload, emitter, now,
                   params):
        sub = dict(state.subs[self.SUB])
        sub["recv"] = sub["recv"] + (mask & (sub["role"] == 0)).to(
            torch.int64)
        return state.with_sub(self.SUB, sub)

    def handlers(self):
        return {KIND_APP_TIMER: self.on_timer}


class UdpEchoApp:
    """Clients send a datagram to the server every interval; the server
    echoes it back; clients accumulate round-trip samples from the send
    time carried in the datagram."""

    SUB = "udp_echo"

    def __init__(self, num_hosts: int, server_host: int, interval_ns: int,
                 size_bytes: int = 512,
                 start_time: int = simtime.NS_PER_SEC,
                 stop_sending: int | None = None):
        self.num_hosts = num_hosts
        self.server_host = int(server_host)
        self.interval_ns = int(interval_ns)
        self.size_bytes = int(size_bytes)
        if self.size_bytes > pkt.MTU - pkt.UDP_HEADER_BYTES:
            raise ValueError(
                f"datagram size {self.size_bytes} exceeds MTU payload "
                f"{pkt.MTU - pkt.UDP_HEADER_BYTES} (fragmentation "
                f"unsupported)")
        self.start_time = int(start_time)
        self.stop_sending = stop_sending

    def attach(self, stack):
        self.stack = stack
        role = np.ones(self.num_hosts, dtype=np.int32)
        role[self.server_host] = 0
        self._role = role
        stack.bind_udp(self.server_host, 0, SERVER_PORT)
        for h in range(self.num_hosts):
            if h != self.server_host:
                stack.bind_udp(h, 0, CLIENT_PORT_BASE)

    def init_sub(self, device=None) -> dict:
        H = self.num_hosts
        z = lambda: torch.zeros(H, dtype=torch.int64,  # noqa: E731
                                device=device)
        return {"sent": z(), "echoed": z(), "rtt_sum": z(),
                "rtt_count": z(),
                "role": torch.as_tensor(self._role, device=device)}

    def initial_events(self):
        return [(self.start_time, h, h, KIND_APP_TIMER, [])
                for h in range(self.num_hosts) if h != self.server_host]

    def on_timer(self, state, ev, emitter, params):
        hosts = state.host.gid
        H = hosts.shape[0]
        dev = hosts.device
        sub = dict(state.subs[self.SUB])
        send = ev.mask & (sub["role"] == 1)
        if self.stop_sending is not None:
            send = send & (ev.time < self.stop_sending)
        sub["sent"] = sub["sent"] + send.to(torch.int64)
        state = state.with_sub(self.SUB, sub)
        full = lambda v: torch.full((H,), v, dtype=torch.int32,  # noqa
                                    device=dev)
        req = pkt.make_udp(
            src_port=full(CLIENT_PORT_BASE), dst_port=full(SERVER_PORT),
            length=full(self.size_bytes), priority=full(0), src_host=hosts,
            socket_slot=full(0), payload_words=self.stack.payload_words)
        req = pkt.pack_time(req, torch.where(send, ev.time, 0))
        state = self.stack.udp_sendto(
            state, emitter, send, ev.time, full(self.server_host),
            SERVER_PORT, CLIENT_PORT_BASE, self.size_bytes, 0, payload=req,
            params=params)
        emitter.emit(send, ev.time + self.interval_ns, hosts,
                     KIND_APP_TIMER, ev.payload)
        return state

    def on_receive(self, state, mask, slot, src, payload, emitter, now,
                   params):
        hosts = state.host.gid
        sub = dict(state.subs[self.SUB])
        server_got = mask & (sub["role"] == 0)
        sub["echoed"] = sub["echoed"] + server_got.to(torch.int64)
        client_got = mask & (sub["role"] == 1)
        rtt = now - pkt.unpack_time(payload)
        sub["rtt_sum"] = sub["rtt_sum"] + torch.where(client_got, rtt, 0)
        sub["rtt_count"] = sub["rtt_count"] + client_got.to(torch.int64)
        state = state.with_sub(self.SUB, sub)
        reply = payload.clone()
        reply[:, pkt.W_SRC_PORT] = SERVER_PORT
        reply[:, pkt.W_DST_PORT] = payload[:, pkt.W_SRC_PORT]
        reply[:, pkt.W_SRC_HOST] = hosts
        return self.stack.udp_sendto(
            state, emitter, server_got, now, src, None, None, None, 0,
            payload=reply, params=params)

    def handlers(self):
        return {KIND_APP_TIMER: self.on_timer}


class TcpBulkApp:
    """BASELINE config 3: each client opens a TCP connection to a server
    and pushes ``total_bytes`` through the congestion-controlled stream,
    then closes. Servers listen on SERVER_PORT (slot 0) and accept into
    child sockets, so a server needs more sockets than clients; clients
    connect from slot 0 at ``start_time``."""

    SUB = "tcp_bulk"

    def __init__(self, num_hosts: int, server_hosts, total_bytes: int,
                 start_time: int = simtime.NS_PER_SEC):
        self.num_hosts = num_hosts
        self.server_hosts = list(server_hosts)
        self.total_bytes = int(total_bytes)
        self.start_time = int(start_time)

    def attach(self, stack):
        self.stack = stack
        role = np.ones(self.num_hosts, dtype=np.int32)
        role[self.server_hosts] = 0
        self._role = role
        self._target = np.array(
            [self.server_hosts[i % len(self.server_hosts)]
             for i in range(self.num_hosts)], dtype=np.int32)
        for s in self.server_hosts:
            stack.tcp_listen(s, 0, SERVER_PORT)
        stack.tcp.on_established(self.on_established)
        stack.tcp.on_peer_fin(self.on_peer_fin)

    def init_sub(self, device=None) -> dict:
        H = self.num_hosts
        z = lambda: torch.zeros(H, dtype=torch.int64,  # noqa: E731
                                device=device)
        return {"connected": z(), "accepted": z(), "eof_seen": z(),
                "role": torch.as_tensor(self._role, device=device),
                "target": torch.as_tensor(self._target, device=device)}

    def initial_events(self):
        return [(self.start_time, h, h, KIND_APP_TIMER, [])
                for h in range(self.num_hosts) if int(self._role[h]) == 1]

    def on_timer(self, state, ev, emitter, params):
        """Client start: active open toward the target server."""
        sub = state.subs[self.SUB]
        go = ev.mask & (sub["role"] == 1)
        return self.stack.tcp.connect(
            state, emitter, go, torch.zeros_like(sub["role"]),
            sub["target"], SERVER_PORT, CLIENT_PORT_BASE, ev.time,
            params=params)

    def on_established(self, state, mask, slot, is_accept, src, now,
                       emitter, params):
        sub = dict(state.subs[self.SUB])
        client_up = mask & ~is_accept & (sub["role"] == 1)
        sub["connected"] = sub["connected"] + client_up.to(torch.int64)
        sub["accepted"] = sub["accepted"] + (
            mask & is_accept & (sub["role"] == 0)).to(torch.int64)
        state = state.with_sub(self.SUB, sub)
        # the whole stream goes into sequence space; the FIN rides after it
        state = self.stack.tcp.send_app(state, emitter, client_up, slot,
                                        self.total_bytes, now)
        return self.stack.tcp.close_app(state, emitter, client_up, slot,
                                        now)

    def on_peer_fin(self, state, mask, slot, now, emitter, params):
        """Server side: the client finished sending; close our half."""
        sub = dict(state.subs[self.SUB])
        srv = mask & (sub["role"] == 0)
        sub["eof_seen"] = sub["eof_seen"] + srv.to(torch.int64)
        state = state.with_sub(self.SUB, sub)
        return self.stack.tcp.close_app(state, emitter, srv, slot, now)

    def handlers(self):
        return {KIND_APP_TIMER: self.on_timer}
