"""NetStack: NIC + router (CoDel) + UDP + TCP composed into engine
handlers.

The JAX package's ``net/stack.py``:

  send:    app → udp_sendto → NIC send ring → send pump (tokens, qdisc)
           → link transit (loss roll + latency) → KIND_PKT_DELIVER event
  receive: KIND_PKT_DELIVER → router CoDel enqueue → receive pump
           (rx tokens) → CoDel dequeue → port demux → socket counters
           → app receive hooks → TCP segment processing (``net/tcp.py``)

An uncontended packet (empty queue, tokens in the bucket) goes straight
through in the same micro-step on both sides; loopback traffic bypasses
the router and the buckets. Handlers update the state functionally and
never write into a tensor.
"""

from __future__ import annotations

from typing import Callable

import torch

from shadow_tpu_torch import kernels
from shadow_tpu_torch.core.engine import Emitter, EventView
from shadow_tpu_torch.core.state import (
    KIND_NIC_REFILL,
    KIND_PKT_DELIVER,
    NetParams,
    SimState,
)
from shadow_tpu_torch.net import codel, link, nic, udp
from shadow_tpu_torch.net import tcp as tcp_mod
from shadow_tpu_torch.net import packet as pkt
from shadow_tpu_torch.net import pds as pds_mod
from shadow_tpu_torch.net import qdisc as qdisc_mod

KIND_NIC_SEND = 100
KIND_NIC_RECV = KIND_NIC_REFILL

# hook(state, mask, slot, src_host, payload, emitter, now, params) -> state
RecvHook = Callable


class NetStack:
    # packets drained per pump invocation (the JAX package's PUMP_BATCH)
    PUMP_BATCH = 1

    def __init__(
        self,
        num_hosts: int,
        bw_up_bits,
        bw_down_bits,
        sockets_per_host: int = 8,
        router_queue_slots: int = 64,
        nic_queue_slots: int = 64,
        with_tcp: bool = False,
        qdisc: str = "fifo",
        router_variant: str = "codel",
        payload_words: int = 12,
        discipline: qdisc_mod.Discipline | None = None,
        device=None,
    ):
        if discipline is None:
            discipline = qdisc_mod.make_discipline(qdisc)
        self.disc = discipline
        self.payload_words = payload_words
        if router_variant not in ("codel", "static", "single"):
            raise ValueError(f"unknown router variant {router_variant!r}")
        self.qdisc = discipline.name
        self.router_aqm = router_variant == "codel"
        if router_variant == "single":
            router_queue_slots = 1
        self.sockets_per_host = sockets_per_host
        self.num_hosts = num_hosts
        self.device = device
        self.disc.attach(self)
        self._init_nic = nic.init(bw_up_bits, bw_down_bits, nic_queue_slots,
                                  payload_words=payload_words, device=device)
        self._init_router = codel.init(num_hosts, router_queue_slots,
                                       payload_words=payload_words,
                                       device=device)
        self._init_udp = udp.init(num_hosts, sockets_per_host,
                                  device=device)
        # UDP-only simulations carry no TCP table and run no TCP handler
        self.tcp = (tcp_mod.Tcp(num_hosts, sockets_per_host,
                                payload_words=payload_words, device=device)
                    if with_tcp else None)
        if self.tcp is not None:
            self.tcp.attach(self)
        self.recv_hooks: list[RecvHook] = []
        self.recv_batch = self.PUMP_BATCH
        # consecutive KIND_PKT_DELIVER events one host may consume per
        # micro-step when bulk_gate proves them direct-deliverable; TCP
        # builds take one (the segment handler arms sub-window timers,
        # which the gate cannot bound)
        self.deliver_batch = 1 if with_tcp else 8

    # ---- build-time API ----

    def bind_udp(self, host: int, slot: int, port: int,
                 peer_host: int = udp.ANY_PEER, peer_port: int = 0):
        udp.bind_static(self._init_udp, host, slot, port, peer_host,
                        peer_port)

    def tcp_listen(self, host: int, slot: int, port: int):
        if self.tcp is None:
            raise ValueError("stack built with with_tcp=False")
        self.tcp.listen(host, slot, port)

    def on_receive(self, hook: RecvHook):
        self.recv_hooks.append(hook)

    def init_subs(self) -> dict:
        subs = {
            nic.SUB: self._init_nic,
            codel.SUB: self._init_router,
            udp.SUB: self._init_udp,
        }
        if self.tcp is not None:
            subs[tcp_mod.SUB] = self.tcp.init_sub()
        subs.update(self.disc.init_subs())
        return subs

    # ---- generic transmit path ----

    def _tx(self, state: SimState, emitter: Emitter, mask, now, dst_host,
            payload, params: NetParams | None = None):
        """Transmit an assembled packet: straight onto the wire when the
        send queue is empty and the bucket holds tokens (needs
        ``params``), else into the queue with the send pump armed.
        Returns (state, admitted)."""
        hosts = state.host.gid
        H = hosts.shape[0]
        n = state.subs[nic.SUB]
        now64 = torch.as_tensor(now, dtype=torch.int64,
                                device=hosts.device).expand(H)
        direct = torch.zeros(H, dtype=torch.bool, device=hosts.device)
        if params is not None:
            # the refill, admission, charge, tx counters, the remote
            # packets' roll and link.send's counters in one launch (the
            # kernel nic_tx)
            h = state.host
            dst32 = dst_host.to(torch.int32)
            o = emitter.ops.nic_tx(
                mask, now64, dst32, self.disc.nonempty(state), hosts,
                n.tx_rem, n.tx_tick, n.tx_refill, n.tx_cap, n.tx_packets,
                n.tx_bytes, payload, h.vertex, params.vertex_g,
                params.latency_vv, params.reliability_vv, state.rng_keys,
                h.rng_counter, [getattr(state.counters, c)
                                for c in kernels.TX_COUNTERS],
                bootstrap_end=params.bootstrap_end)
            direct = o.direct
            n = n.replace(tx_rem=o.tx_rem, tx_tick=o.tx_tick,
                          tx_packets=o.tx_packets, tx_bytes=o.tx_bytes)
            state = self.disc.note_direct(state.with_sub(nic.SUB, n), direct,
                                          payload)
            wire = pkt.stamp(payload, direct, pkt.PDS_SENT)
            state = link.finish(state, emitter, o, dst32, now64,
                                KIND_PKT_DELIVER, wire)
            state = state.with_counters(
                **dict(zip(kernels.TX_COUNTERS, o.counters.unbind())))
            emitter.emit(o.loopback, now64, hosts, KIND_PKT_DELIVER, wire)

        enq = mask & ~direct
        state, ok = self.disc.enqueue(
            state, enq, dst_host.to(torch.int32),
            pkt.stamp(payload, enq, pkt.PDS_NIC_QUEUED), now64, emitter.ops)
        state = pds_mod.record_drop(state, enq & ~ok, payload,
                                    pkt.PDS_DROPPED_SENDQ, now64)
        n = state.subs[nic.SUB]
        need = ok & ~n.send_pending
        emitter.emit(need, now64, hosts, KIND_NIC_SEND,
                     torch.zeros_like(payload))
        n = n.replace(send_pending=n.send_pending | need)
        return state.with_sub(nic.SUB, n), ok | direct

    # ---- runtime API (called from app handlers) ----

    def udp_sendto(self, state: SimState, emitter: Emitter, mask, now,
                   dst_host, dst_port, src_port, size_bytes, socket_slot,
                   payload=None, params: NetParams | None = None):
        """Queue a datagram on the sender's NIC. Apps may pass a prebuilt
        [H, P] payload; the port and size arguments are then unused."""
        hosts = state.host.gid
        H = hosts.shape[0]
        dev = hosts.device

        def col(x):
            return torch.as_tensor(x, dtype=torch.int32, device=dev).expand(H)

        if payload is None:
            payload = pkt.make_udp(
                src_port=col(src_port), dst_port=col(dst_port),
                length=col(size_bytes),
                priority=torch.zeros(H, dtype=torch.int32, device=dev),
                src_host=hosts, socket_slot=col(socket_slot),
                payload_words=self.payload_words,
            )
        dst_host = torch.as_tensor(dst_host, device=dev).expand(H)
        state, ok = self._tx(state, emitter, mask, now, dst_host, payload,
                             params=params)
        u = udp.count_sent(state.subs[udp.SUB], ok, col(socket_slot),
                           payload)
        return state.with_sub(udp.SUB, u)

    # ---- engine handlers ----

    def _deliver_local(self, state, mask, src, payload, emitter, now,
                       params):
        """Demux, deliver and run the app hooks for packets that reached
        the NIC."""
        u = state.subs[udp.SUB]
        is_udp = mask & (payload[:, pkt.W_PROTO] == pkt.PROTO_UDP)
        slot, found = udp.demux(u, is_udp, payload, src)
        u = udp.deliver(u, found, slot, payload)
        u = u.replace(drop_no_socket=u.drop_no_socket
                      + (is_udp & ~found).sum())
        state = state.add_counters(
            packets_delivered=mask.sum(),
            bytes_delivered=torch.where(
                mask, payload[:, pkt.W_LEN].to(torch.int64), 0).sum(),
        )
        state = state.with_sub(nic.SUB, nic.count_rx(
            state.subs[nic.SUB], mask, pkt.total_bytes(payload)))
        state = state.with_sub(udp.SUB, u)
        state = pds_mod.record_delivery(state, mask, payload, now)
        for hook in self.recv_hooks:
            state = hook(state, found, slot, src, payload, emitter, now,
                         params)
        if self.tcp is not None:
            is_tcp = mask & (payload[:, pkt.W_PROTO] == pkt.PROTO_TCP)
            state = self.tcp.on_segment(state, is_tcp, src, payload, emitter,
                                        now, params)
        return state

    def on_pkt_deliver(self, state: SimState, ev: EventView,
                       emitter: Emitter, params: NetParams) -> SimState:
        """A packet arrives: remote traffic enters the router (CoDel) or,
        uncontended, is delivered in this micro-step; loopback goes
        straight to the socket."""
        hosts = state.host.gid
        now = ev.time
        n = state.subs[nic.SUB]
        r = state.subs[codel.SUB]
        # the refill, direct test, charge and zero-sojourn CoDel reset (a
        # good packet: interval reset, drop-mode exit) in one launch (the
        # kernel nic_rx)
        o = emitter.ops.nic_rx(
            ev.mask, ev.src, hosts, now, n.rx_rem, n.rx_tick, n.rx_refill,
            n.rx_cap, r.q_head, r.q_tail, ev.payload, r.interval_expire,
            r.drop_mode, slots=r.q_src.shape[1],
            bootstrap_end=params.bootstrap_end)
        n = n.replace(rx_rem=o.rx_rem, rx_tick=o.rx_tick)
        r = r.replace(interval_expire=o.interval_expire,
                      drop_mode=o.drop_mode)
        queued = o.queued
        state = pds_mod.record_drop(state, o.no_room, ev.payload,
                                    pkt.PDS_DROPPED_OVERFLOW, now)
        r = codel.enqueue(
            r, queued,
            pkt.stamp(ev.payload, queued, pkt.PDS_ROUTER_ENQUEUED),
            ev.src, now, emitter.ops)
        state = state.with_sub(codel.SUB, r).with_sub(nic.SUB, n)
        state = self._deliver_local(state, o.local, ev.src, ev.payload,
                                    emitter, now, params)
        n = state.subs[nic.SUB]
        need = queued & ~n.recv_pending
        emitter.emit(need, now, hosts, KIND_NIC_RECV,
                     torch.zeros_like(ev.payload))
        n = n.replace(recv_pending=n.recv_pending | need)
        return state.with_sub(nic.SUB, n)

    def on_nic_send(self, state: SimState, ev: EventView, emitter: Emitter,
                    params: NetParams) -> SimState:
        """Send pump: one packet per invocation while tokens allow; re-arms
        at ``now`` (more queued) or at the next refill tick (no
        tokens)."""
        hosts = state.host.gid
        now = ev.time
        mask = ev.mask
        n = state.subs[nic.SUB]
        n = n.replace(send_pending=n.send_pending & ~mask)
        tx_rem, tx_tick = emitter.ops.nic_refill(
            n.tx_rem, n.tx_tick, n.tx_refill, n.tx_cap, now, mask)
        n = n.replace(tx_rem=tx_rem, tx_tick=tx_tick)
        bootstrap = now < params.bootstrap_end
        state = state.with_sub(nic.SUB, n)

        for _ in range(self.PUMP_BATCH):
            n = state.subs[nic.SUB]
            want = mask & (bootstrap | (n.tx_rem >= pkt.MTU))
            state, do, payload, dst = self.disc.dequeue(state, now, want,
                                                         emitter.ops)
            # the full wire size is charged (token debt allowed)
            size = pkt.total_bytes(payload)
            n = state.subs[nic.SUB]
            n = n.replace(tx_rem=torch.where(do & ~bootstrap,
                                             n.tx_rem - size, n.tx_rem))
            n = nic.count_tx(n, do, size)
            state = state.with_sub(nic.SUB, n)
            remote = do & (dst != hosts)
            wire = pkt.stamp(payload, do, pkt.PDS_SENT)
            state = link.send(
                state, emitter, remote, dst, now, KIND_PKT_DELIVER, wire,
                params, torch.where(remote, size, 0),
                control_mask=payload[:, pkt.W_LEN] == 0,
            )
            lb = do & (dst == hosts)
            emitter.emit(lb, now, hosts, KIND_PKT_DELIVER, wire)

        still = self.disc.nonempty(state)
        n = state.subs[nic.SUB]
        need = mask & still
        can_next = bootstrap | (n.tx_rem >= pkt.MTU)
        t_next = torch.where(can_next, now, nic.next_refill_time(now))
        emitter.emit(need, t_next, hosts, KIND_NIC_SEND,
                     torch.zeros_like(ev.payload))
        n = n.replace(send_pending=n.send_pending | need)
        return state.with_sub(nic.SUB, n)

    def on_nic_recv(self, state: SimState, ev: EventView, emitter: Emitter,
                    params: NetParams) -> SimState:
        """Receive pump: CoDel-dequeue one packet per invocation while rx
        tokens allow; re-arms while the router queue holds packets."""
        hosts = state.host.gid
        now = ev.time
        mask = ev.mask
        n = state.subs[nic.SUB]
        n = n.replace(recv_pending=n.recv_pending & ~mask)
        rx_rem, rx_tick = emitter.ops.nic_refill(
            n.rx_rem, n.rx_tick, n.rx_refill, n.rx_cap, now, mask)
        n = n.replace(rx_rem=rx_rem, rx_tick=rx_tick)
        bootstrap = now < params.bootstrap_end

        for _ in range(self.recv_batch):
            want = mask & (bootstrap | (n.rx_rem >= pkt.MTU))
            r, have, payload, src = codel.dequeue(
                state.subs[codel.SUB], now, want, emitter.ops,
                aqm=self.router_aqm)
            size = pkt.total_bytes(payload)
            n = n.replace(rx_rem=torch.where(have & ~bootstrap,
                                             n.rx_rem - size, n.rx_rem))
            state = state.with_sub(codel.SUB, r).with_sub(nic.SUB, n)
            state = self._deliver_local(state, have, src, payload, emitter,
                                        now, params)
            n = state.subs[nic.SUB]

        need = mask & codel.nonempty(state.subs[codel.SUB])
        can_next = bootstrap | (n.rx_rem >= pkt.MTU)
        t_next = torch.where(can_next, now, nic.next_refill_time(now))
        emitter.emit(need, t_next, hosts, KIND_NIC_RECV,
                     torch.zeros_like(payload))
        n = n.replace(recv_pending=n.recv_pending | need)
        return state.with_sub(nic.SUB, n)

    # ---- gated arrival batching (engine bulk support) ----

    def bulk_kinds(self) -> dict | None:
        if self.deliver_batch <= 1:
            return None
        return {KIND_PKT_DELIVER: self.deliver_batch}

    def bulk_gate(self, state: SimState, params: NetParams, win_start,
                  win_end, ops):
        """[H] int32: how many extra consecutive arrivals each host may
        batch this micro-step such that every one provably takes the
        direct paths. Buckets refill only to ``win_start`` and each
        arrival and reply is budgeted a full MTU; any armed pump or
        queued packet zeroes the gate. ``//`` floors on token debt, as
        JAX's does."""
        n = state.subs[nic.SUB]
        r = state.subs[codel.SUB]
        return ops.nic_gate(
            n.rx_rem, n.rx_tick, n.rx_refill, n.rx_cap, n.tx_rem, n.tx_tick,
            n.tx_refill, n.tx_cap, r.q_head, r.q_tail,
            self.disc.nonempty(state), n.recv_pending, n.send_pending,
            win_start=int(win_start),
            free=int(win_end) <= int(params.bootstrap_end),
            G=self.deliver_batch)

    def handlers(self) -> dict:
        h = {
            KIND_PKT_DELIVER: self.on_pkt_deliver,
            KIND_NIC_SEND: self.on_nic_send,
            KIND_NIC_RECV: self.on_nic_recv,
        }
        if self.tcp is not None:
            h.update(self.tcp.handlers())
        return h
