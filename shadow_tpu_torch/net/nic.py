"""Per-host network interface: token buckets and the send ring.

The JAX package's ``net/nic.py``. Token buckets refill lazily from the
1 ms grid anchored at t = 0 whenever they are touched; one packet moves
per pump event. The send ring keeps arrival order (the fifo qdisc); the
round-robin qdisc consumes it mid-ring through the helpers at the bottom.
The append is the kernel ``ring_append``; the refill and the ring's
peek and pop are PyTorch operations.
"""

from __future__ import annotations

import dataclasses

import torch

from shadow_tpu_torch.core import state as state_mod
from shadow_tpu_torch.core import simtime, soa
from shadow_tpu_torch.core.state import PAYLOAD_WORDS
from shadow_tpu_torch.net import packet as pkt

REFILL_NS = simtime.NS_PER_MS

SUB = "nic"


@dataclasses.dataclass
class NicState:
    # token buckets, bytes
    tx_rem: torch.Tensor  # [H] int64
    rx_rem: torch.Tensor  # [H] int64
    tx_tick: torch.Tensor  # [H] int64: last refill grid tick applied
    rx_tick: torch.Tensor  # [H] int64
    tx_refill: torch.Tensor  # [H] int64 bytes per interval
    rx_refill: torch.Tensor  # [H] int64
    tx_cap: torch.Tensor  # [H] int64 = refill + MTU
    rx_cap: torch.Tensor  # [H] int64
    # send ring [H, NQ]
    q_payload: torch.Tensor  # [H, NQ, P] int32
    q_dst: torch.Tensor  # [H, NQ] int32
    q_head: torch.Tensor  # [H] int32 (grows; slot = idx % NQ)
    q_tail: torch.Tensor  # [H] int32
    # pump-pending flags
    send_pending: torch.Tensor  # [H] bool
    recv_pending: torch.Tensor  # [H] bool
    # round-robin qdisc state
    last_socket: torch.Tensor  # [H] int32 (-1 = none yet)
    q_taken: torch.Tensor  # [H, NQ] bool
    sendq_dropped: torch.Tensor  # [] int64
    # per-host byte/packet tracker
    tx_packets: torch.Tensor  # [H] int64
    tx_bytes: torch.Tensor  # [H] int64
    rx_packets: torch.Tensor  # [H] int64
    rx_bytes: torch.Tensor  # [H] int64

    def replace(self, **fields) -> "NicState":
        return state_mod.replace(self, **fields)


def init(bw_up_bits, bw_down_bits, queue_slots: int = 64,
         payload_words: int = PAYLOAD_WORDS, device=None) -> NicState:
    """bw_*_bits: [H] bits/s per host (numpy or tensor)."""
    up = torch.as_tensor(bw_up_bits, dtype=torch.int64, device=device)
    down = torch.as_tensor(bw_down_bits, dtype=torch.int64, device=device)
    H = up.shape[0]
    tx_refill = ((up // 8) * REFILL_NS // simtime.NS_PER_SEC).clamp(min=1)
    rx_refill = ((down // 8) * REFILL_NS // simtime.NS_PER_SEC).clamp(min=1)
    z64 = lambda: torch.zeros(H, dtype=torch.int64, device=device)  # noqa
    NQ = queue_slots
    return NicState(
        tx_rem=tx_refill + pkt.MTU, rx_rem=rx_refill + pkt.MTU,
        tx_tick=z64(), rx_tick=z64(),
        tx_refill=tx_refill, rx_refill=rx_refill,
        tx_cap=tx_refill + pkt.MTU, rx_cap=rx_refill + pkt.MTU,
        q_payload=torch.zeros((H, NQ, payload_words), dtype=torch.int32,
                              device=device),
        q_dst=torch.zeros((H, NQ), dtype=torch.int32, device=device),
        q_head=torch.zeros(H, dtype=torch.int32, device=device),
        q_tail=torch.zeros(H, dtype=torch.int32, device=device),
        send_pending=torch.zeros(H, dtype=torch.bool, device=device),
        recv_pending=torch.zeros(H, dtype=torch.bool, device=device),
        last_socket=torch.full((H,), -1, dtype=torch.int32, device=device),
        q_taken=torch.zeros((H, NQ), dtype=torch.bool, device=device),
        sendq_dropped=torch.zeros((), dtype=torch.int64, device=device),
        tx_packets=z64(), tx_bytes=z64(), rx_packets=z64(), rx_bytes=z64(),
    )


def count_tx(nic: NicState, mask, size) -> NicState:
    return nic.replace(
        tx_packets=nic.tx_packets + mask.to(torch.int64),
        tx_bytes=nic.tx_bytes + torch.where(mask, size.to(torch.int64), 0),
    )


def count_rx(nic: NicState, mask, size) -> NicState:
    return nic.replace(
        rx_packets=nic.rx_packets + mask.to(torch.int64),
        rx_bytes=nic.rx_bytes + torch.where(mask, size.to(torch.int64), 0),
    )


def lazy_refill(rem, tick, refill, cap, now, mask=None):
    """Apply every grid refill since ``tick``, clamped to the capacity.
    ``mask`` gates the lanes that update: lanes of hosts without a real
    event carry ``now`` = NEVER, where ``(now_tick - tick) * refill``
    wraps; the select discards them, as in the JAX package. ``//`` floors
    as JAX's does."""
    now_tick = now // REFILL_NS
    new_rem = torch.minimum(cap, rem + (now_tick - tick) * refill)
    new_rem = torch.where(now_tick > tick, new_rem, rem)
    new_tick = torch.maximum(tick, now_tick)
    if mask is not None:
        new_rem = torch.where(mask, new_rem, rem)
        new_tick = torch.where(mask, new_tick, tick)
    return new_rem, new_tick


def next_refill_time(now):
    return (now // REFILL_NS + 1) * REFILL_NS


def enqueue_send(nic: NicState, mask, dst_host, payload,
                 ops) -> tuple[NicState, torch.Tensor]:
    """Append a packet to the send ring (the kernel ``ring_append``).
    Returns (nic, ok)."""
    out = ops.ring_append(nic.q_payload, nic.q_dst, None, nic.q_head,
                          nic.q_tail, mask.contiguous(), payload.contiguous(),
                          dst_host.to(torch.int32).contiguous(), None, None)
    return nic.replace(
        q_payload=out.payload, q_dst=out.col, q_tail=out.tail,
        sendq_dropped=nic.sendq_dropped + (mask & ~out.ok).sum(),
    ), out.ok


def peek_send(nic: NicState):
    """Head packet per host: (payload [H, P], dst [H], nonempty [H])."""
    nonempty = nic.q_head < nic.q_tail
    slot = nic.q_head % nic.q_dst.shape[1]
    return (soa.get_at(nic.q_payload, slot), soa.get_at(nic.q_dst, slot),
            nonempty)


def pop_send(nic: NicState, mask) -> NicState:
    return nic.replace(q_head=nic.q_head + mask.to(torch.int32))


# ---------------------------------------------------------------------------
# round-robin-over-sockets qdisc: the next non-empty socket after the
# last-served one sends its oldest queued packet; mid-ring consumption
# marks slots taken, and the head advances past taken slots
# ---------------------------------------------------------------------------


def _rr_order(nic: NicState, sockets_per_host: int):
    """Per ring position j (age order): (selectable, rr_key, slot)."""
    H, NQ = nic.q_dst.shape
    dev = nic.q_dst.device
    j = torch.arange(NQ, dtype=torch.int32, device=dev)[None, :]
    slot = ((nic.q_head[:, None] + j) % NQ).to(torch.int64)
    hosts = torch.arange(H, device=dev)[:, None]
    present = (j < (nic.q_tail - nic.q_head)[:, None]) & ~nic.q_taken[
        hosts, slot]
    sock = nic.q_payload[hosts, slot, pkt.W_SOCKET]
    S = sockets_per_host
    cycle = (sock - nic.last_socket[:, None] - 1) % S
    key = torch.where(present, cycle * NQ + j, S * NQ + NQ)
    return present, key, slot.to(torch.int32)


def peek_send_rr(nic: NicState, sockets_per_host: int):
    """RR head packet per host: (payload [H, P], dst [H], nonempty [H],
    slot [H])."""
    present, key, slot = _rr_order(nic, sockets_per_host)
    pick = torch.argmin(key, dim=1).to(torch.int32)
    sel = soa.get_at(slot, pick)
    return (soa.get_at(nic.q_payload, sel), soa.get_at(nic.q_dst, sel),
            present.any(dim=1), sel)


def pop_send_rr(nic: NicState, mask, slot) -> NicState:
    """Consume the RR-selected slot, remember its socket, advance the head
    past any leading taken slots."""
    H, NQ = nic.q_dst.shape
    dev = nic.q_dst.device
    hosts = torch.arange(H, device=dev)
    cols = torch.arange(NQ, dtype=torch.int32, device=dev)
    hit = mask[:, None] & (cols[None, :] == slot[:, None])
    taken = nic.q_taken | hit
    sock = nic.q_payload[hosts, slot.to(torch.int64), pkt.W_SOCKET]
    last = torch.where(mask, sock, nic.last_socket)
    j = cols[None, :]
    ring_slot = ((nic.q_head[:, None] + j) % NQ).to(torch.int64)
    count = nic.q_tail - nic.q_head
    live = (j < count[:, None]) & ~taken[hosts[:, None], ring_slot]
    first_live = torch.where(
        live.any(dim=1), torch.argmax(live.to(torch.int32), dim=1).to(
            torch.int32), count)
    rel = (cols[None, :] - (nic.q_head[:, None] % NQ)) % NQ
    taken = taken & ~(rel < first_live[:, None])
    return nic.replace(q_head=nic.q_head + first_live, q_taken=taken,
                       last_socket=last)
