"""Simulated packet representation: payload-word layout.

The JAX package's ``net/packet.py``. On the device a packet is P int32
words riding inside an event row; payload bytes are never materialized,
only their length. The per-packet status trail (word 12, with
``experimental.packet_trails``) is not ported, so ``stamp`` is the
identity at the 12-word width every ported simulation uses.
"""

from __future__ import annotations

import torch

from shadow_tpu_torch.core.state import PAYLOAD_WORDS
from shadow_tpu_torch.kernels import (
    MTU,
    PROTO_TCP,
    TCP_HEADER_BYTES,
    UDP_HEADER_BYTES,
    W_LEN,
    W_PROTO,
    W_TRAIL,
    wire_bytes,
)

__all__ = ["MTU", "PROTO_TCP", "TCP_HEADER_BYTES", "UDP_HEADER_BYTES",
           "W_LEN", "W_PROTO", "W_TRAIL"]

# word indices
W_SRC_PORT = 1
W_DST_PORT = 2
W_PRIORITY = 4  # app-order priority (the fifo qdisc's key)
W_SEQ = 6  # TCP sequence number (UDP echo: send time, low word)
W_ACK = 7  # TCP acknowledgment (UDP echo: send time, high word)
W_SRC_HOST = 9  # global host index of the original sender
W_SOCKET = 10  # sender-side socket slot

PROTO_UDP = 17

# delivery-status codes the stack stamps (recorded only with packet_trails)
PDS_NIC_QUEUED = 2
PDS_SENT = 3
PDS_DROPPED_LOSS = 4
PDS_ROUTER_ENQUEUED = 5
PDS_DROPPED_OVERFLOW = 7
PDS_DROPPED_SENDQ = 9


def stamp(payload: torch.Tensor, mask, code: int) -> torch.Tensor:
    """Shift a status code into masked packets' trail word: the identity
    without the trail word (payload width <= 12)."""
    if payload.shape[-1] <= W_TRAIL:
        return payload
    raise NotImplementedError("packet_trails are not ported to "
                              "shadow_tpu_torch yet (ROADMAP.md queue A 7)")


def total_bytes(payload: torch.Tensor) -> torch.Tensor:
    """Wire size of a packet given its payload words [..., P], int64."""
    return wire_bytes(payload)


def pack_time(payload: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Stash an int64 timestamp in the (UDP-unused) seq/ack words."""
    out = payload.clone()
    out[:, W_SEQ] = (t & 0xFFFFFFFF).to(torch.int32)
    out[:, W_ACK] = (t >> 32).to(torch.int32)
    return out


def unpack_time(payload: torch.Tensor) -> torch.Tensor:
    lo = payload[:, W_SEQ].to(torch.int64) & 0xFFFFFFFF
    hi = payload[:, W_ACK].to(torch.int64)
    return (hi << 32) | lo


def make_udp(src_port, dst_port, length, priority, src_host,
             socket_slot=None, payload_words: int = PAYLOAD_WORDS):
    """Assemble [H, P] int32 payload words for a UDP datagram; each field
    is an [H] tensor."""
    if payload_words > W_TRAIL:
        raise NotImplementedError("packet_trails are not ported to "
                                  "shadow_tpu_torch yet (ROADMAP.md queue "
                                  "A 7)")
    H = src_host.shape[0]
    pl = torch.zeros((H, payload_words), dtype=torch.int32,
                     device=src_host.device)
    pl[:, W_PROTO] = PROTO_UDP
    pl[:, W_SRC_PORT] = src_port
    pl[:, W_DST_PORT] = dst_port
    pl[:, W_LEN] = length
    pl[:, W_PRIORITY] = priority
    pl[:, W_SRC_HOST] = src_host
    if socket_slot is not None:
        pl[:, W_SOCKET] = socket_slot
    return pl
