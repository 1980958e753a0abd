"""UDP sockets: per-host socket table, port binding, demux, delivery.

The JAX package's ``net/udp.py``: a fixed [H, S] socket table; demux
compares an incoming packet's (proto, dst_port, src_host, src_port) with
all S slots at once, and a peer-specific binding outranks a general one.
"""

from __future__ import annotations

import dataclasses

import torch

from shadow_tpu_torch.core import state as state_mod
from shadow_tpu_torch.core import soa
from shadow_tpu_torch.net import packet as pkt

SUB = "udp"

ANY_PEER = -1


@dataclasses.dataclass
class UdpState:
    used: torch.Tensor  # [H, S] bool
    bind_port: torch.Tensor  # [H, S] int32
    peer_host: torch.Tensor  # [H, S] int32 (ANY_PEER = unconnected)
    peer_port: torch.Tensor  # [H, S] int32
    recv_pkts: torch.Tensor  # [H, S] int64
    recv_bytes: torch.Tensor  # [H, S] int64
    sent_pkts: torch.Tensor  # [H, S] int64
    sent_bytes: torch.Tensor  # [H, S] int64
    drop_no_socket: torch.Tensor  # [] int64

    def replace(self, **fields) -> "UdpState":
        return state_mod.replace(self, **fields)


def init(num_hosts: int, sockets_per_host: int = 8,
         device=None) -> UdpState:
    H, S = num_hosts, sockets_per_host
    z = lambda dt: torch.zeros((H, S), dtype=dt, device=device)  # noqa
    return UdpState(
        used=z(torch.bool), bind_port=z(torch.int32),
        peer_host=torch.full((H, S), ANY_PEER, dtype=torch.int32,
                             device=device),
        peer_port=z(torch.int32), recv_pkts=z(torch.int64),
        recv_bytes=z(torch.int64), sent_pkts=z(torch.int64),
        sent_bytes=z(torch.int64),
        drop_no_socket=torch.zeros((), dtype=torch.int64, device=device),
    )


def bind_static(udp: UdpState, host: int, slot: int, port: int,
                peer_host: int = ANY_PEER, peer_port: int = 0) -> None:
    """Build-time binding, written in place into the build's table."""
    udp.used[host, slot] = True
    udp.bind_port[host, slot] = port
    udp.peer_host[host, slot] = peer_host
    udp.peer_port[host, slot] = peer_port


def demux(udp: UdpState, mask, payload, src_host):
    """The receiving socket slot per host: (slot [H] int32, found [H]
    bool); peer-specific beats general, the lowest slot wins ties."""
    dport = payload[:, pkt.W_DST_PORT][:, None]
    sport = payload[:, pkt.W_SRC_PORT][:, None]
    srch = src_host.to(torch.int32)[:, None]
    port_ok = udp.used & (udp.bind_port == dport)
    specific = port_ok & (udp.peer_host == srch) & (udp.peer_port == sport)
    general = port_ok & (udp.peer_host == ANY_PEER)
    score = specific.to(torch.int32) * 2 + general.to(torch.int32)
    best, slot = score.max(dim=1)
    # torch's max returns the first maximal index, as jnp.argmax does
    return slot.to(torch.int32), mask & (best > 0)


def deliver(udp: UdpState, mask, slot, payload) -> UdpState:
    nbytes = payload[:, pkt.W_LEN].to(torch.int64)
    return udp.replace(
        recv_pkts=soa.add_at(udp.recv_pkts, mask, slot, 1),
        recv_bytes=soa.add_at(udp.recv_bytes, mask, slot, nbytes),
    )


def count_sent(udp: UdpState, mask, slot, payload) -> UdpState:
    nbytes = payload[:, pkt.W_LEN].to(torch.int64)
    return udp.replace(
        sent_pkts=soa.add_at(udp.sent_pkts, mask, slot, 1),
        sent_bytes=soa.add_at(udp.sent_bytes, mask, slot, nbytes),
    )
