"""Per-interface egress scheduling: the qdisc discipline interface.

The JAX package's ``net/qdisc/__init__.py``: the NIC send pump drives a
discipline through

  nonempty(state)                         -> [H] bool
  enqueue(state, mask, dst, payload, now, ops) -> (state, admitted)
  dequeue(state, now, want)               -> (state, sent, payload, dst)
  note_direct(state, mask, payload)       -> state

``fifo`` and ``roundrobin`` wrap the NIC's send ring. The device-queue
disciplines ``pifo`` and ``eiffel`` are not ported yet (``ROADMAP.md``,
device function B9) and raise.
"""

from __future__ import annotations

import torch

from shadow_tpu_torch.net import nic

SUB = "qdisc"


class Discipline:
    """Egress-discipline interface the send pump drives."""

    name = "base"

    def attach(self, stack) -> None:
        """Bind build-time stack facts (host count, payload width,
        sockets per host)."""

    def init_subs(self) -> dict:
        """Extra sub-states this discipline owns ({} for ring
        wrappers)."""
        return {}

    def nonempty(self, state):
        n = state.subs[nic.SUB]
        return n.q_head < n.q_tail

    def enqueue(self, state, mask, dst, payload, now, ops):
        n, ok = nic.enqueue_send(state.subs[nic.SUB], mask, dst, payload,
                                 ops)
        return state.with_sub(nic.SUB, n), ok

    def dequeue(self, state, now, want):
        raise NotImplementedError

    def note_direct(self, state, mask, payload):
        """Observe a packet that took the uncontended direct send."""
        return state


class FifoDiscipline(Discipline):
    """The default qdisc: the NIC ring in arrival order."""

    name = "fifo"

    def dequeue(self, state, now, want):
        n = state.subs[nic.SUB]
        payload, dst, has_pkt = nic.peek_send(n)
        do = want & has_pkt
        return state.with_sub(nic.SUB, nic.pop_send(n, do)), do, payload, dst


class RoundRobinDiscipline(Discipline):
    """Round-robin over sockets: the next non-empty socket after the
    last-served one sends its oldest packet."""

    name = "roundrobin"

    def __init__(self):
        self.sockets_per_host = 8

    def attach(self, stack) -> None:
        self.sockets_per_host = stack.sockets_per_host

    def dequeue(self, state, now, want):
        n = state.subs[nic.SUB]
        payload, dst, has_pkt, rr_slot = nic.peek_send_rr(
            n, self.sockets_per_host)
        do = want & has_pkt
        n = nic.pop_send_rr(n, do, rr_slot)
        return state.with_sub(nic.SUB, n), do, payload, dst

    def note_direct(self, state, mask, payload):
        from shadow_tpu_torch.net import packet as pkt

        n = state.subs[nic.SUB]
        n = n.replace(last_socket=torch.where(
            mask, payload[:, pkt.W_SOCKET], n.last_socket))
        return state.with_sub(nic.SUB, n)


def make_discipline(qdisc: str) -> Discipline:
    """The discipline for an ``experimental.interface_qdisc`` string."""
    if qdisc == "fifo":
        return FifoDiscipline()
    if qdisc == "roundrobin":
        return RoundRobinDiscipline()
    if qdisc in ("pifo", "eiffel"):
        from shadow_tpu_torch.sim import BuildError

        raise BuildError(
            f"the {qdisc} qdisc is not ported to shadow_tpu_torch yet "
            f"(ROADMAP.md queue B, device function B9)")
    raise ValueError(f"unknown qdisc {qdisc!r}")
