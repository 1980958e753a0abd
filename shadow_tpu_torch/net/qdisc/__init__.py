"""Per-interface egress scheduling: the qdisc discipline interface.

The JAX package's ``net/qdisc/__init__.py``: the NIC send pump drives a
discipline through

  nonempty(state)                         -> [H] bool
  enqueue(state, mask, dst, payload, now, ops) -> (state, admitted)
  dequeue(state, now, want, ops)          -> (state, sent, payload, dst)
  note_direct(state, mask, payload)       -> state

``fifo`` and ``roundrobin`` wrap the NIC's send ring; the fifo dequeue
is the kernel ``send_dequeue``, the round-robin one PyTorch operations
(``ROADMAP.md``, device function B10). The device-queue disciplines
``pifo`` (``pifo.py``) and ``eiffel`` (``eiffel.py``) own a
``subs["qdisc"]`` plane of ``[H, Q]`` queues with rank functions
(``ranks.py``) and drop policies (``drops.py``); their enqueue and
dequeue are the kernels ``qdisc_enqueue`` and ``qdisc_dequeue``. They
carry configuration and are built by ``sim.py`` from the ``qdisc:``
section.
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

    def dequeue(self, state, now, want, ops):
        raise NotImplementedError

    def note_direct(self, state, mask, payload):
        """Observe a packet that took the uncontended direct send."""
        return state


class FifoDiscipline(Discipline):
    """The default qdisc: the NIC ring in arrival order."""

    name = "fifo"

    def dequeue(self, state, now, want, ops):
        n = state.subs[nic.SUB]
        out = ops.send_dequeue(n.q_payload, n.q_dst, n.q_head, n.q_tail,
                               want.contiguous())
        return (state.with_sub(nic.SUB, n.replace(q_head=out.head)),
                out.sent, out.payload, out.dst)


class RoundRobinDiscipline(Discipline):
    """Round-robin over sockets: the next non-empty socket after the
    last-served one sends its oldest packet."""

    name = "roundrobin"

    def __init__(self):
        self.sockets_per_host = 8

    def attach(self, stack) -> None:
        self.sockets_per_host = stack.sockets_per_host

    def dequeue(self, state, now, want, ops):
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
    """The discipline for an ``experimental.interface_qdisc`` string;
    pifo and eiffel carry configuration and are built by ``sim.py``."""
    if qdisc == "fifo":
        return FifoDiscipline()
    if qdisc == "roundrobin":
        return RoundRobinDiscipline()
    raise ValueError(f"unknown qdisc {qdisc!r}")
