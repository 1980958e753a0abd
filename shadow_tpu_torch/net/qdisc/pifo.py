"""Exact PIFO: rank-ordered push-in-first-out per host.

The JAX package's ``net/qdisc/pifo.py``. Slots 0..len-1 of a host's row
hold its packets by (rank, enqueue seq) ascending. Enqueue finds the
insertion position with one compare over the row (stable: equal ranks
keep arrival order) and shifts every slot from there to the end of the
row right by one; dequeue takes slot 0 and shifts the whole row left.

``DeviceQueueDiscipline`` here is also the base of ``eiffel.py``:
admission (overflow and RED), ranks, the drop hook and the counters are
common; the ring representation (``room``, ``depth``, ``insert``,
``pop``) differs. On the card the enqueue is the kernel
``qdisc_enqueue`` (K22) and the dequeue the kernel ``qdisc_dequeue``
(K23), which write the sub-state's tensors in place; ``enqueue_plain``
and ``dequeue_plain`` are their plain versions.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from shadow_tpu_torch import kernels
from shadow_tpu_torch.net import packet as pkt
from shadow_tpu_torch.net.qdisc import SUB, Discipline, drops, ranks


@dataclasses.dataclass
class QdiscState:
    """The ``subs["qdisc"]`` plane, under the JAX package's dict keys."""

    q_payload: torch.Tensor  # [H, Q, P] int32
    q_dst: torch.Tensor  # [H, Q] int32
    q_rank: torch.Tensor  # [H, Q] int64
    q_seq: torch.Tensor  # [H, Q] int64
    q_enq_ts: torch.Tensor  # [H, Q] int64
    q_bytes: torch.Tensor  # [H] int64 queued wire bytes
    seq: torch.Tensor  # [H] int64 next enqueue seq
    cls: torch.Tensor  # [H] int32 flow-class override (-1: none)
    # wfq virtual clock and per-class finish times; shaping spacing
    vtime: torch.Tensor  # [H] int64
    finish: torch.Tensor  # [H, C] int64
    shape_next: torch.Tensor  # [H, C] int64
    # the CoDel hook's state (net/codel.py's state machine)
    drop_mode: torch.Tensor  # [H] bool
    interval_expire: torch.Tensor  # [H] int64
    next_drop: torch.Tensor  # [H] int64
    drop_count: torch.Tensor  # [H] int32
    drop_count_last: torch.Tensor  # [H] int32
    # RED's state
    red_avg: torch.Tensor  # [H] int64
    red_count: torch.Tensor  # [H] int64
    # counters
    enqueues: torch.Tensor  # [H] int64
    dequeues: torch.Tensor  # [H] int64
    drops_overflow: torch.Tensor  # [H] int64
    drops_red: torch.Tensor  # [H] int64
    drops_codel: torch.Tensor  # [H] int64
    sojourn_sum: torch.Tensor  # [H] int64
    depth_peak: torch.Tensor  # [H] int64

    def fields(self) -> list:
        """Every tensor, in field order (the kernels' ``fields``)."""
        return [getattr(self, f.name) for f in dataclasses.fields(self)]

    def with_fields(self, values) -> "QdiscState":
        return type(self)(*values)


def _written(cls) -> tuple:
    # the kernels write every field in place on the card but the class
    # table (SimState.snapshot clones them)
    return tuple(f.name for f in dataclasses.fields(cls) if f.name != "cls")


@dataclasses.dataclass
class PifoState(QdiscState):
    q_len: torch.Tensor  # [H] int32


PifoState.IN_PLACE = _written(PifoState)


def make_state(**fields) -> QdiscState:
    """The sub-state class of a plane's fields: Eiffel's has q_valid."""
    if "q_valid" in fields:
        from shadow_tpu_torch.net.qdisc.eiffel import EiffelState

        return EiffelState(**fields)
    return PifoState(**fields)


# ---- representation (pifo: a sorted array) ----


def _shift_insert(arr, ok, pos, val):
    """Insert val at pos, shifting slots pos.. right by one, where ok."""
    Q = arr.shape[1]
    j = torch.arange(Q, dtype=torch.int32, device=arr.device)
    shifted = torch.cat([arr[:, :1], arr[:, :-1]], dim=1)
    if arr.dim() == 3:
        jj, pp, v, m = j[None, :, None], pos[:, None, None], \
            val[:, None, :], ok[:, None, None]
    else:
        jj, pp, v, m = j[None, :], pos[:, None], val[:, None], ok[:, None]
    ins = torch.where(jj < pp, arr, torch.where(jj == pp, v, shifted))
    return torch.where(m, ins, arr)


def _shift_left(arr, have):
    shifted = torch.cat([arr[:, 1:], arr[:, -1:]], dim=1)
    m = have[:, None, None] if arr.dim() == 3 else have[:, None]
    return torch.where(m, shifted, arr)


def room(qd, spec):
    return qd["q_len"] < qd["q_rank"].shape[1]


def depth(qd, spec):
    return qd["q_len"].to(torch.int64)


def insert(qd, ok, rank, dst, payload, now, spec):
    Q = qd["q_rank"].shape[1]
    j = torch.arange(Q, dtype=torch.int32, device=ok.device)[None, :]
    valid = j < qd["q_len"][:, None]
    # stable compare-and-place: existing equal-rank packets carry smaller
    # seqs, so the new packet lands after them
    pos = (valid & (qd["q_rank"] <= rank[:, None])).sum(dim=1).to(
        torch.int32)
    qd["q_payload"] = _shift_insert(qd["q_payload"], ok, pos, payload)
    qd["q_dst"] = _shift_insert(qd["q_dst"], ok, pos, dst)
    qd["q_rank"] = _shift_insert(qd["q_rank"], ok, pos, rank)
    qd["q_seq"] = _shift_insert(qd["q_seq"], ok, pos, qd["seq"])
    qd["q_enq_ts"] = _shift_insert(qd["q_enq_ts"], ok, pos, now)
    qd["q_len"] = qd["q_len"] + ok.to(torch.int32)


def pop(qd, want, spec):
    present = qd["q_len"] > 0
    have = want & present
    empty_hit = want & ~present
    payload = qd["q_payload"][:, 0]
    dst = qd["q_dst"][:, 0]
    enq_ts = qd["q_enq_ts"][:, 0]
    rank = qd["q_rank"][:, 0]
    size = pkt.total_bytes(payload)
    for k in ("q_payload", "q_dst", "q_rank", "q_seq", "q_enq_ts"):
        qd[k] = _shift_left(qd[k], have)
    qd["q_len"] = qd["q_len"] - have.to(torch.int32)
    qd["q_bytes"] = qd["q_bytes"] - torch.where(have, size, 0)
    qd["vtime"] = torch.where(have, torch.maximum(qd["vtime"], rank),
                              qd["vtime"])
    return have, payload, dst, enq_ts, empty_hit


def _ring(spec):
    """The module holding the representation of ``spec``'s discipline."""
    if spec.eiffel:
        from shadow_tpu_torch.net.qdisc import eiffel

        return eiffel
    return sys.modules[__name__]


# ---- the plain versions of the two kernels ----


def enqueue_plain(fields, mask, dst, payload, now, spec):
    """Plain version of ``DeviceQueueDiscipline.enqueue`` (K22): depth and
    room, RED, the rank, the insert and the counters. Returns
    ``kernels.QdiscEnqueueOut``."""
    names = spec.names
    qd = dict(zip(names, fields))
    ring = _ring(spec)
    d = ring.depth(qd, spec)
    has_room = ring.room(qd, spec)
    attempt = mask & has_room
    red_drop = drops.red_enqueue(qd, attempt, d, spec.red)
    ok = attempt & ~red_drop
    size = pkt.total_bytes(payload)
    rk = ranks.rank(qd, ok, payload, now, size, spec)
    ring.insert(qd, ok, rk, dst, payload, now, spec)
    ok64 = ok.to(torch.int64)
    qd["q_bytes"] = qd["q_bytes"] + torch.where(ok, size, 0)
    qd["seq"] = qd["seq"] + ok64
    qd["enqueues"] = qd["enqueues"] + ok64
    qd["drops_overflow"] = (qd["drops_overflow"]
                            + (mask & ~has_room).to(torch.int64))
    qd["depth_peak"] = torch.maximum(qd["depth_peak"], d + ok64)
    return kernels.QdiscEnqueueOut(tuple(qd[n] for n in names), ok)


def dequeue_plain(fields, now, want, spec):
    """Plain version of ``DeviceQueueDiscipline.dequeue`` (K23): the pop,
    under the CoDel hook where ``spec.drop`` is codel, and the counters.
    Returns ``kernels.QdiscDequeueOut``."""
    names = spec.names
    qd = dict(zip(names, fields))
    ring = _ring(spec)

    def one_pop(q, m):
        return ring.pop(q, m, spec)

    hook = drops.codel_dequeue if spec.drop == "codel" else \
        drops.plain_dequeue
    have, payload, dst, enq_ts = hook(one_pop, qd, now, want)
    qd["dequeues"] = qd["dequeues"] + have.to(torch.int64)
    qd["sojourn_sum"] = qd["sojourn_sum"] + torch.where(have, now - enq_ts,
                                                        0)
    return kernels.QdiscDequeueOut(tuple(qd[n] for n in names), have,
                                   payload, dst)


# ---- the disciplines ----


class DeviceQueueDiscipline(Discipline):
    """Shared machinery of the device-queue disciplines (pifo/eiffel):
    owns the ``subs["qdisc"]`` plane, admission with RED, rank functions
    and the CoDel drop hook."""

    name = "pifo"
    state_class = PifoState

    def __init__(self, queue_slots: int = 64,
                 ranker: ranks.Ranker | None = None, drop: str = "none",
                 red: drops.RedConfig | None = None, host_class=None):
        if drop not in drops.DROP_NAMES:
            raise ValueError(f"unknown qdisc drop {drop!r}")
        self.queue_slots = int(queue_slots)
        self.ranker = ranker or ranks.FifoRank()
        self.drop = drop
        self.red = red if drop == "red" else None
        self.host_class = host_class  # [H] ints or None
        self.num_hosts = 0
        self.payload_words = 12
        self.device = None
        self.spec = None

    def _spec_kw(self) -> dict:
        return {}

    def attach(self, stack) -> None:
        self.num_hosts = stack.num_hosts
        self.payload_words = stack.payload_words
        self.device = stack.device
        r = self.ranker

        def table(v):
            return torch.as_tensor(v, dtype=torch.int64, device=self.device)

        self.spec = kernels.QdiscSpec(
            names=tuple(f.name for f in dataclasses.fields(
                self.state_class)),
            eiffel=self.name == "eiffel", rank=r.name, classes=r.classes,
            inv_w=table(r.inv_w), ns_per_byte=table(r.ns_per_byte),
            shaped=r.shaped, drop=self.drop, red=self.red,
            **self._spec_kw())

    def _init_ring(self, H: int, Q: int) -> dict:
        return {"q_len": torch.zeros(H, dtype=torch.int32,
                                     device=self.device)}

    def init_subs(self) -> dict:
        H, Q, P = self.num_hosts, self.queue_slots, self.payload_words
        C = self.ranker.classes
        dev = self.device

        def z(*shape, dtype=torch.int64):
            return torch.zeros(shape, dtype=dtype, device=dev)

        cls = (torch.full((H,), -1, dtype=torch.int32, device=dev)
               if self.host_class is None else torch.as_tensor(
                   np.asarray(self.host_class, np.int32), device=dev))
        qd = dict(
            q_payload=z(H, Q, P, dtype=torch.int32),
            q_dst=z(H, Q, dtype=torch.int32), q_rank=z(H, Q),
            q_seq=z(H, Q), q_enq_ts=z(H, Q), q_bytes=z(H), seq=z(H),
            cls=cls, vtime=z(H), finish=z(H, C), shape_next=z(H, C),
            drop_mode=z(H, dtype=torch.bool), interval_expire=z(H),
            next_drop=z(H), drop_count=z(H, dtype=torch.int32),
            drop_count_last=z(H, dtype=torch.int32), red_avg=z(H),
            red_count=z(H), enqueues=z(H), dequeues=z(H),
            drops_overflow=z(H), drops_red=z(H), drops_codel=z(H),
            sojourn_sum=z(H), depth_peak=z(H),
        )
        qd.update(self._init_ring(H, Q))
        return {SUB: self.state_class(**qd)}

    def nonempty(self, state):
        return state.subs[SUB].q_len > 0

    def enqueue(self, state, mask, dst, payload, now, ops):
        qd = state.subs[SUB]
        out = ops.qdisc_enqueue(qd.fields(), mask, dst, payload, now,
                                spec=self.spec)
        return state.with_sub(SUB, qd.with_fields(out.fields)), out.ok

    def dequeue(self, state, now, want, ops):
        qd = state.subs[SUB]
        out = ops.qdisc_dequeue(qd.fields(), now, want, spec=self.spec)
        return (state.with_sub(SUB, qd.with_fields(out.fields)), out.have,
                out.payload, out.dst)


class PifoDiscipline(DeviceQueueDiscipline):
    name = "pifo"

