"""Rank functions for the PIFO/Eiffel disciplines.

The JAX package's ``net/qdisc/ranks.py``. A rank function maps an
admitted packet to an int64 rank; the queue serves ranks ascending with
the per-host enqueue sequence number as the FIFO tiebreak:

  fifo   rank 0 for every packet: the queue is a plain FIFO.
  prio   the packet's app-priority word (``pkt.W_PRIORITY``).
  wfq    weighted fair queueing virtual finish times per flow class:
         vft = max(vtime[h], finish[h, c]) + size * inv_weight[c], the
         per-host virtual clock advanced to each dequeued rank.

Flow class: ``socket_slot % classes`` (floor, as ``jnp``'s ``%``) unless
the host carries a ``qdisc.overrides`` class. Token-bucket shaping is an
eligibility term on any ranker: a shaped class keeps a next-eligible
time that advances by size × ns_per_byte(rate) per packet, and the rank
is max(base_rank, eligible_time).

The ``Ranker`` classes hold the build-time tables (``inv_w`` with
``WFQ_SCALE``, ``ns_per_byte``); ``rank`` is the plain version of the
rank step that the kernel ``qdisc_enqueue`` (K22) carries on the card.
"""

from __future__ import annotations

import torch

from shadow_tpu_torch.core import simtime, soa
from shadow_tpu_torch.net import packet as pkt

# fixed-point scale for 1/weight in the virtual-finish increment
WFQ_SCALE = 256


class Ranker:
    """The build-time tables of a rank function."""

    name = "fifo"

    def __init__(self, classes: int = 1, weights=None, shaping=None):
        self.classes = int(classes)
        weights = list(weights) if weights else [1.0] * self.classes
        if len(weights) != self.classes:
            raise ValueError(
                f"qdisc weights length {len(weights)} != classes "
                f"{self.classes}")
        if any(w <= 0 for w in weights):
            raise ValueError("qdisc weights must be > 0")
        self.inv_w = [max(1, round(WFQ_SCALE / w)) for w in weights]
        # per-class shaping rate → ns per wire byte (0 = unshaped)
        npb = [0] * self.classes
        for c, bits in sorted((shaping or {}).items()):
            npb[int(c)] = max(1, simtime.NS_PER_SEC * 8 // int(bits))
        self.ns_per_byte = npb
        self.shaped = any(npb)


class FifoRank(Ranker):
    name = "fifo"


class PrioRank(Ranker):
    name = "prio"


class WfqRank(Ranker):
    name = "wfq"


def make_ranker(rank: str, classes: int = 1, weights=None,
                shaping=None) -> Ranker:
    cls = {"fifo": FifoRank, "prio": PrioRank, "wfq": WfqRank}.get(rank)
    if cls is None:
        raise ValueError(f"unknown qdisc rank {rank!r}")
    return cls(classes=classes, weights=weights, shaping=shaping)


def flow_class(qd: dict, payload, classes: int):
    """Per-packet flow class [H] int32: the host's override, else the
    socket slot mod classes (floor)."""
    sock = torch.remainder(payload[:, pkt.W_SOCKET], classes)
    return torch.where(qd["cls"] >= 0, qd["cls"], sock)


def rank(qd: dict, mask, payload, now, size, spec) -> torch.Tensor:
    """Plain version of ``Ranker.rank``: the rank [H] int64 of each
    host's packet under ``spec`` (``kernels.QdiscSpec``); updates
    ``qd``'s ``finish`` (wfq) and ``shape_next`` (shaping) where
    ``mask``."""
    cls = flow_class(qd, payload, spec.classes)
    idx = cls.to(torch.int64)
    if spec.rank == "wfq":
        start = torch.maximum(qd["vtime"], soa.get_at(qd["finish"], cls))
        base = start + size * spec.inv_w[idx]
        qd["finish"] = soa.set_at(qd["finish"], mask, cls, base)
    elif spec.rank == "prio":
        base = payload[:, pkt.W_PRIORITY].to(torch.int64)
    else:
        base = torch.zeros(mask.shape, dtype=torch.int64, device=mask.device)
    if not spec.shaped:
        return base
    npb = spec.ns_per_byte[idx]
    shaped = mask & (npb > 0)
    elig = torch.maximum(now, soa.get_at(qd["shape_next"], cls))
    qd["shape_next"] = soa.set_at(qd["shape_next"], shaped, cls,
                                  elig + size * npb)
    return torch.where(shaped, torch.maximum(base, elig), base)
