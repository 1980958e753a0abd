"""Upstream-router queue with CoDel AQM, vectorized per host.

The JAX package's ``net/codel.py`` (RFC 8289 with Shadow's doubled
target): packets from the simulated network enter the host's router ring
and the NIC receive pump dequeues them. The dequeue, with its sojourn
bookkeeping, drop-mode loop (one drop a call) and control law, is the
kernel ``codel_dequeue``; the append is the kernel ``ring_append``.
"""

from __future__ import annotations

import dataclasses

import torch

from shadow_tpu_torch.core import state as state_mod
from shadow_tpu_torch.core.state import PAYLOAD_WORDS
from shadow_tpu_torch.kernels import CODEL_INTERVAL_NS as INTERVAL_NS
from shadow_tpu_torch.kernels import CODEL_TARGET_NS as TARGET_NS

__all__ = ["INTERVAL_NS", "TARGET_NS", "RouterState", "init", "enqueue",
           "dequeue", "nonempty"]

DROP_UNROLL = 1

SUB = "router"


@dataclasses.dataclass
class RouterState:
    # ring [H, Q]
    q_payload: torch.Tensor  # [H, Q, P] int32
    q_src: torch.Tensor  # [H, Q] int32
    q_enq_ts: torch.Tensor  # [H, Q] int64
    q_head: torch.Tensor  # [H] int32
    q_tail: torch.Tensor  # [H] int32
    # CoDel per-host state
    drop_mode: torch.Tensor  # [H] bool (False = store)
    interval_expire: torch.Tensor  # [H] int64 (0 = unset)
    next_drop: torch.Tensor  # [H] int64
    drop_count: torch.Tensor  # [H] int32
    drop_count_last: torch.Tensor  # [H] int32
    total_size: torch.Tensor  # [H] int64 queued wire bytes
    # counters
    codel_dropped: torch.Tensor  # [] int64
    overflow_dropped: torch.Tensor  # [] int64
    # last AQM-dropped packet per host (written only with packet_trails)
    drop_trail: torch.Tensor  # [H] int32
    drop_time: torch.Tensor  # [H] int64

    def replace(self, **fields) -> "RouterState":
        return state_mod.replace(self, **fields)


def init(num_hosts: int, queue_slots: int = 64,
         payload_words: int = PAYLOAD_WORDS, device=None) -> RouterState:
    H, Q = num_hosts, queue_slots
    z64 = lambda: torch.zeros(H, dtype=torch.int64, device=device)  # noqa
    z32 = lambda: torch.zeros(H, dtype=torch.int32, device=device)  # noqa
    return RouterState(
        q_payload=torch.zeros((H, Q, payload_words), dtype=torch.int32,
                              device=device),
        q_src=torch.zeros((H, Q), dtype=torch.int32, device=device),
        q_enq_ts=torch.zeros((H, Q), dtype=torch.int64, device=device),
        q_head=z32(), q_tail=z32(),
        drop_mode=torch.zeros(H, dtype=torch.bool, device=device),
        interval_expire=z64(), next_drop=z64(), drop_count=z32(),
        drop_count_last=z32(), total_size=z64(),
        codel_dropped=torch.zeros((), dtype=torch.int64, device=device),
        overflow_dropped=torch.zeros((), dtype=torch.int64, device=device),
        drop_trail=z32(), drop_time=z64(),
    )


def enqueue(router: RouterState, mask, payload, src, now,
            ops) -> RouterState:
    """Append with the enqueue timestamp (the kernel ``ring_append``);
    a full ring drops the packet and counts it."""
    H = mask.shape[0]
    ts = torch.as_tensor(now, dtype=torch.int64,
                         device=mask.device).expand(H).contiguous()
    out = ops.ring_append(router.q_payload, router.q_src, router.q_enq_ts,
                          router.q_head, router.q_tail, mask,
                          payload.contiguous(),
                          src.to(torch.int32).contiguous(), ts,
                          router.total_size)
    return router.replace(
        q_payload=out.payload, q_src=out.col, q_enq_ts=out.ts,
        q_tail=out.tail, total_size=out.total_size,
        overflow_dropped=router.overflow_dropped + (mask & ~out.ok).sum(),
    )


def dequeue(router: RouterState, now, mask, ops, aqm: bool = True):
    """CoDel dequeue, one deliverable packet per masked host (the kernel
    ``codel_dequeue``). Returns (router, have, payload, src). ``aqm``
    False is the drop-tail FIFO pop of the static and single router
    variants."""
    r = router
    out = ops.codel_dequeue(
        r.q_payload, r.q_src, r.q_enq_ts, r.q_head, r.q_tail, r.drop_mode,
        r.interval_expire, r.next_drop, r.drop_count, r.drop_count_last,
        r.total_size, now.contiguous(), mask.contiguous(), aqm=aqm)
    r = r.replace(
        q_head=out.q_head, total_size=out.total_size,
        interval_expire=out.interval_expire, drop_mode=out.drop_mode,
        next_drop=out.next_drop, drop_count=out.drop_count,
        drop_count_last=out.drop_count_last,
        codel_dropped=r.codel_dropped + out.dropped.sum(),
    )
    return r, out.have, out.payload, out.src


def nonempty(router: RouterState):
    return router.q_head < router.q_tail
