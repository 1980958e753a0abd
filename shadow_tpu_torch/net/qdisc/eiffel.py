"""Eiffel-style bucketed approximate PIFO (Eiffel, NSDI'19).

The JAX package's ``net/qdisc/eiffel.py``. Packets land in the first free
slot and carry their bucket, (rank // bucket_width) mod B (floor, as
``jnp``'s). Dequeue scans circularly from the current service bucket: one
argmin over ((bucket - cur_bucket) mod B) · 2⁴⁰ + seq, so packets of one
bucket serve FIFO and the nearest non-empty bucket wins. Where no slot is
valid every key is INT64_MAX and the argmin is slot 0, whose packet the
pop still returns (``have`` false); where the row is full the first free
slot's argmax is 0 too. The kernels ``qdisc_enqueue`` (K22) and
``qdisc_dequeue`` (K23) carry both on the card.
"""

from __future__ import annotations

import dataclasses

import torch

from shadow_tpu_torch.core import soa
from shadow_tpu_torch.net import packet as pkt
from shadow_tpu_torch.net.qdisc import pifo as pifo_mod

# seq rides in the low bits of the scan key below the bucket distance
SEQ_SPAN = 1 << 40
INT64_MAX = (1 << 63) - 1


@dataclasses.dataclass
class EiffelState(pifo_mod.QdiscState):
    q_valid: torch.Tensor  # [H, Q] bool
    q_bucket: torch.Tensor  # [H, Q] int64
    cur_bucket: torch.Tensor  # [H] int64


EiffelState.IN_PLACE = pifo_mod._written(EiffelState)


class EiffelDiscipline(pifo_mod.DeviceQueueDiscipline):
    name = "eiffel"
    state_class = EiffelState

    def __init__(self, queue_slots: int = 64, buckets: int = 16,
                 bucket_width: int = 1, **kw):
        super().__init__(queue_slots=queue_slots, **kw)
        self.buckets = int(buckets)
        self.bucket_width = int(bucket_width)
        if self.buckets < 2:
            raise ValueError("qdisc buckets must be >= 2")
        if self.bucket_width < 1:
            raise ValueError("qdisc bucket_width must be >= 1")

    def _spec_kw(self) -> dict:
        return dict(buckets=self.buckets, bucket_width=self.bucket_width)

    def _init_ring(self, H: int, Q: int) -> dict:
        dev = self.device
        return {
            "q_valid": torch.zeros((H, Q), dtype=torch.bool, device=dev),
            "q_bucket": torch.zeros((H, Q), dtype=torch.int64, device=dev),
            "cur_bucket": torch.zeros(H, dtype=torch.int64, device=dev),
        }

    def nonempty(self, state):
        return state.subs[pifo_mod.SUB].q_valid.any(dim=1)


# ---- representation (eiffel: free slots and bucket tags) ----


def room(qd, spec):
    return (~qd["q_valid"]).any(dim=1)


def depth(qd, spec):
    return qd["q_valid"].sum(dim=1, dtype=torch.int64)


def insert(qd, ok, rank, dst, payload, now, spec):
    # the first free slot of each row (argmax over the free mask)
    slot = (~qd["q_valid"]).to(torch.uint8).argmax(dim=1).to(torch.int32)
    bucket = torch.remainder(
        torch.div(rank, spec.bucket_width, rounding_mode="floor"),
        spec.buckets)
    qd["q_payload"] = soa.set_at(qd["q_payload"], ok, slot, payload)
    qd["q_dst"] = soa.set_at(qd["q_dst"], ok, slot, dst)
    qd["q_rank"] = soa.set_at(qd["q_rank"], ok, slot, rank)
    qd["q_seq"] = soa.set_at(qd["q_seq"], ok, slot, qd["seq"])
    qd["q_enq_ts"] = soa.set_at(qd["q_enq_ts"], ok, slot, now)
    qd["q_bucket"] = soa.set_at(qd["q_bucket"], ok, slot, bucket)
    qd["q_valid"] = soa.set_at(qd["q_valid"], ok, slot, True)


def pop(qd, want, spec):
    valid = qd["q_valid"]
    # circular bucket distance from the service position; FIFO (seq)
    # inside a bucket
    rel = torch.remainder(qd["q_bucket"] - qd["cur_bucket"][:, None],
                          spec.buckets)
    key = torch.where(valid, rel * SEQ_SPAN + qd["q_seq"], INT64_MAX)
    pick = key.argmin(dim=1).to(torch.int32)
    present = valid.any(dim=1)
    have = want & present
    empty_hit = want & ~present
    payload = soa.get_at(qd["q_payload"], pick)
    dst = soa.get_at(qd["q_dst"], pick)
    enq_ts = soa.get_at(qd["q_enq_ts"], pick)
    rank = soa.get_at(qd["q_rank"], pick)
    bucket = soa.get_at(qd["q_bucket"], pick)
    size = pkt.total_bytes(payload)
    qd["q_valid"] = soa.set_at(valid, have, pick, False)
    qd["cur_bucket"] = torch.where(have, bucket, qd["cur_bucket"])
    qd["q_bytes"] = qd["q_bytes"] - torch.where(have, size, 0)
    qd["vtime"] = torch.where(have, torch.maximum(qd["vtime"], rank),
                              qd["vtime"])
    return have, payload, dst, enq_ts, empty_hit
