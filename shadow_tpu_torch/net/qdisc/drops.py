"""Drop policies for the PIFO/Eiffel disciplines.

The JAX package's ``net/qdisc/drops.py``, both hooks deterministic:

- RED at enqueue: an EWMA of queue depth (fixed point, weight 1/8) gates
  a count-based early-drop schedule: between the min and max thresholds
  every ceil(1/p)-th admission drops, p ramping linearly to max_p; at or
  above max everything drops.
- CoDel at dequeue: the router AQM's target/interval control law
  (``kernels.control_law``, which the router's ``codel_dequeue`` uses
  too) folded in as a drop hook over the discipline's own pop.

A pop has the signature ``pop(qd, want) -> (have, payload, dst, enq_ts,
empty_hit)``, updates ``qd`` and has already taken the popped packet's
bytes off ``qd["q_bytes"]``. These are the plain versions of the hooks
that the kernels ``qdisc_enqueue`` (K22) and ``qdisc_dequeue`` (K23)
carry on the card.
"""

from __future__ import annotations

import torch

from shadow_tpu_torch.kernels import (
    CODEL_INTERVAL_NS as INTERVAL_NS,
    CODEL_TARGET_NS as TARGET_NS,
    MTU,
    control_law,
)

# fixed-point shifts for the RED average: depth carried as depth << 8,
# EWMA weight 1/8
RED_FP_SHIFT = 8
RED_W_SHIFT = 3

DROP_NAMES = ("none", "red", "codel")


class RedConfig:
    def __init__(self, queue_slots: int, min_frac: float, max_frac: float,
                 max_p: float):
        if not (0.0 <= min_frac < max_frac <= 1.0):
            raise ValueError(
                "qdisc red thresholds need 0 <= min_frac < max_frac <= 1")
        if not (0.0 < max_p <= 1.0):
            raise ValueError("qdisc red_max_p must be in (0, 1]")
        self.min_fp = int(min_frac * queue_slots) << RED_FP_SHIFT
        self.max_fp = int(max_frac * queue_slots) << RED_FP_SHIFT
        if self.max_fp <= self.min_fp:
            self.max_fp = self.min_fp + (1 << RED_FP_SHIFT)
        self.max_p = float(max_p)
        # p = max_p * (avg - min_fp) / (max_fp - min_fp) as XLA compiles
        # it: the division by the constant becomes a multiply by its
        # reciprocal, folded with max_p into one constant
        self.scale = self.max_p * (1.0 / float(self.max_fp - self.min_fp))


def red_interval(avg, red: RedConfig):
    """The deterministic inter-drop spacing ceil(1/p) [H] int64 at the
    average ``avg``, in float64."""
    p = (avg - red.min_fp).to(torch.float64) * red.scale
    return torch.ceil(1.0 / torch.clamp(p, min=1e-9)).to(torch.int64)


def red_enqueue(qd: dict, attempt, depth, red: RedConfig | None):
    """EWMA + deterministic early drop. ``attempt`` masks admission
    attempts that have room; ``depth`` is the pre-enqueue depth [H]
    int64. Updates ``qd``; returns drop [H] bool."""
    if red is None:
        return torch.zeros_like(attempt)
    avg = qd["red_avg"]
    avg = torch.where(
        attempt, avg + (((depth << RED_FP_SHIFT) - avg) >> RED_W_SHIFT), avg)
    over = avg >= red.max_fp
    between = (avg >= red.min_fp) & ~over
    interval = red_interval(avg, red)
    cnt = qd["red_count"] + attempt.to(torch.int64)
    drop = attempt & (over | (between & (cnt >= interval)))
    qd["red_avg"] = avg
    # the counter runs only inside the ramp region; a drop (or leaving
    # the region) restarts the spacing
    qd["red_count"] = torch.where(drop | ~between, 0, cnt)
    qd["drops_red"] = qd["drops_red"] + drop.to(torch.int64)
    return drop


def _pop_bookkeeping(pop, qd: dict, now, want):
    """One masked pop with CoDel sojourn bookkeeping. Returns (have,
    payload, dst, enq_ts, ok_to_drop)."""
    ie0 = qd["interval_expire"]
    have, payload, dst, enq_ts, empty_hit = pop(qd, want)
    sojourn = now - enq_ts
    good = (sojourn < TARGET_NS) | (qd["q_bytes"] < MTU)
    ie = torch.where(have & good, 0, ie0)
    entering_bad = have & ~good & (ie0 == 0)
    ie = torch.where(entering_bad, now + INTERVAL_NS, ie)
    ok_to_drop = have & ~good & (ie0 != 0) & (now >= ie0)
    qd["interval_expire"] = torch.where(empty_hit, 0, ie)
    return have, payload, dst, enq_ts, ok_to_drop


def plain_dequeue(pop, qd: dict, now, mask):
    """No dequeue-side AQM: a single masked pop."""
    have, payload, dst, enq_ts, _empty = pop(qd, mask)
    return have, payload, dst, enq_ts


def codel_dequeue(pop, qd: dict, now, mask):
    """CoDel dequeue over a discipline pop: the router's state machine
    with ``DROP_UNROLL`` = 1, drops tallied per host in
    ``qd["drops_codel"]``. Returns (have, payload, dst, enq_ts)."""
    have, payload, dst, enq_ts, ok = _pop_bookkeeping(pop, qd, now, mask)
    dm = torch.where(mask & ~have, False, qd["drop_mode"])
    in_drop = mask & have & dm
    dm = torch.where(in_drop & ~ok, False, dm)

    # the drop-mode step: drop while now >= next_drop (one, unrolled)
    cond = mask & have & dm & (now >= qd["next_drop"])
    qd["drops_codel"] = qd["drops_codel"] + cond.to(torch.int64)
    qd["drop_count"] = qd["drop_count"] + cond.to(torch.int32)
    have2, payload2, dst2, enq2, ok2 = _pop_bookkeeping(pop, qd, now, cond)
    have = torch.where(cond, have2, have)
    payload = torch.where(cond[:, None], payload2, payload)
    dst = torch.where(cond, dst2, dst)
    enq_ts = torch.where(cond, enq2, enq_ts)
    ok = torch.where(cond, ok2, ok)
    qd["next_drop"] = torch.where(
        cond & ok2, control_law(qd["drop_count"], qd["next_drop"]),
        qd["next_drop"])
    dm = torch.where(cond & ~ok2, False, dm)

    # store mode but the packet in hand should drop: drop it, enter drop
    # mode
    trans = mask & have & ~dm & ok
    qd["drops_codel"] = qd["drops_codel"] + trans.to(torch.int64)
    have3, payload3, dst3, enq3, _ok3 = _pop_bookkeeping(pop, qd, now, trans)
    have = torch.where(trans, have3, have)
    payload = torch.where(trans[:, None], payload3, payload)
    dst = torch.where(trans, dst3, dst)
    enq_ts = torch.where(trans, enq3, enq_ts)
    delta = qd["drop_count"] - qd["drop_count_last"]
    recently = now < (qd["next_drop"] + 16 * INTERVAL_NS)
    new_count = torch.where(recently & (delta > 1), delta, 1).to(torch.int32)
    qd["drop_mode"] = torch.where(trans, True, dm)
    qd["drop_count"] = torch.where(trans, new_count, qd["drop_count"])
    qd["next_drop"] = torch.where(trans, control_law(new_count, now),
                                  qd["next_drop"])
    qd["drop_count_last"] = torch.where(trans, new_count,
                                        qd["drop_count_last"])
    return have, payload, dst, enq_ts
