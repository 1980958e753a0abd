"""Per-packet delivery-status registers (the JAX package's ``net/pds.py``).

The registers live in a ``pds`` sub-state that only simulations built
with ``experimental.packet_trails`` carry; the port refuses that option,
so both recorders are the identity here, as the JAX package's are
without the sub.
"""

from __future__ import annotations

SUB = "pds"


def record_drop(state, mask, payload, cause, now):
    if SUB in state.subs:
        raise NotImplementedError("packet_trails are not ported to "
                                  "shadow_tpu_torch yet (ROADMAP.md queue "
                                  "A 7)")
    return state


def record_delivery(state, mask, payload, now):
    if SUB in state.subs:
        raise NotImplementedError("packet_trails are not ported to "
                                  "shadow_tpu_torch yet (ROADMAP.md queue "
                                  "A 7)")
    return state
