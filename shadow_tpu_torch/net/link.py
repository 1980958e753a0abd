"""Cross-host packet transit (the JAX package's ``net/link.py``).

One vectorized step over every sending host: the kernel ``link_send``
looks up each path's latency and reliability and rolls the loss with
one per-host draw (none during bootstrap and none for control packets);
the step then emits one delivery per kept packet and adds the counters.
"""

from __future__ import annotations

import torch

from shadow_tpu_torch.core.engine import Emitter
from shadow_tpu_torch.core.state import NetParams, SimState
from shadow_tpu_torch.net import packet as pkt
from shadow_tpu_torch.net import pds as pds_mod


def send(state: SimState, emitter: Emitter, mask, dst_host, now, kind,
         payload, params: NetParams, size_bytes, control_mask=None):
    """Send one packet per masked host to ``dst_host``, delivered at now +
    path latency unless the loss roll drops it. Control packets (zero
    payload length by default, or ``control_mask``) never drop. Returns
    the state with the counters and draw counters advanced."""
    H = mask.shape[0]
    dev = mask.device
    dst_host = torch.as_tensor(dst_host, device=dev).to(
        torch.int32).expand(H).contiguous()
    now = torch.as_tensor(now, dtype=torch.int64, device=dev)
    size = torch.as_tensor(size_bytes, dtype=torch.int64, device=dev)
    is_control = control_mask if control_mask is not None else size == 0
    h = state.host
    out = emitter.ops.link_send(
        mask.contiguous(), dst_host, now, is_control, h.vertex,
        params.vertex_g, params.latency_vv, params.reliability_vv,
        state.rng_keys, h.rng_counter, bootstrap_end=params.bootstrap_end,
    )
    state = state.with_host(rng_counter=out.rng_counter)
    emitter.emit(out.deliver, out.arrival, dst_host, kind, payload)
    state = pds_mod.record_drop(state, out.drop, payload,
                                pkt.PDS_DROPPED_LOSS, now)
    return state.add_counters(
        packets_sent=mask.sum(),
        packets_dropped_loss=out.drop.sum(),
        # rolled = delivered or dropped; the rest of the mask is unreachable
        packets_dropped_unreachable=(mask & ~(out.deliver | out.drop)).sum(),
        bytes_sent=torch.where(mask, size, 0).sum(),
    )
