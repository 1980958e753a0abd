"""Cross-host packet transit (the JAX package's ``net/link.py``).

One vectorized step over every sending host: the path's latency and
reliability, one per-host draw for the loss roll (none during bootstrap
and none for control packets), and one delivery emission.
"""

from __future__ import annotations

import torch

from shadow_tpu_torch.core import simtime
from shadow_tpu_torch.core.engine import Emitter, draw_uniform
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
    dst_host = torch.as_tensor(dst_host, device=dev).expand(H)
    if params.latency_vv.shape[0] == 1:
        lat = params.latency_vv[0, 0].expand(H)
        rel = params.reliability_vv[0, 0].expand(H)
    else:
        vs = state.host.vertex.to(torch.int64)
        table = params.vertex_g if params.vertex_g is not None \
            else state.host.vertex
        vd = table[dst_host.to(torch.int64)].to(torch.int64)
        lat = params.latency_vv[vs, vd]
        rel = params.reliability_vv[vs, vd]
    reachable = lat != simtime.NEVER
    roll_mask = mask & reachable
    state, u = draw_uniform(state, roll_mask)
    now = torch.as_tensor(now, dtype=torch.int64, device=dev)
    in_bootstrap = now < params.bootstrap_end
    size = torch.as_tensor(size_bytes, dtype=torch.int64, device=dev)
    is_control = control_mask if control_mask is not None else size == 0
    kept = in_bootstrap | is_control | (u < rel)
    emitter.emit(roll_mask & kept, now + lat, dst_host, kind, payload)
    state = pds_mod.record_drop(state, roll_mask & ~kept, payload,
                                pkt.PDS_DROPPED_LOSS, now)
    return state.add_counters(
        packets_sent=mask.sum(),
        packets_dropped_loss=(roll_mask & ~kept).sum(),
        packets_dropped_unreachable=(mask & ~reachable).sum(),
        bytes_sent=torch.where(mask, size, 0).sum(),
    )
