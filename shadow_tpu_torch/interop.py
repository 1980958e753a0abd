"""State carried between the two packages as plain numpy arrays.

``state_to_numpy`` flattens a port ``SimState`` into ``{path: array}``
with paths like ``pool.time``, ``host.rng_counter``,
``counters.events_committed``, ``obs.host_digest``, ``rng_keys``,
``xmit_min`` (the speculation-violation signal),
``subs.phold.received`` (an app's dict sub-state) and ``subs.nic.tx_rem``
(a network sub-state: ``nic``, ``router``, ``udp``, ``tcp``, and
``qdisc`` under the JAX package's dict keys, e.g. ``subs.qdisc.q_rank``);
``state_from_numpy`` builds a ``SimState`` from such a dict on a device.
The JAX package's state has the same field names, so a test flattens it
by the same paths and the two dicts compare key by key. The uint32
fields of the JAX package (``host.rng_counter``, ``rng_keys``) travel as
uint32 and live in int64 on the port's side.
This module imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from shadow_tpu_torch.core.state import (
    Counters,
    EventPool,
    HostState,
    SimState,
)
from shadow_tpu_torch.net import codel, nic, tcp, udp
from shadow_tpu_torch.net import qdisc
from shadow_tpu_torch.net.qdisc import pifo
from shadow_tpu_torch.obs.counters import ObsBlock

UINT32_PATHS = ("host.rng_counter", "rng_keys")
_GROUPS = (("pool", EventPool), ("host", HostState),
           ("counters", Counters), ("obs", ObsBlock))
# the constructors of the sub-states held as dataclasses, by sub name;
# every other sub is a dict (the qdisc plane's class follows its fields)
SUB_CLASSES = {nic.SUB: nic.NicState, codel.SUB: codel.RouterState,
               udp.SUB: udp.UdpState, tcp.SUB: tcp.TcpState,
               qdisc.SUB: pifo.make_state}


def state_paths(state: SimState) -> list[str]:
    """Every path ``state_to_numpy`` writes for this state."""
    paths = ["now", "rng_keys", "xmit_min"]
    for name, cls in _GROUPS:
        paths += [f"{name}.{f.name}" for f in dataclasses.fields(cls)]
    for sub, d in state.subs.items():
        keys = ([f.name for f in dataclasses.fields(d)]
                if dataclasses.is_dataclass(d) else list(d))
        paths += [f"subs.{sub}.{k}" for k in keys]
    return paths


def state_to_numpy(state: SimState) -> dict[str, np.ndarray]:
    out = {}
    for path in state_paths(state):
        obj = state
        for part in path.split("."):
            obj = obj[part] if isinstance(obj, dict) else getattr(obj, part)
        a = obj.cpu().numpy() if isinstance(obj, torch.Tensor) else (
            np.asarray(obj, dtype=np.int64))
        out[path] = a.astype(np.uint32) if path in UINT32_PATHS else a
    return out


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.as_tensor(a.copy(), device=device)


def state_from_numpy(arrays: dict, device=None) -> SimState:
    """A ``SimState`` on ``device`` from the paths ``state_to_numpy``
    writes; every group field must be present."""
    groups = {}
    for name, cls in _GROUPS:
        groups[name] = cls(**{
            f.name: _tensor(arrays[f"{name}.{f.name}"], device)
            for f in dataclasses.fields(cls)
        })
    subs: dict = {}
    for path, a in arrays.items():
        if path.startswith("subs."):
            _, sub, key = path.split(".", 2)
            subs.setdefault(sub, {})[key] = _tensor(a, device)
    for sub, cls in SUB_CLASSES.items():
        if sub in subs:
            subs[sub] = cls(**subs[sub])
    return SimState(
        now=int(np.asarray(arrays["now"])),
        rng_keys=_tensor(arrays["rng_keys"], device),
        xmit_min=_tensor(arrays["xmit_min"], device),
        subs=subs,
        **groups,
    )
