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

An islands state (``parallel/islands.py``: the pool [S, C_shard]) travels
in the JAX package's islands layout and shapes: ``pool.*`` as
[S, C_shard], every host-indexed leaf (``host.*``, ``rng_keys``, the obs
block's host rows, a sub-state's host rows) as [S, Hl, ...] where the
port holds it as [H, ...], ``counters.*``, ``xmit_min`` and
``exch_deferred_min`` (a path only islands states have: the global
engine's is NEVER) as [S], ``now`` as [S] and ``obs.win`` as
[S, NUM_WIN].
This module imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from shadow_tpu_torch.core.simtime import NEVER
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
from shadow_tpu_torch.parallel import islands as islands_mod

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
    if _islands(state):
        paths.append("exch_deferred_min")
    for name, cls in _GROUPS:
        paths += [f"{name}.{f.name}" for f in dataclasses.fields(cls)]
    for sub, d in state.subs.items():
        keys = ([f.name for f in dataclasses.fields(d)]
                if dataclasses.is_dataclass(d) else list(d))
        paths += [f"subs.{sub}.{k}" for k in keys]
    return paths


# the host-indexed paths of an islands state ([H, ...] in the port)
_HOST_ROWS = ("host.", "rng_keys", "obs.host_", "subs.")


def _islands(state: SimState) -> bool:
    """An islands state: its pool is [S, C_shard]. (The global engine's
    ``exch_deferred_min``, always NEVER, is no path of its state.)"""
    return state.pool.time.dim() == 2


def state_to_numpy(state: SimState) -> dict[str, np.ndarray]:
    out = {}
    islands = _islands(state)
    S, H = state.shards, state.host.gid.shape[0]
    for path in state_paths(state):
        obj = state
        for part in path.split("."):
            obj = obj[part] if isinstance(obj, dict) else getattr(obj, part)
        a = obj.cpu().numpy() if isinstance(obj, torch.Tensor) else (
            np.asarray(obj, dtype=np.int64))
        if islands:
            if path == "now":
                a = np.full((S,), a, np.int64)
            elif path.startswith(_HOST_ROWS) and not (
                    path.startswith("subs.") and a.shape == (S,) != (H,)):
                a = islands_mod._split_host_leaf(a, S, H)
        out[path] = a.astype(np.uint32) if path in UINT32_PATHS else a
    return out


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.as_tensor(a.copy(), device=device)


def state_from_numpy(arrays: dict, device=None) -> SimState:
    """A ``SimState`` on ``device`` from the paths ``state_to_numpy``
    writes; every group field must be present. Arrays in the islands
    layout (with ``exch_deferred_min``) make an islands state."""
    if "exch_deferred_min" in arrays:
        shape = np.shape(arrays["host.gid"])
        arrays = {
            p: (islands_mod.deislandize_host_array(a)
                if p.startswith(_HOST_ROWS) and np.shape(a)[:2] == shape
                else a)
            for p, a in arrays.items()}
        arrays["now"] = np.asarray(arrays["now"]).max()
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
        exch_deferred_min=_tensor(
            arrays.get("exch_deferred_min", np.int64(NEVER)), device),
        subs=subs,
        **groups,
    )
