"""Device counter block: fixed-layout int64 telemetry carried in SimState.

The layout is the JAX package's ``obs/counters.py`` (block version 4): one
``[NUM_WIN]`` window-plane row plus per-host rows of committed events,
the committed virtual-time frontier and the audit digest. It is read only
through ``snapshot()``, one device-to-host copy per read.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

BLOCK_VERSION = 4

WIN_WINDOWS = 0
WIN_MATRIX = 1
WIN_LOOP = 2
WIN_SHRINKS = 3
WIN_ROLLBACKS = 4
WIN_OPT_STALLS = 5
WIN_SPILL_FIRES = 6
WIN_GEAR_SHIFTS = 7
WIN_FAULTS = 8
NUM_WIN = 9

WIN_NAMES = (
    "windows_run",
    "matrix_dispatches",
    "loop_dispatches",
    "window_shrinks",
    "rollbacks",
    "opt_stalls",
    "spill_fires",
    "gear_shifts",
    "fault_actions",
)


def win_bump_vec(*indices: int, device=None) -> torch.Tensor:
    """[NUM_WIN] int64 with 1 at each index: a step bumps several slots
    with one add."""
    v = torch.zeros(NUM_WIN, dtype=torch.int64)
    for i in indices:
        v[i] = 1
    return v.to(device)


@dataclasses.dataclass
class ObsBlock:
    win: torch.Tensor  # [NUM_WIN] int64 window-plane counters
    host_events: torch.Tensor  # [H] int64 committed events per host
    host_last_t: torch.Tensor  # [H] int64 max committed time, -1 = none
    host_digest: torch.Tensor  # [H] int64 audit chain (obs/audit.py)

    @classmethod
    def zeros(cls, num_hosts: int, device=None) -> "ObsBlock":
        return cls(
            win=torch.zeros(NUM_WIN, dtype=torch.int64, device=device),
            host_events=torch.zeros(num_hosts, dtype=torch.int64,
                                    device=device),
            host_last_t=torch.full((num_hosts,), -1, dtype=torch.int64,
                                   device=device),
            host_digest=torch.zeros(num_hosts, dtype=torch.int64,
                                    device=device),
        )


def snapshot(state) -> dict:
    """The block as host numpy, host rows in global host-id order; {} when
    the state carries no block."""
    if state.obs is None:
        return {}
    blk = state.obs
    gid = state.host.gid.cpu().numpy().astype(np.int64)

    def by_gid(t):
        a = t.cpu().numpy()
        out = np.empty_like(a)
        out[gid] = a
        return out

    win = blk.win.cpu().numpy()
    return {
        "block_version": BLOCK_VERSION,
        "win": {name: int(win[i]) for i, name in enumerate(WIN_NAMES)},
        "host_events": by_gid(blk.host_events),
        "host_last_t": by_gid(blk.host_last_t),
        "host_digest": by_gid(blk.host_digest),
    }
