"""Simulated time as int64 nanoseconds.

Mirrors the reference's ``SimulationTime`` newtype (u64 ns,
src/main/core/support/simulation_time.rs) with the conventions the event
engine needs: an explicit "invalid/never" sentinel used as the empty-slot
marker in device-side event pools, and emulated-time epoch offset used when
reporting clock_gettime to managed processes.
"""

from __future__ import annotations

import numpy as np

NS_PER_US = 1_000
NS_PER_MS = 1_000_000
NS_PER_SEC = 1_000_000_000
NS_PER_MIN = 60 * NS_PER_SEC
NS_PER_HOUR = 3600 * NS_PER_SEC

# Empty-slot / "no event" sentinel. Max int64 so min-reductions naturally
# ignore empty slots (reference: EMUTIME_INVALID / SIMTIME_INVALID).
NEVER = np.iinfo(np.int64).max

# Unix-epoch offset reported to managed processes so that wall-clock syscalls
# (clock_gettime etc.) return plausible dates. The reference boots its
# simulation at an arbitrary fixed epoch; we use 2000-01-01T00:00:00Z.
EMULATED_EPOCH_NS = 946_684_800 * NS_PER_SEC

DTYPE = np.int64


def from_seconds(s: float) -> int:
    return int(round(s * NS_PER_SEC))


def from_millis(ms: float) -> int:
    return int(round(ms * NS_PER_MS))


def from_micros(us: float) -> int:
    return int(round(us * NS_PER_US))


def to_seconds(t: int) -> float:
    return t / NS_PER_SEC


def is_never(t) -> bool:
    return t == NEVER
