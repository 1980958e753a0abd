"""Simulation state: struct-of-arrays tensor dataclasses.

The same layout as the JAX package's ``core/state.py``, held as plain
dataclasses of torch tensors on one device. Capacities are fixed when the
state is built:

    C  event-pool slots
    K  events extracted per host per window
    P  payload words per event (stored packed, ``core/soa.py``)

Time is int64 nanoseconds with ``simtime.NEVER`` marking a free pool slot.
JAX's uint32 fields (the per-host draw counter and the PRNG keys) are held
in int64 with values in [0, 2**32); every update masks with 0xFFFFFFFF so
they wrap exactly as the uint32 originals do.

The engine replaces fields with new tensors window by window; it never
writes into a tensor that a caller may still hold.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from shadow_tpu_torch.core import simtime, soa

PAYLOAD_WORDS = 12

# event kinds, numbered as in the JAX package
KIND_APP_MSG = 1  # app-level message delivery (PHOLD)
KIND_APP_TIMER = 2  # app-defined timer
KIND_PKT_DELIVER = 3  # packet arrives at the destination host
KIND_NIC_REFILL = 4  # the NIC receive pump (net/stack.py KIND_NIC_RECV)


def replace(obj, **fields):
    """A copy of the dataclass ``obj`` with ``fields`` replaced: a new
    object sharing every other field's tensor (``dataclasses.replace``
    without the re-run of ``__init__``, which the micro-step loop would
    pay tens of thousands of times a run)."""
    new = object.__new__(type(obj))
    new.__dict__ = {**obj.__dict__, **fields}
    return new


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another. ``None`` means ``"cuda"``; asking for the card where there is
    none raises instead of falling back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU"
        )
    return dev


@dataclasses.dataclass
class EventPool:
    """Pending events, one row per slot; time == NEVER marks a free slot.
    The total order of events is (time, dst, src, seq)."""

    time: torch.Tensor  # [C] int64 ns
    dst: torch.Tensor  # [C] int32
    src: torch.Tensor  # [C] int32
    seq: torch.Tensor  # [C] int32
    kind: torch.Tensor  # [C] int32
    payload: torch.Tensor  # [C, ceil(P/2)] int64, packed

    @classmethod
    def empty(cls, capacity: int, payload_words: int = PAYLOAD_WORDS,
              device=None) -> "EventPool":
        z32 = lambda: torch.zeros(capacity, dtype=torch.int32,  # noqa: E731
                                  device=device)
        return cls(
            time=torch.full((capacity,), simtime.NEVER, dtype=torch.int64,
                            device=device),
            dst=z32(), src=z32(), seq=z32(), kind=z32(),
            payload=torch.zeros((capacity, soa.packed_words(payload_words)),
                                dtype=torch.int64, device=device),
        )

    @property
    def capacity(self) -> int:
        return self.time.shape[0]


@dataclasses.dataclass
class Counters:
    """Run counters, int64 scalars; the field names are the JAX package's."""

    events_committed: torch.Tensor
    events_emitted: torch.Tensor
    packets_sent: torch.Tensor
    packets_delivered: torch.Tensor
    packets_dropped_loss: torch.Tensor
    packets_dropped_unreachable: torch.Tensor
    pool_overflow_dropped: torch.Tensor
    outbox_overflow_dropped: torch.Tensor
    inbox_overflow_deferred: torch.Tensor
    outbox_stall_deferred: torch.Tensor
    micro_steps: torch.Tensor
    bytes_sent: torch.Tensor
    bytes_delivered: torch.Tensor
    bulk_contract_violations: torch.Tensor
    cpu_delay_applied: torch.Tensor
    exchange_sent: torch.Tensor
    exchange_deferred: torch.Tensor

    @classmethod
    def zeros(cls, device=None) -> "Counters":
        return cls(**{
            f.name: torch.zeros((), dtype=torch.int64, device=device)
            for f in dataclasses.fields(cls)
        })


@dataclasses.dataclass
class HostState:
    """Per-host scalars the engine needs, [H] each."""

    seq_next: torch.Tensor  # int32: next per-source sequence number
    rng_counter: torch.Tensor  # int64 holding uint32: per-host draw counter
    vertex: torch.Tensor  # int32: vertex in the baked topology
    gid: torch.Tensor  # int32: global host id of each row
    done_t: torch.Tensor  # int64: max event time processed (-1 = none)
    cpu_cost: torch.Tensor  # int64: CPU model cost per event (0 = off)
    cpu_avail: torch.Tensor  # int64: CPU model next-free time


@dataclasses.dataclass
class NetParams:
    """The baked network model."""

    latency_vv: torch.Tensor  # [U, U] int64 ns; NEVER = unreachable
    reliability_vv: torch.Tensor  # [U, U] float32
    bootstrap_end: int  # ns: no loss rolls before this time
    # global host → vertex table; None on single-vertex topologies, where
    # every lookup is the one [0, 0] entry
    vertex_g: torch.Tensor | None = None


@dataclasses.dataclass
class SimState:
    """Everything a window step reads and writes. ``obs`` is the telemetry
    block (``obs/counters.py``); ``subs`` holds app sub-states by name."""

    now: int  # ns: the current window start
    pool: EventPool
    host: HostState
    counters: Counters
    rng_keys: torch.Tensor  # [H, 2] int64 holding uint32 key words
    subs: dict = dataclasses.field(default_factory=dict)
    obs: object = None

    # The loop path's handlers update the state functionally, as the JAX
    # package's do: each helper returns a new SimState and leaves this one
    # (and every tensor it holds) as it was.

    def replace(self, **fields) -> "SimState":
        return replace(self, **fields)

    def with_sub(self, key: str, value) -> "SimState":
        subs = dict(self.subs)
        subs[key] = value
        return replace(self, subs=subs)

    def with_host(self, **fields) -> "SimState":
        return replace(self, host=replace(self.host, **fields))

    def add_counters(self, **deltas) -> "SimState":
        """Add each delta (an int64 scalar tensor) to its counter."""
        c = self.counters
        return replace(self, counters=replace(
            c, **{k: getattr(c, k) + v for k, v in deltas.items()}))

    def detached_copy(self) -> "SimState":
        """A copy whose containers (host, counters, obs, subs and each
        sub-state) are new objects sharing this state's tensors: what a
        handler does to the copy's fields leaves this state as it was."""
        def sub(v):
            if isinstance(v, dict):
                return dict(v)
            return replace(v) if dataclasses.is_dataclass(v) else v
        return replace(
            self, host=replace(self.host), counters=replace(self.counters),
            obs=None if self.obs is None else replace(self.obs),
            subs={k: sub(v) for k, v in self.subs.items()},
        )


def make_host_state(num_hosts: int, host_vertex: np.ndarray,
                    device=None) -> HostState:
    H = num_hosts
    return HostState(
        seq_next=torch.zeros(H, dtype=torch.int32, device=device),
        rng_counter=torch.zeros(H, dtype=torch.int64, device=device),
        vertex=torch.as_tensor(np.asarray(host_vertex), dtype=torch.int32,
                               device=device),
        gid=torch.arange(H, dtype=torch.int32, device=device),
        done_t=torch.full((H,), -1, dtype=torch.int64, device=device),
        cpu_cost=torch.zeros(H, dtype=torch.int64, device=device),
        cpu_avail=torch.zeros(H, dtype=torch.int64, device=device),
    )
