"""The PDES window step and simulation driver, matrix path.

This is the JAX package's ``core/engine.py`` for models whose every
in-window event has the bulk kind (PHOLD on an all-reachable topology):
each conservative window [ws, we) is processed in one pass over a dense
``[H, K]`` matrix of each host's earliest in-window events.

One window:

1. EXTRACT (``dense_extract``): a stable 2-key sort of the pool plus K
   filler rows per host on the packed keys ``run_key << 44 | dt`` and
   ``src << 32 | seq``; the kernel ``extract_slots`` ranks each row within
   its host run; a stable sort by dense slot lands the window as an
   ``[H, K]`` matrix and leaves every other row, in sorted order, as the
   tail.
2. FORWARD: the model's matrix handler (PHOLD: the kernel
   ``phold_forward``) emits one numbered row per dense cell.
3. COMMIT: the kernel ``audit_commit`` folds the window into the audit
   chain and the per-host counts and frontiers.
4. MERGE: a stable sort by time of tail ∪ emissions, truncated to the
   pool capacity; rows past it are counted as ``pool_overflow_dropped``.

The sorts are ``torch.sort(stable=True)``; a stable sort by k2 followed by
a stable sort by k1 is ``lax.sort(num_keys=2, is_stable=True)``. The
driver is a host loop with one device-to-host read per window, and it
reproduces ``make_run_to``'s window bounds exactly: ``ws = min(pool.time)``,
``we = min(ws + runahead, stop)``.

Not ported here (``ROADMAP.md``): the micro-step loop path, the CPU model,
islands, the optimistic driver, pool gears and the spill tier.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from shadow_tpu_torch import kernels
from shadow_tpu_torch.core import rng as rng_mod
from shadow_tpu_torch.core import simtime, soa
from shadow_tpu_torch.core.state import (
    PAYLOAD_WORDS,
    Counters,
    EventPool,
    NetParams,
    SimState,
    make_host_state,
    resolve_device,
)
from shadow_tpu_torch.obs import audit as audit_mod
from shadow_tpu_torch.obs import counters as obs_mod

NEVER = simtime.NEVER
DT_BITS = kernels.DT_BITS
DT_MAX = kernels.DT_MAX
M32 = rng_mod.M32


class DenseWindow(NamedTuple):
    """Each host's earliest Kc in-window events in (time, src, seq) order;
    cells past a host's events hold filler rows at time NEVER."""

    time: torch.Tensor  # [H, Kc] int64
    src: torch.Tensor  # [H, Kc] int32
    seq: torch.Tensor  # [H, Kc] int32
    kind: torch.Tensor  # [H, Kc] int32
    payload: torch.Tensor  # [H, Kc, PP] int64


class Tail(NamedTuple):
    """Every row not extracted, in the first sort's order: C rows."""

    time: torch.Tensor
    dst: torch.Tensor
    src: torch.Tensor
    seq: torch.Tensor
    kind: torch.Tensor
    payload: torch.Tensor  # [C, PP]


class PoolExhausted(RuntimeError):
    """Pool occupancy reached the spill mark, where the JAX package hands
    rows to its host spill tier, which the port does not have yet."""


def red_zone(capacity: int) -> int:
    """Rows above the spill mark (the JAX package's ``core/spill.py``)."""
    return max(min(64, capacity // 4), capacity // 8)


def window_keys(pool: EventPool, win_start: int, win_end: int, H: int,
                Kc: int):
    """The window's first sort. Returns (s_k1, perm): the sorted k1 keys of
    the C pool rows and H·Kc filler rows, and for each sorted position the
    row it came from (pool rows first, then fillers, host-major)."""
    C = pool.capacity
    N = C + H * Kc
    dev = pool.time.device
    inwin = (pool.time < win_end) & (pool.dst >= 0) & (pool.dst < H)
    run_key = torch.where(inwin, pool.dst.to(torch.int64), H)
    dt = (pool.time - win_start).clamp(0, DT_MAX)
    k1 = torch.empty(N, dtype=torch.int64, device=dev)
    k1[:C] = (run_key << DT_BITS) | dt
    hosts = torch.arange(H, dtype=torch.int64, device=dev)
    k1[C:] = ((hosts << DT_BITS) | DT_MAX).repeat_interleave(Kc)
    k2 = torch.zeros(N, dtype=torch.int64, device=dev)
    k2[:C] = (pool.src.to(torch.int64) << 32) | (
        pool.seq.to(torch.int64) & M32
    )
    p2 = torch.sort(k2, stable=True).indices
    s_k1, p1 = torch.sort(k1[p2], stable=True)
    return s_k1, p2[p1]


def dense_extract(pool: EventPool, win_start: int, win_end: int, H: int,
                  Kc: int, ops: kernels.WindowOps = kernels.KERNEL_OPS):
    """Extract the window [win_start, win_end) into a dense [H, Kc] matrix
    and the tail of every other row (the JAX package's ``_dense_extract``).
    Filler rows are time NEVER, dst = their host, src = seq = kind = 0 and
    a zero payload; those not extracted ride the tail in sorted order."""
    HK = H * Kc
    dev = pool.time.device
    s_k1, perm = window_keys(pool, win_start, win_end, H, Kc)
    slot = ops.extract_slots(s_k1, H, Kc)
    rows = perm[torch.sort(slot, stable=True).indices]

    def col(pool_col, filler):
        return torch.cat([pool_col, filler])[rows]

    z32 = torch.zeros(HK, dtype=torch.int32, device=dev)
    fill_dst = torch.arange(H, dtype=torch.int32,
                            device=dev).repeat_interleave(Kc)
    o_t = col(pool.time, torch.full((HK,), NEVER, dtype=torch.int64,
                                    device=dev))
    o_s = col(pool.src, z32)
    o_q = col(pool.seq, z32)
    o_k = col(pool.kind, z32)
    o_d = col(pool.dst, fill_dst)
    PP = pool.payload.shape[1]
    o_p = col(pool.payload, torch.zeros((HK, PP), dtype=torch.int64,
                                        device=dev))
    dense = DenseWindow(
        time=o_t[:HK].reshape(H, Kc), src=o_s[:HK].reshape(H, Kc),
        seq=o_q[:HK].reshape(H, Kc), kind=o_k[:HK].reshape(H, Kc),
        payload=o_p[:HK].reshape(H, Kc, PP),
    )
    tail = Tail(time=o_t[HK:], dst=o_d[HK:], src=o_s[HK:], seq=o_q[HK:],
                kind=o_k[HK:], payload=o_p[HK:])
    return dense, tail


def merge(tail: Tail, em, capacity: int):
    """The next pool: a stable sort by time of the tail then the emission
    rows (in that order: the sort's ties depend on it), truncated to
    ``capacity``. Returns (pool, rows dropped past capacity)."""
    m_t = torch.cat([tail.time, em.time])
    s_t, order = torch.sort(m_t, stable=True)
    keep = order[:capacity]

    def col(a, b):
        return torch.cat([a, b])[keep]

    pool = EventPool(
        time=s_t[:capacity],
        dst=col(tail.dst, em.dst), src=col(tail.src, em.src),
        seq=col(tail.seq, em.seq), kind=col(tail.kind, em.kind),
        payload=col(tail.payload, em.payload),
    )
    dropped = (s_t[capacity:] != NEVER).sum()
    return pool, dropped


# handler(state, dense, params, win_end, ops) -> kernels.ForwardOut
MatrixHandler = Callable[..., kernels.ForwardOut]


class Simulation:
    """Owns the state and plays the window loop on one device.

    Build it with ``shadow_tpu_torch.sim.build_simulation`` (or
    ``flagship.build_phold_flagship``), or directly for tests.
    ``device=None`` means the card; pass ``device="cpu"`` to run the plain
    versions on the CPU. ``ops`` selects the window functions: the kernel
    wrappers by default, ``kernels.PLAIN_OPS`` for the plain versions on
    any device."""

    def __init__(
        self,
        *,
        num_hosts: int,
        params: NetParams,
        host_vertex: np.ndarray,
        seed: int,
        stop_time: int,
        runahead: int,
        bulk_kind: int,
        matrix_handler: MatrixHandler,
        event_capacity: int = 1 << 14,
        K: int = 32,
        subs: dict | None = None,
        initial_events: list | None = None,
        payload_words: int = PAYLOAD_WORDS,
        device=None,
        ops: kernels.WindowOps = kernels.KERNEL_OPS,
    ):
        self.device = resolve_device(device)
        dev = self.device
        self.num_hosts = num_hosts
        self.stop_time = int(stop_time)
        self.runahead = int(runahead)
        if self.runahead <= 0:
            raise ValueError("runahead must be > 0 (min topology latency)")
        self.K = int(K)
        self.bulk_kind = int(bulk_kind)
        self.matrix_handler = matrix_handler
        self.ops = ops
        self.params = params
        n0 = len(initial_events or [])
        if n0 > event_capacity:
            raise ValueError("initial events exceed event pool capacity")
        # the occupancy at which the JAX package's fused loop exits to its
        # spill tier (core/spill.py marks); the port raises there instead
        self.hi = event_capacity - red_zone(event_capacity)
        pool = EventPool.empty(event_capacity, payload_words, device=dev)
        seq_init = np.zeros(num_hosts, dtype=np.int32)
        if initial_events:
            # per-source sequence numbers in list order
            seq_ctr: dict[int, int] = {}
            cols = {"t": [], "d": [], "s": [], "q": [], "k": [], "p": []}
            for (t, d, s, k, pl) in initial_events:
                q = seq_ctr.get(s, 0)
                seq_ctr[s] = q + 1
                row = list(pl) + [0] * (payload_words - len(pl))
                for key, v in zip("tdsqkp", (t, d, s, q, k,
                                             row[:payload_words])):
                    cols[key].append(v)
            pool.time[:n0] = torch.tensor(cols["t"], dtype=torch.int64)
            pool.dst[:n0] = torch.tensor(cols["d"], dtype=torch.int32)
            pool.src[:n0] = torch.tensor(cols["s"], dtype=torch.int32)
            pool.seq[:n0] = torch.tensor(cols["q"], dtype=torch.int32)
            pool.kind[:n0] = torch.tensor(cols["k"], dtype=torch.int32)
            pool.payload[:n0] = soa.pack_words(
                torch.tensor(cols["p"], dtype=torch.int32)
            ).to(dev)
            for s, q in seq_ctr.items():
                seq_init[s] = q
        host = make_host_state(num_hosts, host_vertex, device=dev)
        host.seq_next = torch.as_tensor(seq_init, device=dev)
        self.state = SimState(
            now=0,
            pool=pool,
            host=host,
            counters=Counters.zeros(dev),
            rng_keys=rng_mod.host_keys(seed, num_hosts, device=dev),
            subs=subs or {},
            obs=obs_mod.ObsBlock.zeros(num_hosts, dev),
        )
        self._win_bump = obs_mod.win_bump_vec(
            obs_mod.WIN_WINDOWS, obs_mod.WIN_MATRIX, device=dev
        )

    def _frontier(self, stop: int):
        """(min pool time, occupancy, whether the window that starts there
        holds an event of another kind than the bulk kind): one
        device-to-host read."""
        t = self.state.pool.time
        mn = t.min()
        we = torch.clamp(mn, max=stop - self.runahead) + self.runahead
        other = ((t < we) & (self.state.pool.kind != self.bulk_kind)).any()
        vals = torch.stack([mn, (t != NEVER).sum(), other.to(torch.int64)])
        mn, occ, other = vals.tolist()
        return mn, occ, bool(other)

    def step(self, win_start: int, win_end: int) -> None:
        """Process the window [win_start, win_end): extract, forward,
        commit, merge. State fields are replaced by new tensors; none is
        written into."""
        state, ops = self.state, self.ops
        state.now = int(win_start)
        dense, tail = dense_extract(state.pool, win_start, win_end,
                                    self.num_hosts, self.K, ops)
        fw = self.matrix_handler(state, dense, self.params, win_end, ops)
        ob = state.obs
        cm = ops.audit_commit(dense.time, dense.src, dense.kind,
                              state.host.gid, ob.host_digest,
                              ob.host_events, ob.host_last_t,
                              state.host.done_t)
        state.obs = obs_mod.ObsBlock(
            win=ob.win + self._win_bump, host_events=cm.host_events,
            host_last_t=cm.host_last_t, host_digest=cm.host_digest,
        )
        state.host.done_t = cm.done_t
        state.host.seq_next = fw.seq_next
        tot = fw.stats.sum(dim=0)  # received, sent, kept, violations
        c = state.counters
        c.events_committed = c.events_committed + cm.n_valid.sum()
        c.events_emitted = c.events_emitted + tot[2]
        c.bulk_contract_violations = c.bulk_contract_violations + tot[3]
        c.micro_steps = c.micro_steps + 1
        state.pool, dropped = merge(tail, fw, state.pool.capacity)
        c.pool_overflow_dropped = c.pool_overflow_dropped + dropped

    def run(self, until: int | None = None) -> int:
        """Advance until the earliest pending event is at or past ``until``
        (default: the stop time). Returns the number of windows run."""
        stop = self.stop_time if until is None else min(until,
                                                        self.stop_time)
        windows = 0
        mn, occ, other = self._frontier(stop)
        while mn < stop:
            if occ >= self.hi:
                raise PoolExhausted(
                    f"pool occupancy {occ} reached the spill mark "
                    f"{self.hi} of capacity {self.state.pool.capacity} at "
                    f"t={mn}; the spill tier is not ported (ROADMAP.md "
                    f"queue A 6): raise experimental.event_capacity"
                )
            if other:
                raise NotImplementedError(
                    f"the window at t={mn} holds a non-bulk event; the "
                    f"micro-step loop path is not ported (ROADMAP.md "
                    f"queue A 4)"
                )
            self.step(mn, min(mn + self.runahead, stop))
            windows += 1
            mn, occ, other = self._frontier(stop)
        return windows

    def counters(self) -> dict[str, int]:
        c = self.state.counters
        return {k: int(v) for k, v in sorted(vars(c).items())}

    def obs_snapshot(self) -> dict:
        return obs_mod.snapshot(self.state)

    def audit_chain(self) -> int:
        """The global digest chain: the order-independent combine of the
        per-host digests."""
        return audit_mod.combine(self.obs_snapshot()["host_digest"])
