"""The islands engine on one card: per-shard event pools and a bounded
exchange.

This is the JAX package's ``parallel/islands.py`` in ``island_mode:
vmap``. The host axis splits into S contiguous blocks ("islands") of
Hl = H / S hosts; each owns an event pool of C_shard rows, the shards a
leading dim of the pool ([S, C_shard]). A window is one matrix step over
every shard at once (``IslandSimulation.step``):

1. EXTRACT: ``window_sort`` and ``extract_slots`` with the shard dim:
   each shard's window keyed on its shard-local row, so a row deferred to
   another shard stays in the tail; the dense window is [H, K] in global
   host order, because the block layout flattened is the global one.
2. FORWARD and COMMIT: ``phold_forward`` and ``audit_commit`` once over
   the flattened window, as on the global engine.
3. ROUTE (kernel ``island_route``, the JAX package's ``_island_route``):
   each shard's candidates (its tail, then its hosts' emissions) split
   into X rows sent to each other shard, written straight into that
   shard's pool tail (the all_to_all is a transpose on one card), and
   the rest, kept up to C_keep = C_shard − S·X; the rows of a foreign
   shard that missed the exchange stay, deferred, and the earliest of
   them clamps the next window's end.

No speculation check runs (conservative islands leave ``xmit_min``
NEVER), and the window plane counts each window once (shard 0's row).
Counters are [S] rows, one a shard, summed when read.

The barrier driver (``run`` under ``async_islands: false``, and
``run_stepwise``, the same loop) is a host loop with one device read a
window: the window starts at the earliest pool row over all shards and
ends at min(start + runahead, stop, the earliest deferred row), and it
raises ``PoolExhausted`` where a shard's occupancy reaches its spill
mark (the JAX package spills there). The layout functions
(``islandize_state``, ``globalize_state``) work in numpy on the host.

Not ported here (``ROADMAP.md`` queue A 9): the async driver and
``lookahead.py``, the loop path under islands, optimistic islands, the
balancer, rebalancing, min-cut placement and several cards
(``shard_map``); pool gears are A 6.
"""

from __future__ import annotations

import numpy as np
import torch

from shadow_tpu_torch.core import simtime
from shadow_tpu_torch.core import state as state_mod
from shadow_tpu_torch.core.engine import (
    IslandSpec,
    PoolExhausted,
    Simulation,
    dense_extract,
    red_zone,
)
from shadow_tpu_torch.core.state import Counters, EventPool, SimState
from shadow_tpu_torch.obs import counters as obs_mod

AXIS = "islands"
NEVER = simtime.NEVER


def _refuse(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to shadow_tpu_torch yet (ROADMAP.md queue "
        f"A 9, {item})")


# ---------------------------------------------------------------------------
# State layout: the global state and the islands layout
# ---------------------------------------------------------------------------


def _np(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _split_host_leaf(x, S: int, H: int) -> np.ndarray:
    """[H, ...] → [S, H/S, ...]; a scalar → [S] with shard 0 holding it
    (summed when read, so counts stay exact)."""
    x = _np(x)
    if x.ndim >= 1 and x.shape[0] == H:
        return x.reshape((S, H // S) + x.shape[1:])
    if x.ndim == 0:
        z = np.zeros((S,), x.dtype)
        z[0] = x
        return z
    raise ValueError(
        f"sub-state leaf with shape {x.shape} is neither [H]-leading nor "
        f"scalar; the islands layout cannot place it")


def deislandize_host_array(x) -> np.ndarray:
    """[S, H/S, ...] → [H, ...]."""
    x = _np(x)
    return x.reshape((x.shape[0] * x.shape[1],) + x.shape[2:])


def _sub_to_shards(v, S: int, H: int, dev):
    """A sub-state in the islands layout: [H]-leading leaves stay flat
    (the block layout flattened is the global one), scalars become [S]
    rows with shard 0 holding them."""
    if isinstance(v, dict):
        return {k: _sub_to_shards(x, S, H, dev) for k, x in v.items()}
    if isinstance(v, torch.Tensor):
        if v.dim() >= 1 and v.shape[0] == H:
            return v
        # a scalar as its [S] row, or the refusal of any other shape
        return torch.as_tensor(_split_host_leaf(v, S, H), device=dev)
    raise ValueError(f"the islands layout takes dict sub-states of "
                     f"tensors, got {type(v).__name__}")


def islandize_state(state: SimState, S: int, C_shard: int) -> SimState:
    """A built global state in the islands layout: each live pool row in
    its destination's shard pool ([S, C_shard], in its global pool
    order), counters and the window plane as [S] rows with shard 0
    holding the value, ``xmit_min`` and ``exch_deferred_min`` a row of
    NEVER. Host rows stay [H]: shard s's are s·Hl to (s + 1)·Hl − 1,
    which ``interop`` carries as the JAX package's [S, Hl, ...]."""
    H = state.host.gid.shape[0]
    if H % S:
        raise ValueError(f"num_hosts {H} must divide by num_shards {S}")
    Hl = H // S
    dev = state.pool.time.device
    pool = state.pool
    pt, pd = _np(pool.time), _np(pool.dst)
    cols = [_np(c) for c in (pool.dst, pool.src, pool.seq, pool.kind,
                             pool.payload)]
    live = pt != NEVER
    t = np.full((S, C_shard), NEVER, np.int64)
    out = [np.zeros((S, C_shard) + c.shape[1:], c.dtype) for c in cols]
    for sh in range(S):
        rows = np.where(live & (pd // Hl == sh))[0]
        if len(rows) > C_shard:
            raise ValueError(
                f"shard {sh} initial events ({len(rows)}) exceed per-shard "
                f"pool capacity {C_shard}")
        n = len(rows)
        t[sh, :n] = pt[rows]
        for o, c in zip(out, cols):
            o[sh, :n] = c[rows]
    t_d = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    new_pool = EventPool(time=t_d(t), dst=t_d(out[0]), src=t_d(out[1]),
                         seq=t_d(out[2]), kind=t_d(out[3]),
                         payload=t_d(out[4]))
    counters = Counters(**{
        k: torch.as_tensor(_split_host_leaf(v, S, H), device=dev)
        for k, v in vars(state.counters).items()})
    obs = state.obs
    win = np.zeros((S,) + tuple(obs.win.shape), np.int64)
    win[0] = _np(obs.win)
    never = torch.full((S,), NEVER, dtype=torch.int64, device=dev)
    return state.replace(
        pool=new_pool, counters=counters,
        obs=state_mod.replace(obs, win=t_d(win)),
        subs={k: _sub_to_shards(v, S, H, dev)
              for k, v in state.subs.items()},
        xmit_min=never.clone(), exch_deferred_min=never.clone(),
    )


def globalize_state(state: SimState, pool_capacity: int) -> SimState:
    """The islands layout back to the global one (the JAX package's
    checkpoint seam): live pool rows compacted into one pool of
    ``pool_capacity`` rows in full event-key order (time, dst, src,
    seq), counters, sub-state rows and the window plane summed over the
    shards, ``xmit_min`` the earliest, and no deferral clamp (in one
    pool no row is in transit). Host rows are in global order already
    (block placement)."""
    S = state.shards
    dev = state.pool.time.device
    pool = state.pool
    pt = _np(pool.time).reshape(-1)
    cols = [_np(c).reshape((-1,) + tuple(c.shape[2:]))
            for c in (pool.dst, pool.src, pool.seq, pool.kind,
                      pool.payload)]
    live = np.flatnonzero(pt != NEVER)
    if live.shape[0] > pool_capacity:
        raise ValueError(
            f"{live.shape[0]} live pool rows exceed the target pool "
            f"capacity {pool_capacity}; raise experimental.event_capacity "
            f"on the resuming build")
    order = live[np.lexsort((cols[2][live], cols[1][live], cols[0][live],
                             pt[live]))]
    C = int(pool_capacity)
    n = order.shape[0]
    t = np.full((C,), NEVER, np.int64)
    t[:n] = pt[order]
    out = []
    for c in cols:
        buf = np.zeros((C,) + c.shape[1:], c.dtype)
        buf[:n] = c[order]
        out.append(torch.as_tensor(buf, device=dev))
    H = state.host.gid.shape[0]
    summed = lambda x: torch.as_tensor(_np(x).sum(axis=0),  # noqa: E731
                                       device=dev)

    def sub(v):
        """[S] rows summed (islandize's scalars); host rows as they are."""
        if isinstance(v, dict):
            return {k: sub(x) for k, x in v.items()}
        return summed(v) if tuple(v.shape) == (S,) and S != H else v

    return state.replace(
        pool=EventPool(time=torch.as_tensor(t, device=dev), dst=out[0],
                       src=out[1], seq=out[2], kind=out[3],
                       payload=out[4]),
        counters=Counters(**{k: summed(v)
                             for k, v in vars(state.counters).items()}),
        obs=state_mod.replace(state.obs, win=summed(state.obs.win)),
        subs={k: sub(v) for k, v in state.subs.items()},
        xmit_min=torch.as_tensor(_np(state.xmit_min).min(), device=dev),
        exch_deferred_min=torch.full((), NEVER, dtype=torch.int64,
                                     device=dev),
    )


# ---------------------------------------------------------------------------
# Runner
# ---------------------------------------------------------------------------


class IslandSimulation(Simulation):
    """A ``Simulation`` whose window step runs as S islands on one card.

    Takes every ``Simulation`` argument plus the JAX package's:
    ``num_shards`` (S, dividing num_hosts); ``exchange_slots`` (X rows a
    pair of shards a window; 0 sizes it from the capacity C as
    max(64, C // (2·S²))); ``mode`` ("vmap"; "shard_map" is refused);
    ``force_path`` ("matrix": the only path ported under islands);
    ``async_sync`` (the JAX package's default, true, makes ``run()``
    take the async driver, which is refused here; ``run_stepwise()``
    never takes it). Each shard's pool holds ⌈C/S⌉ + S·X rows; its spill
    mark is C_keep − red_zone(C_shard), C_keep = C_shard − S·X."""

    def __init__(self, *, num_shards: int, exchange_slots: int = 0,
                 mode: str = "vmap", force_path: str | None = None,
                 rebalance: bool = False, pool_gears: int = 1,
                 async_sync: bool = True, balancer: bool = False,
                 placement: str = "block", exclude_chips: tuple = (),
                 **kw):
        if mode not in ("vmap", "shard_map"):
            raise ValueError(f"unknown islands mode {mode!r}")
        if placement not in ("block", "min_cut"):
            raise ValueError(f"unknown islands placement {placement!r}")
        if mode == "shard_map":
            raise _refuse("islands over several cards (island_mode: "
                          "shard_map)", "balancer and mesh")
        if rebalance or balancer or placement == "min_cut" or exclude_chips:
            raise _refuse("rebalancing, the balancer, min_cut placement "
                          "and exclude_chips", "balancer and mesh")
        if int(pool_gears) != 1:
            raise NotImplementedError(
                "pool gears (pool_gears != 1) are not ported to "
                "shadow_tpu_torch yet (ROADMAP.md queue A 6)")
        S = int(num_shards)
        H = kw["num_hosts"]
        if S < 1 or H % S:
            raise ValueError(f"num_hosts {H} must divide by num_shards {S}")
        C = kw.get("event_capacity", 1 << 14)
        if exchange_slots <= 0:
            # the JAX package's sizing from the expected cross-shard rows
            exchange_slots = max(64, C // (2 * S * S))
        X = int(exchange_slots)
        C_shard = (C + S - 1) // S + S * X
        if S > 1 and C_shard >= C:
            raise ValueError(
                f"islands sizing defeats itself: per-shard pool "
                f"{C_shard} (= capacity/{S} + {S}x{X} exchange block) is "
                f"not smaller than the global pool {C}, so per-shard sort "
                f"volume would exceed the single-pool engine's — the S× "
                f"locality win inverts. Lower exchange_slots (misses defer "
                f"safely) or raise event_capacity.")
        super().__init__(**kw, _force_path=force_path)
        if self.matrix_handler is None or force_path != "matrix":
            raise _refuse("the micro-step loop path under islands (a sim "
                          "without the matrix path, or force_path not "
                          "'matrix')", "the loop path")
        if self.with_cpu:
            raise _refuse("the CPU model under islands", "the loop path")
        self.spec = IslandSpec(AXIS, S, X).check()
        self._C_shard = C_shard
        self.hi = self.island_marks(C_shard)
        self._async = bool(async_sync)
        self.state = islandize_state(self.state, S, C_shard)
        bump = torch.zeros((S, obs_mod.NUM_WIN), dtype=torch.int64,
                           device=self.device)
        bump[0] = self._win_bump  # the window plane: shard 0's row
        self._win_bump = bump
        self.windows_run = 0

    @property
    def num_shards(self) -> int:
        return self.spec.num_shards

    @property
    def exchange_slots(self) -> int:
        return self.spec.exchange_slots

    def island_marks(self, C_s: int) -> int:
        """The spill mark of a shard's pool of ``C_s`` rows: the merge
        keeps C_keep = C_s − S·X rows (the exchange block fills the
        rest), so pressure fires below C_keep (one gear: the JAX
        package's ``island_marks``)."""
        keep = C_s - self.num_shards * self.exchange_slots
        hi = keep - red_zone(C_s)
        if hi <= 0:
            raise ValueError(
                "per-shard pool too small for its exchange block + red "
                "zone; raise event_capacity or lower exchange_slots")
        return hi

    # -- the islands window step: the matrix step with the shard dim --

    def _extract(self, pool: EventPool, win_start: int, win_end: int):
        return dense_extract(pool, win_start, win_end, self.num_hosts,
                             self.K, self.ops, self.num_shards)

    def _check_speculation(self, state: SimState, fw, done_t) -> None:
        """Conservative islands run no speculation check (the JAX
        package's ``island is None or island.optimistic``): ``xmit_min``
        stays NEVER."""

    def _merge(self, state: SimState, tail, fw, win_start: int) -> None:
        """The next pools through the bounded exchange
        (``island_route``)."""
        r = self.ops.island_route(
            tail, fw, shards=self.num_shards,
            exchange_slots=self.exchange_slots, num_hosts=self.num_hosts,
            capacity=self._C_shard, win_start=win_start)
        state.pool = EventPool(time=r.time, dst=r.dst, src=r.src,
                               seq=r.seq, kind=r.kind, payload=r.payload)
        c = state.counters
        c.pool_overflow_dropped = c.pool_overflow_dropped + r.stats[:, 0]
        c.exchange_sent = c.exchange_sent + r.stats[:, 1]
        c.exchange_deferred = c.exchange_deferred + r.stats[:, 2]
        state.exch_deferred_min = r.stats[:, 3]

    # -- the barrier driver --

    def _island_frontier(self) -> tuple[int, int, int]:
        """One device read between windows: the earliest pool row over
        every shard, the fullest shard's occupancy and the earliest
        deferred row (the JAX package's pmin, pmax and deferral
        clamp)."""
        t = self.state.pool.time
        vals = torch.stack([t.min(), (t != NEVER).sum(dim=1).max(),
                            self.state.exch_deferred_min.min()])
        mn, occ, clamp = vals.tolist()
        return mn, occ, clamp

    def run(self, until: int | None = None) -> int:
        """The barrier driver (``async_islands: false``): returns the
        windows run. Under the JAX package's default, async islands,
        its ``run()`` takes the async driver, which is not ported: this
        raises rather than run other windows than the JAX package's."""
        if self._async:
            raise _refuse(
                "run() under async_islands: true (the async driver, "
                "parallel/lookahead.py); set experimental.async_islands: "
                "false, or call run_stepwise()", "the async driver")
        return super().run(until)

    def run_stepwise(self, until: int | None = None) -> int:
        """One window a step, the JAX package's ``run_stepwise`` (it never
        takes the async driver): the barrier loop. Returns the windows
        run."""
        with torch.inference_mode():
            return self._run(until)

    def _run(self, until: int | None) -> int:
        stop = self.stop_time if until is None else min(until,
                                                        self.stop_time)
        windows = 0
        mn, occ, clamp = self._island_frontier()
        while mn < stop:
            if occ >= self.hi:
                raise PoolExhausted(
                    f"a shard's pool occupancy {occ} reached its spill mark "
                    f"{self.hi} (pool {self._C_shard} rows a shard, "
                    f"{self.num_shards * self.exchange_slots} of them the "
                    f"exchange block) at t={mn}; the spill tier is not "
                    f"ported (ROADMAP.md queue A 6): raise "
                    f"experimental.event_capacity")
            # no shard runs past a row still in transit
            self.step(mn, max(mn, min(mn + self.runahead, stop, clamp)))
            windows += 1
            self.windows_run += 1
            mn, occ, clamp = self._island_frontier()
        return windows

    def run_optimistic(self, *args, **kwargs):
        raise _refuse("run_optimistic() under islands",
                      "optimistic islands")

    def suggest_exchange_slots(self) -> dict[str, int | float]:
        """The JAX package's X suggestion from this run's exchange
        traffic: twice the average rows a pair of shards a window, at
        least 64 (apply it by rebuilding)."""
        S = self.num_shards
        c = self.counters()
        sent, deferred = c["exchange_sent"], c["exchange_deferred"]
        w = max(self.windows_run, 1)
        avg = sent / (w * S * max(S - 1, 1))
        return {
            "exchange_slots": self.exchange_slots,
            "suggested": max(64, int(2 * avg) + 1),
            "avg_rows_per_pair_per_window": round(avg, 2),
            "windows": self.windows_run,
            "exchange_sent": sent,
            "exchange_deferred": deferred,
            "defer_ratio": round(deferred / max(sent + deferred, 1), 4),
        }

    def host_trackers(self):
        raise _refuse("host_trackers() under islands (no NIC app runs "
                      "there)", "the loop path")
