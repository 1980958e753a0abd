"""The PDES window step and simulation driver.

This is the JAX package's ``core/engine.py``. Each conservative window
[ws, we) takes one of two paths, chosen per window as the JAX package
chooses it:

* the matrix path, where every in-window event has the bulk kind and the
  model has a matrix handler (PHOLD on an all-reachable topology): one
  pass over a dense ``[H, K]`` matrix of each host's earliest in-window
  events;
* the micro-step loop path for everything else (the network stack):
  each micro-step processes at most one event per host, plus a bulk batch
  of further same-kind events where the model allows it.

One matrix window:

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

One loop window (``Simulation.step_loop``): the same extraction with
Kc = K + 1 columns (column K only exposes each host's earliest deferred
key), then micro-steps until one commits nothing or ``max_iters`` is
reached. A micro-step is:

1. SELECT (kernel ``loop_select``): per host, the dense head at its cursor
   against its inbox minimum; the bulk batch; the outbox-room and
   pool-headroom gates.
2. COMMIT (kernel ``audit_commit`` on the taken events).
3. HANDLE: the handlers in ascending kind, the bulk kind's once per taken
   column; each emits records through an ``Emitter``.
4. ROUTE (kernel ``loop_route``): number the records in emit order; self
   emissions inside the window go to the inbox, the rest to the outbox.

The window ends with one merge of the unconsumed dense cells, the tail and
the boxes. The driver reads the device once a micro-step: how many hosts
committed (none ends the window) and which bulk columns any host took.
Every kind's handler runs each micro-step, as in the JAX package; the
bulk kind's handler skips a column no host took, as a handler called
with its mask all off changes nothing.

The sorts are ``torch.sort(stable=True)``; a stable sort by k2 followed by
a stable sort by k1 is ``lax.sort(num_keys=2, is_stable=True)``. The
driver is a host loop with one device-to-host read per window, and it
reproduces ``make_run_to``'s window bounds exactly: ``ws = min(pool.time)``,
``we = min(ws + runahead, stop)``.

Not ported here (``ROADMAP.md``): the CPU model, islands, the optimistic
driver, pool gears and the spill tier.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from shadow_tpu_torch import kernels
from shadow_tpu_torch.core import rng as rng_mod
from shadow_tpu_torch.core import simtime, soa
from shadow_tpu_torch.core import state as state_mod
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


# ---------------------------------------------------------------------------
# Event view and emission interface of the loop path's handlers
# ---------------------------------------------------------------------------


class EventView(NamedTuple):
    """The (at most one) event each host processes in a micro-step, [H]
    each; ``mask`` marks the hosts whose event this handler takes."""

    mask: torch.Tensor  # [H] bool
    time: torch.Tensor  # [H] int64
    src: torch.Tensor  # [H] int32
    seq: torch.Tensor  # [H] int32
    kind: torch.Tensor  # [H] int32
    payload: torch.Tensor  # [H, P] int32

    def replace(self, **fields) -> "EventView":
        return self._replace(**fields)


class Emission(NamedTuple):
    mask: torch.Tensor  # [H] bool: which hosts emit
    time: torch.Tensor  # [H] int64
    dst: torch.Tensor  # [H] int32
    kind: torch.Tensor  # [H] int32
    payload: torch.Tensor  # [H, P] int32


class Emitter:
    """Collects handler emissions; the engine routes them in collection
    order, which fixes the per-source sequence numbers. ``ops`` are the
    engine's window functions, for handlers that call a kernel."""

    def __init__(self, ops: kernels.WindowOps = kernels.KERNEL_OPS):
        self.records: list[Emission] = []
        self.ops = ops

    def emit(self, mask, time, dst, kind, payload) -> None:
        H = mask.shape[0]
        dev = mask.device

        def col(x, dtype):
            return torch.as_tensor(x, device=dev).to(dtype).expand(H)

        self.records.append(Emission(
            mask, col(time, torch.int64), col(dst, torch.int32),
            col(kind, torch.int32), payload,
        ))


# handler(state, ev, emitter, params) -> state
Handler = Callable[..., SimState]


def draw_uniform(state: SimState, mask):
    """One uniform draw per host at its draw counter; the counter advances
    only where masked, so idle hosts' streams stand still."""
    h = state.host
    u = rng_mod.uniform_per_host(state.rng_keys, h.rng_counter)
    c = torch.where(mask, (h.rng_counter + 1) & M32, h.rng_counter)
    return state.with_host(rng_counter=c), u


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


def merge_rows(blocks, capacity: int):
    """The next pool: a stable sort by time of the blocks' rows in block
    order (the sort's ties depend on it), truncated to ``capacity``. Each
    block has ``time``, ``dst``, ``src``, ``seq``, ``kind`` and a packed
    ``payload``. Returns (pool, rows dropped past capacity)."""
    m_t = torch.cat([b.time for b in blocks])
    s_t, order = torch.sort(m_t, stable=True)
    keep = order[:capacity]

    def col(name):
        return torch.cat([getattr(b, name) for b in blocks])[keep]

    pool = EventPool(
        time=s_t[:capacity], dst=col("dst"), src=col("src"), seq=col("seq"),
        kind=col("kind"), payload=col("payload"),
    )
    dropped = (s_t[capacity:] != NEVER).sum()
    return pool, dropped


def merge(tail: Tail, em, capacity: int):
    """The matrix path's merge: the tail then the emission rows."""
    return merge_rows([tail, em], capacity)


# handler(state, dense, params, win_end, ops) -> kernels.ForwardOut
MatrixHandler = Callable[..., kernels.ForwardOut]


class Simulation:
    """Owns the state and plays the window loop on one device.

    Build it with ``shadow_tpu_torch.sim.build_simulation`` (or
    ``flagship.build_phold_flagship``), or directly for tests, with the
    JAX package's arguments: ``handlers`` maps event kind to a loop-path
    handler, ``bulk_kinds`` maps the one bulk kind to its batch width G,
    ``matrix_handler`` (for the bulk kind) enables the matrix path,
    ``bulk_gate`` / ``bulk_self_excluded`` limit the bulk batch, and K, B,
    O size the dense window, inbox and outbox. ``device=None`` means the
    card; pass ``device="cpu"`` to run the plain versions on the CPU.
    ``ops`` selects the window functions: the kernel wrappers by default,
    ``kernels.PLAIN_OPS`` for the plain versions on any device.
    ``_force_path`` ("matrix" or "loop") pins the path for tests."""

    def __init__(
        self,
        *,
        num_hosts: int,
        params: NetParams,
        host_vertex: np.ndarray,
        seed: int,
        stop_time: int,
        runahead: int,
        handlers: dict[int, Handler] | None = None,
        bulk_kinds: dict[int, int] | None = None,
        matrix_handler: MatrixHandler | None = None,
        bulk_gate: Callable | None = None,
        bulk_self_excluded: bool = False,
        event_capacity: int = 1 << 14,
        K: int = 32,
        B: int = 8,
        O: int = 64,
        subs: dict | None = None,
        initial_events: list | None = None,
        payload_words: int = PAYLOAD_WORDS,
        device=None,
        ops: kernels.WindowOps = kernels.KERNEL_OPS,
        _force_path: str | None = None,
    ):
        self.device = resolve_device(device)
        dev = self.device
        self.num_hosts = num_hosts
        self.stop_time = int(stop_time)
        self.runahead = int(runahead)
        if self.runahead <= 0:
            raise ValueError("runahead must be > 0 (min topology latency)")
        self.K, self.B, self.O = int(K), int(B), int(O)
        self.max_iters = self.K + 4 * self.B + 16
        self.handlers = dict(handlers or {})
        if bulk_kinds and len(bulk_kinds) > 1:
            raise ValueError("at most one bulk kind is supported")
        self.bulk_kind, self.G = (next(iter(bulk_kinds.items()))
                                  if bulk_kinds else (None, 1))
        if matrix_handler is not None and self.bulk_kind is None:
            raise ValueError("a matrix handler needs a bulk kind")
        self.matrix_handler = matrix_handler
        self.bulk_gate = bulk_gate
        self.bulk_self_excluded = bool(bulk_self_excluded)
        if _force_path not in (None, "matrix", "loop"):
            raise ValueError(f"unknown path {_force_path!r}")
        self._force_path = _force_path
        self.ops = ops
        self.params = params
        self.payload_words = int(payload_words)
        self._loop_plan = None  # (kinds, E_by_kind, G_run), probed once
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
        self._loop_bump = obs_mod.win_bump_vec(
            obs_mod.WIN_WINDOWS, obs_mod.WIN_LOOP, device=dev
        )

    def _frontier(self, stop: int):
        """(min pool time, occupancy, whether the window that starts there
        holds an event of another kind than the bulk kind): one
        device-to-host read."""
        t = self.state.pool.time
        mn = t.min()
        if self.matrix_handler is None:
            other = torch.ones((), dtype=torch.bool, device=t.device)
        else:
            we = torch.clamp(mn, max=stop - self.runahead) + self.runahead
            other = ((t < we)
                     & (self.state.pool.kind != self.bulk_kind)).any()
        vals = torch.stack([mn, (t != NEVER).sum(), other.to(torch.int64)])
        mn, occ, other = vals.tolist()
        return mn, occ, bool(other)

    def _takes_matrix(self, other: bool) -> bool:
        """The JAX package's per-window path choice (``make_window_step``):
        the loop path without a matrix handler, else the matrix path where
        every in-window event has the bulk kind, unless a path is
        forced."""
        if self.matrix_handler is None:
            return False
        if self._force_path is not None:
            return self._force_path == "matrix"
        return not other

    def step(self, win_start: int, win_end: int) -> None:
        """Process the window [win_start, win_end) on the matrix path:
        extract, forward, commit, merge. State fields are replaced by new
        tensors; none is written into."""
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

    # -- the micro-step loop path --

    def _plan_loop(self):
        """(kinds, E_by_kind, G_run), probed once: every handler runs once
        on a copy of the state with every host masked off, and the number
        of its emit() calls is its kind's worst-case outbox demand (the
        JAX package's trace-time probe). The probe's state is dropped."""
        if self._loop_plan is not None:
            return self._loop_plan
        kinds = sorted(self.handlers)
        if self.bulk_kind is not None and self.bulk_kind not in kinds:
            raise ValueError(f"bulk kind {self.bulk_kind} has no handler")
        H, dev = self.num_hosts, self.device
        P = self.payload_words
        pv = EventView(
            mask=torch.zeros(H, dtype=torch.bool, device=dev),
            time=torch.zeros(H, dtype=torch.int64, device=dev),
            src=torch.zeros(H, dtype=torch.int32, device=dev),
            seq=torch.zeros(H, dtype=torch.int32, device=dev),
            kind=torch.zeros(H, dtype=torch.int32, device=dev),
            payload=torch.zeros((H, P), dtype=torch.int32, device=dev),
        )
        probe = Emitter(kernels.PLAIN_OPS)
        e_by_kind = np.zeros(max(kinds) + 1 if kinds else 1, dtype=np.int32)
        pstate = self.state.detached_copy()
        for k in kinds:
            before = len(probe.records)
            pstate = self.handlers[k](pstate, pv, probe, self.params)
            e_by_kind[k] = len(probe.records) - before
        del pstate
        O = self.O
        if int(e_by_kind.max()) > O:
            worst = int(e_by_kind.argmax())
            raise ValueError(
                f"outbox_slots O={O} cannot absorb kind {worst}'s worst-"
                f"case emissions E={int(e_by_kind.max())}; raise "
                f"experimental.outbox_slots"
            )
        G_run = self.G
        bk = self.bulk_kind
        if bk is not None and int(e_by_kind[bk]) * self.G > O:
            if self.bulk_gate is None:
                raise ValueError(
                    f"outbox_slots O={O} cannot absorb a full bulk batch "
                    f"(kind {bk}: {int(e_by_kind[bk])} emissions x "
                    f"G={self.G}); raise outbox_slots or lower the bulk "
                    f"width"
                )
            G_run = max(1, O // max(1, int(e_by_kind[bk])))
        self._loop_plan = (kinds, torch.as_tensor(e_by_kind, device=dev),
                           G_run)
        return self._loop_plan

    def step_loop(self, win_start: int, win_end: int, occupancy: int) -> int:
        """Process the window [win_start, win_end) on the micro-step loop
        path (``make_loop_fns``): extract with Kc = K + 1, run micro-steps
        until one commits nothing or ``max_iters`` ran, then merge.
        ``occupancy`` is the pool's live row count. Returns the events
        committed (host-side count)."""
        kinds, e_by_kind, G_run = self._plan_loop()
        ops, params = self.ops, self.params
        H, K, dev = self.num_hosts, self.K, self.device
        Kc = K + 1
        P = self.payload_words
        PP = soa.packed_words(P)
        state = self.state.replace(now=int(win_start))
        state = state.replace(obs=state_mod.replace(
            state.obs, win=state.obs.win + self._loop_bump))
        dense, tail = dense_extract(state.pool, win_start, win_end, H, Kc,
                                    ops)
        defer = (dense.time[:, K].contiguous(),
                 dense.src[:, K].contiguous(),
                 dense.seq[:, K].contiguous())
        # the merge absorbs at most C - occupancy new box rows
        budget = state.pool.capacity - int(occupancy)
        boxes = kernels.Boxes.empty(H, self.B, self.O, PP, device=dev)
        ptr = torch.zeros(H, dtype=torch.int32, device=dev)
        gid = state.host.gid
        bk = -1 if self.bulk_kind is None else self.bulk_kind
        use_gate = self.bulk_kind is not None and G_run > 1
        committed = 0
        it = 0
        work = True
        while work and it < self.max_iters:
            gate = None
            if use_gate and self.bulk_gate is not None:
                gate = self.bulk_gate(state, params, win_start, win_end)
            sel = ops.loop_select(
                dense.time, dense.src, dense.seq, dense.kind, dense.payload,
                ptr, boxes.i_t, boxes.i_s, boxes.i_q, boxes.i_k, boxes.i_p,
                boxes.o_count, gate, gid, e_by_kind, K=K, G=G_run, O=self.O,
                bulk_kind=bk, self_excluded=self.bulk_self_excluded,
                win_end=win_end, pool_budget=budget,
            )
            # the one device read of the micro-step: how many hosts
            # committed, and which bulk columns any host took
            flags = torch.cat([
                sel.valid.sum()[None],
                (sel.take_t[:, 1:] != NEVER).any(dim=0),
            ]).tolist()
            n_valid, col_on = flags[0], flags[1:]
            work = n_valid > 0
            it += 1
            stall = sel.stalled.sum()
            if not work:
                state = state.add_counters(outbox_stall_deferred=stall,
                                           micro_steps=self._one)
                break
            ptr = sel.ptr
            boxes = boxes._replace(i_t=sel.inbox_time)
            ob = state.obs
            cm = ops.audit_commit(
                sel.take_t, sel.take_s, sel.take_k, gid, ob.host_digest,
                ob.host_events, ob.host_last_t, state.host.done_t)
            state = state.with_host(done_t=cm.done_t).replace(
                obs=state_mod.replace(
                    ob, host_events=cm.host_events,
                    host_last_t=cm.host_last_t, host_digest=cm.host_digest))
            emitter = Emitter(ops)
            head = self._view(sel, 0, P, sel.valid)
            for k in kinds:
                ev = head.replace(mask=sel.valid & (head.kind == k))
                state = self.handlers[k](state, ev, emitter, params)
                if k == bk:
                    for g in range(1, G_run):
                        if col_on[g - 1]:
                            ev = self._view(sel, g, P,
                                            sel.take_t[:, g] != NEVER)
                            state = self.handlers[k](state, ev, emitter,
                                                     params)
            if emitter.records:
                rec = emitter.records
                rt = ops.loop_route(
                    torch.stack([r.mask for r in rec]),
                    torch.stack([r.time for r in rec]),
                    torch.stack([r.dst for r in rec]),
                    torch.stack([r.kind for r in rec]),
                    soa.pack_words(torch.stack([r.payload for r in rec])),
                    state.host.seq_next, gid, *defer, boxes,
                    win_end=win_end,
                )
                boxes = rt.boxes
                st = rt.stats.sum(dim=0)
                state = state.with_host(seq_next=rt.seq_next).add_counters(
                    events_emitted=st[0], inbox_overflow_deferred=st[1],
                    outbox_overflow_dropped=st[2])
            committed += n_valid
            state = state.add_counters(
                events_committed=cm.n_valid.sum(),
                outbox_stall_deferred=stall, micro_steps=self._one)
        # merge: unconsumed dense cells, the tail, the outbox, the inbox
        dcols = torch.arange(Kc, dtype=torch.int32, device=dev)
        left = dcols[None, :] >= ptr[:, None]
        gB = gid[:, None]
        leftover = Tail(
            time=torch.where(left, dense.time, NEVER).reshape(-1),
            dst=gB.expand(H, Kc).reshape(-1), src=dense.src.reshape(-1),
            seq=dense.seq.reshape(-1), kind=dense.kind.reshape(-1),
            payload=dense.payload.reshape(H * Kc, PP),
        )
        bx = boxes
        outbox = Tail(time=bx.o_t.reshape(-1), dst=bx.o_d.reshape(-1),
                      src=bx.o_s.reshape(-1), seq=bx.o_q.reshape(-1),
                      kind=bx.o_k.reshape(-1),
                      payload=bx.o_p.reshape(-1, PP))
        inbox = Tail(time=bx.i_t.reshape(-1),
                     dst=gB.expand(H, self.B).reshape(-1),
                     src=bx.i_s.reshape(-1), seq=bx.i_q.reshape(-1),
                     kind=bx.i_k.reshape(-1),
                     payload=bx.i_p.reshape(-1, PP))
        pool, dropped = merge_rows([leftover, tail, outbox, inbox],
                                   state.pool.capacity)
        self.state = state.replace(pool=pool).add_counters(
            pool_overflow_dropped=dropped)
        return committed

    @staticmethod
    def _view(sel, g: int, P: int, mask) -> EventView:
        """The handlers' view of taken column g, each field contiguous as
        the kernels take it."""
        return EventView(
            mask=mask, time=sel.take_t[:, g].contiguous(),
            src=sel.take_s[:, g].contiguous(),
            seq=sel.take_q[:, g].contiguous(),
            kind=sel.take_k[:, g].contiguous(),
            payload=soa.unpack_words(sel.take_p[:, g], P).contiguous(),
        )

    @property
    def _one(self) -> torch.Tensor:
        return torch.ones((), dtype=torch.int64, device=self.device)

    def run(self, until: int | None = None) -> int:
        """Advance until the earliest pending event is at or past ``until``
        (default: the stop time). Returns the number of windows run.

        The loop runs under ``torch.inference_mode``: the simulator keeps
        no autograd state, and the mode trims the host's cost of each of
        the many small operations a micro-step launches."""
        with torch.inference_mode():
            return self._run(until)

    def _run(self, until: int | None) -> int:
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
            we = min(mn + self.runahead, stop)
            if self._takes_matrix(other):
                self.step(mn, we)
            elif self.step_loop(mn, we, occ) == 0:
                # the pool-headroom gate stalled every host: the JAX
                # package's driver raises here too, as its spill tier
                # cannot place one window's inflow either
                raise PoolExhausted(
                    f"the window at t={mn} committed nothing: pool "
                    f"occupancy {occ} of capacity "
                    f"{self.state.pool.capacity} leaves too little "
                    f"headroom for one window's emissions; raise "
                    f"experimental.event_capacity"
                )
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
