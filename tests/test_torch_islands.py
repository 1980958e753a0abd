"""The port's islands engine on the CPU against the JAX package's.

* ``island_route_plain`` (K24's plain version) against the JAX
  package's ``_island_route`` under ``jax.vmap(..., axis_name=AXIS)``
  over 4 shards: random candidates (ties in dt, NEVER rows interleaved,
  foreign and local rows, rows 2^44 ns past the window start), every
  output column in order and the dropped, sent, deferred and
  deferred_min counts, at X = 1, 4 and 32, and with a remainder past
  C_keep (dropped > 0).
* The extraction with the shard-local row: ``window_sort_plain`` and
  ``extract_slots_plain`` over 4 shards against ``_dense_extract(...,
  lrow=dst − shard·Hl)`` under vmap, on pools that hold rows deferred to
  other shards; and the numpy model of K24's design (one block a shard:
  F compacted, radix-sorted by (dt, group), ranked, the fillers and B
  placed by counts) against the plain version.
* ``IslandSpec`` refuses the permuted layout and optimistic islands.
* The layout: ``islandize_state`` and ``globalize_state`` against the
  JAX package's on a built state, and the round trip.
* End to end, ``tests/test_islands.py``'s ``_phold_cfg(num_shards=4)``
  (64 hosts, X = 32) and its deferral case (X = 1), under
  ``run_stepwise()`` and the barrier ``run()``: the chain, the counters
  and every state array (through ``interop``, in the JAX package's
  layout) against the JAX islands run (one a shape, its windows the
  barrier loop's), and the chain and counters against the port's own
  global run.

Tolerance: exact equality everywhere.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_tpu.core import engine as jengine
from shadow_tpu.core import state as jstate_mod
from shadow_tpu.parallel import islands as jislands
from shadow_tpu.sim import build_simulation as jax_build
from shadow_tpu_torch import interop, kernels
from shadow_tpu_torch.core.engine import Tail
from shadow_tpu_torch.parallel import islands
from shadow_tpu_torch.sim import build_simulation
from test_islands import _phold_cfg
from test_torch_phold import assert_states_equal, jax_state_to_numpy

NEVER = np.iinfo(np.int64).max
MS = 1_000_000
SEC = 1_000_000_000
DT_MAX = kernels.DT_MAX
AXIS = jislands.AXIS


def _candidates(rs, S, M, Hl, ws, PP, foreign=0.5):
    """[S, M] candidate columns: real rows at tied times around the window
    (a few at dt = DT_MAX and below the start), NEVER rows interleaved,
    local and foreign destinations, dst outside the hosts."""
    H = S * Hl
    t = np.where(rs.random((S, M)) < 0.45,
                 ws + rs.integers(0, 6, (S, M)) * MS, NEVER).astype(np.int64)
    t[rs.random((S, M)) < 0.03] = ws + DT_MAX + rs.integers(0, 3)
    t[rs.random((S, M)) < 0.03] = ws - 5
    own = np.arange(S)[:, None] * Hl + rs.integers(0, Hl, (S, M))
    d = np.where(rs.random((S, M)) < foreign, rs.integers(0, H, (S, M)),
                 own).astype(np.int32)
    d[rs.random((S, M)) < 0.02] = rs.choice([-3, H, H + 5])
    s = rs.integers(0, H, (S, M)).astype(np.int32)
    q = rs.integers(0, 50, (S, M)).astype(np.int32)
    k = rs.integers(0, 4, (S, M)).astype(np.int32)
    p = rs.integers(-2**40, 2**40, (S, M, PP)).astype(np.int64)
    return t, d, s, q, k, p


def _jax_route(cols, *, S, X, Hl, C, ws):
    spec = jengine.IslandSpec(axis=AXIS, num_shards=S, exchange_slots=X)

    def one(t, d, s, q, k, p):
        pcols = [p[:, w] for w in range(p.shape[1])]
        out, dropped, sent, deferred, dmin = jengine._island_route(
            t, d, s, q, k, pcols, win_start=jnp.int64(ws), H=Hl, C=C,
            spec=spec)
        return (out[:5] + [jnp.stack(out[5:], axis=-1)],
                jnp.stack([dropped, sent, deferred, dmin]))

    cols_out, stats = jax.jit(jax.vmap(one, axis_name=AXIS))(
        *(jnp.asarray(c) for c in cols))
    return [np.asarray(c) for c in cols_out], np.asarray(stats)


def _port_route(cols, *, S, X, Hl, C, ws, split, fn=None):
    """The plain version over the candidates cut into a tail block of
    ``split`` rows a shard and an emission block of the rest."""
    t, d, s, q, k, p = (torch.as_tensor(c) for c in cols)
    PP = p.shape[-1]

    def block(a, b):
        return Tail(time=t[:, a:b].contiguous(), dst=d[:, a:b].contiguous(),
                    src=s[:, a:b].contiguous(), seq=q[:, a:b].contiguous(),
                    kind=k[:, a:b].contiguous(),
                    payload=p[:, a:b].reshape(-1, PP).contiguous())

    fn = fn or kernels.island_route_plain
    return fn(block(0, split), block(split, t.shape[1]), shards=S,
              exchange_slots=X, num_hosts=S * Hl, capacity=C, win_start=ws)


ROUTE_CASES = {  # name: (X, candidates a shard, pool a shard, foreign)
    "x1": (1, 96, 64, 0.5),
    "x4": (4, 96, 64, 0.5),
    "x32": (32, 300, 192, 0.7),
    "dropped": (4, 160, 40, 0.3),
}


@pytest.mark.parametrize("case", sorted(ROUTE_CASES))
def test_island_route_plain_matches_jax(case):
    X, M, C, foreign = ROUTE_CASES[case]
    S, Hl, PP, ws = 4, 8, 3, 40 * MS
    rs = np.random.default_rng(sorted(ROUTE_CASES).index(case) + 3)
    cols = _candidates(rs, S, M, Hl, ws, PP, foreign)
    want, wstats = _jax_route(cols, S=S, X=X, Hl=Hl, C=C, ws=ws)
    got = _port_route(cols, S=S, X=X, Hl=Hl, C=C, ws=ws, split=C)
    for name, g, w in zip(("time", "dst", "src", "seq", "kind", "payload"),
                          got[:6], want):
        assert np.array_equal(g.numpy(), w), name
    assert np.array_equal(got.stats.numpy(), wstats)
    if case == "dropped":
        assert (wstats[:, 0] > 0).any()
    assert (wstats[:, 2] > 0).any() or X == 32


def route_model(cols, *, S, X, Hl, C, ws):
    """A numpy transcription of K24's design (``csrc/island_route.cu``):
    each shard alone, F compacted in input order and sorted stably by
    (dt << gbits | group), each F row's rank in its group from its count
    of earlier same-group rows, the sent rows to their group's pool at
    s·X + rank, the staying rows at their count of earlier staying rows
    (plus, at dt = DT_MAX, the staying fillers of the groups before),
    the fillers by the group counts, and B from place |F| in input
    order. Returns the next pools' columns and the stats."""
    t, d, s, q, k, p = cols
    M = t.shape[1]
    SX = S * X
    C_keep = C - SX
    gbits = int(S).bit_length()
    src = np.full((S, C), -2, np.int64)  # -2: a cell no step wrote
    stats = np.zeros((S, 4), np.int64)
    for sh in range(S):
        ds = np.clip(d[sh] // Hl, 0, S - 1)
        real = t[sh] != NEVER
        group = np.where(real & (ds != sh), ds, S)
        dt = np.clip((t[sh].astype(np.uint64) - np.uint64(ws)).view(np.int64),
                     0, DT_MAX)
        in_b = (group == S) & (dt == DT_MAX)
        f_idx = np.flatnonzero(~in_b)
        key = (dt[f_idx].astype(np.uint64) << np.uint64(gbits)) | group[
            f_idx].astype(np.uint64)
        order = f_idx[np.argsort(key, kind="stable")]
        n = np.bincount(group[f_idx], minlength=S + 1)
        u = np.minimum(n[:S], X)
        ucum = np.concatenate([[0], np.cumsum(u)])
        seen = np.zeros(S + 1, np.int64)
        unsent = 0
        far = np.zeros(S + 1, np.int64)
        dmin, sent, deferred, dropped = NEVER, 0, 0, 0
        for i in order:
            g = group[i]
            rank = seen[g]
            seen[g] += 1
            if g < S and rank < X:
                src[g, C_keep + sh * X + rank] = sh * M + i
                sent += 1
                continue
            at_max = dt[i] == DT_MAX
            far[g] += at_max
            pos = unsent + (ucum[g] if at_max else 0)
            unsent += 1
            if pos < C_keep:
                src[sh, pos] = sh * M + i
                if g < S:
                    deferred += 1
                    dmin = min(dmin, t[sh, i])
            elif real[i]:
                dropped += 1
        near = unsent - far[:S].sum()
        for g in range(S):
            stay = min(n[g], X)
            src[g, C_keep + sh * X + stay:C_keep + (sh + 1) * X] = -1
            start = near + far[:g + 1].sum() + ucum[g]
            for j in range(stay):
                if start + j < C_keep:
                    src[sh, start + j] = -1
        for j, i in enumerate(np.flatnonzero(in_b)):
            pos = len(f_idx) + j
            if pos < C_keep:
                src[sh, pos] = sh * M + i
            elif real[i]:
                dropped += 1
        stats[sh] = dropped, sent, deferred, dmin
    assert (src >= -1).all(), "a cell of the next pools was not written"
    flat = src.reshape(-1)
    take = np.maximum(flat, 0)
    out = []
    for c, fill in zip(cols, (NEVER, 0, 0, 0, 0, 0)):
        cc = c.reshape((S * M,) + c.shape[2:])[take]
        cc[flat < 0] = fill
        out.append(cc.reshape((S, C) + c.shape[2:]))
    return out, stats


MODEL_CASES = {  # name: (S, X, candidates a shard, pool a shard, foreign)
    "s4_x1": (4, 1, 96, 64, 0.5),
    "s4_x4_dropped": (4, 4, 160, 40, 0.3),
    "s8_x16_all_foreign": (8, 16, 300, 200, 1.0),
    "s3_x64_empty_groups": (3, 64, 260, 250, 0.05),
}


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_island_route_model_matches_plain(case):
    S, X, M, C, foreign = MODEL_CASES[case]
    Hl, PP, ws = 8, 2, 40 * MS
    rs = np.random.default_rng(sorted(MODEL_CASES).index(case) + 11)
    cols = _candidates(rs, S, M, Hl, ws, PP, foreign)
    want = _port_route(cols, S=S, X=X, Hl=Hl, C=C, ws=ws, split=C)
    got, stats = route_model(cols, S=S, X=X, Hl=Hl, C=C, ws=ws)
    for g, w in zip(got, want[:6]):
        assert np.array_equal(g, w.numpy())
    assert np.array_equal(stats, want.stats.numpy())


def _pool_with_deferred(rs, S, C, Hl, ws, we, PP):
    """[S, C] pools: rows of the shard's own hosts in and past the window,
    rows deferred to other shards (also in the window), free rows, dst
    outside the hosts, ties in (time, src, seq)."""
    H = S * Hl
    span = we - ws
    u = rs.random((S, C))
    t = np.where(u < 0.5, ws + rs.integers(0, 4, (S, C)) * (span // 4),
                 np.where(u < 0.75, we + rs.integers(0, span, (S, C)),
                          NEVER)).astype(np.int64)
    own = np.arange(S)[:, None] * Hl + rs.integers(0, Hl, (S, C))
    d = np.where(rs.random((S, C)) < 0.3, rs.integers(0, H, (S, C)),
                 own).astype(np.int32)
    d[rs.random((S, C)) < 0.03] = rs.choice([-2, H + 1])
    return dict(
        time=t, dst=d, src=rs.integers(0, 3, (S, C)).astype(np.int32),
        seq=rs.integers(0, 4, (S, C)).astype(np.int32),
        kind=rs.integers(0, 3, (S, C)).astype(np.int32),
        payload=rs.integers(-2**62, 2**62, (S, C, PP), dtype=np.int64))


@pytest.mark.parametrize("Kc", [3, 9])
def test_extract_with_local_rows_matches_jax(Kc):
    """window_sort_plain and extract_slots_plain over 4 shards against
    the JAX package's _dense_extract with lrow = dst − shard·Hl under
    vmap: the dense window (the JAX [S, Hl, Kc] flattened to [H, Kc])
    and the tail ([S, C] flattened), every column; rows deferred to other
    shards stay in the tail with their dst."""
    S, C, Hl, PP = 4, 150, 6, 2
    ws, we = 10 * MS, 18 * MS
    rs = np.random.default_rng(Kc)
    cols = _pool_with_deferred(rs, S, C, Hl, ws, we, PP)

    def one(sh, t, d, s, q, k, p):
        pool = jstate_mod.EventPool(time=t, dst=d, src=s, seq=q, kind=k,
                                    payload=p)
        dense, tail = jengine._dense_extract(
            pool, jnp.int64(ws), jnp.int64(we), Hl, Kc, PP,
            lrow=d - sh * Hl)
        return dense, tail._replace(payload=jnp.stack(tail.payload, -1))

    jd, jt = jax.jit(jax.vmap(one))(
        jnp.arange(S, dtype=jnp.int32),
        *(jnp.asarray(cols[k]) for k in ("time", "dst", "src", "seq",
                                         "kind", "payload")))
    pool = {k: torch.as_tensor(v) for k, v in cols.items()}
    s_k1, perm = kernels.window_sort_plain(
        pool["time"], pool["dst"], pool["src"], pool["seq"], ws, we, S * Hl,
        Kc, S)
    got = kernels.extract_slots_plain(
        s_k1, perm, pool["time"], pool["dst"], pool["src"], pool["seq"],
        pool["kind"], pool["payload"], S * Hl, Kc, S)
    for f in ("time", "src", "seq", "kind", "payload"):
        w = np.asarray(getattr(jd, f))
        assert np.array_equal(getattr(got.dense, f).numpy(),
                              w.reshape((S * Hl,) + w.shape[2:])), f
    for f in ("time", "dst", "src", "seq", "kind", "payload"):
        w = np.asarray(getattr(jt, f))
        assert np.array_equal(getattr(got.tail, f).numpy(),
                              w.reshape((-1,) + w.shape[2:])), f
    # some in-window rows were another shard's: they stayed in the tail
    lrow = cols["dst"] - np.arange(S)[:, None] * Hl
    foreign_in = (cols["time"] < we) & ((lrow < 0) | (lrow >= Hl))
    assert foreign_in.any()
    assert np.isin(cols["time"][foreign_in], got.tail.time.numpy()).all()


@pytest.mark.parametrize("flag", ["use_slot_table", "optimistic"])
def test_island_spec_refuses_unported_layouts(flag):
    spec = islands.IslandSpec(AXIS, 4, 32)
    assert spec.check() is spec
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue A 9"):
        spec._replace(**{flag: True}).check()


def test_layout_matches_jax():
    """islandize_state and globalize_state against the JAX package's on
    a built PHOLD state (4 shards, X = 32): every path of the islands
    layout, then of the global one; and the round trip, which gives back
    the built state with its live pool rows in event-key order."""
    cfg = _phold_cfg()
    S, C_shard = 4, 1024 // 4 + 4 * 32
    jg = jax_build(cfg).state
    port = build_simulation(cfg, device="cpu")
    isl = islands.islandize_state(port.state, S, C_shard)
    jisl = jislands.islandize_state(jg, S, C_shard)
    paths = interop.state_paths(isl)
    assert "exch_deferred_min" in paths
    assert_states_equal(interop.state_to_numpy(isl),
                        jax_state_to_numpy(jisl, paths))
    back = islands.globalize_state(isl, 1024)
    gpaths = interop.state_paths(back)
    assert_states_equal(interop.state_to_numpy(back),
                        jax_state_to_numpy(
                            jislands.globalize_state(jisl, 1024), gpaths))
    # the round trip: the built state, live rows in (time, dst, src, seq)
    want = interop.state_to_numpy(port.state)
    got = interop.state_to_numpy(back)
    live = want["pool.time"] != NEVER
    order = np.lexsort([want[f"pool.{k}"][live]
                        for k in ("seq", "src", "dst", "time")])
    n = int(live.sum())
    for path, w in want.items():
        if path.startswith("pool."):
            assert np.array_equal(got[path][:n], w[live][order]), path
            free = NEVER if path == "pool.time" else 0
            assert (got[path][n:] == free).all(), path
        else:
            assert np.array_equal(got[path], w), path
    # the islands state comes back from its numpy form
    again = interop.state_from_numpy(interop.state_to_numpy(isl))
    assert_states_equal(interop.state_to_numpy(again),
                        interop.state_to_numpy(isl))


_PHYS_KEYS = ("events_committed", "events_emitted", "packets_sent",
              "packets_dropped_loss", "bytes_sent", "pool_overflow_dropped",
              "bulk_contract_violations")


def _islands_cfg(X, driver):
    cfg = _phold_cfg(num_shards=4, exchange_slots=X)
    if driver == "run":
        cfg["experimental"]["async_islands"] = False
    return cfg


@pytest.fixture(autouse=True)
def one_thread():
    """The runs are many small ops; intra-op threads only add overhead."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX islands run of each X, once for both drivers' cases: its
    ``run_stepwise()``, whose windows are the barrier ``run()``'s
    (``tests/test_islands.py:test_islands_fused_run_matches_stepwise``),
    with ``async_islands: false`` so the port's ``run()`` builds from the
    same config."""
    sims = {X: jax_build(_islands_cfg(X, "run")) for X in (32, 1)}
    with ThreadPoolExecutor(len(sims)) as pool:  # XLA leaves the GIL
        runs = {X: pool.submit(j.run_stepwise) for X, j in sims.items()}
        return {X: (sims[X], r.result()) for X, r in runs.items()}


@pytest.fixture(scope="module")
def global_port():
    g = build_simulation(_phold_cfg(), device="cpu")
    g.run()
    return g.counters(), g.audit_chain()


@pytest.mark.parametrize("driver", ["stepwise", "run"])
@pytest.mark.parametrize("X", [32, 1])
def test_islands_run_matches_jax(X, driver, jax_runs, global_port):
    """The port's islands run to the stop against the JAX package's, at
    X = 32 and at X = 1 (rows defer every window, and the deferral clamp
    ends windows early), under run_stepwise() (with the defaults, async
    on) and the barrier run() (async off): the windows, the chain, every
    counter and every state array (the JAX layout: pool [4, C_shard],
    host rows [4, 16], counters [4]); and the chain and the physical
    counters against the port's global run."""
    jsim, jw = jax_runs[X]
    port = build_simulation(
        _islands_cfg(X, driver) if driver == "run"
        else _phold_cfg(num_shards=4, exchange_slots=X), device="cpu")
    assert isinstance(port, islands.IslandSimulation)
    w = port.run_stepwise() if driver == "stepwise" else port.run()
    assert w == jw == jsim.obs_snapshot()["win"]["windows_run"]
    assert port.obs_snapshot()["win"] == jsim.obs_snapshot()["win"]
    assert port.counters() == jsim.counters()
    assert port.audit_chain() == jsim.audit_chain()
    paths = interop.state_paths(port.state)
    assert_states_equal(interop.state_to_numpy(port.state),
                        jax_state_to_numpy(jsim.state, paths))
    gc, gchain = global_port
    assert port.audit_chain() == gchain
    assert {k: port.counters()[k] for k in _PHYS_KEYS} == {
        k: gc[k] for k in _PHYS_KEYS}
    c = port.counters()
    assert c["exchange_sent"] > 0
    assert (c["exchange_deferred"] > 0) == (X == 1)
