"""The port's micro-step loop path against the sequential heapq oracle and
the JAX package.

* PHOLD through the loop path, with and without the bulk batch, against
  ``test_engine_phold.phold_oracle`` on that file's cases; the loop path
  against the matrix path on one window stream; and PHOLD on a topology
  with unreachable pairs, where every window takes the loop path, against
  the JAX package state by state.
* The engine's ordering and backpressure cases of
  ``tests/test_engine_phold.py`` (K-overflow deferral, an intra-window
  self event, an exact time tie, outbox overflow), with torch handlers and
  the same expected values.
* The loop path's kernels' plain versions, ``loop_select_plain`` and
  ``loop_route_plain``, against the same steps written with the JAX
  package's own helpers (``_read_col``, ``_inbox_min``, ``_key_lt``,
  ``_set_col``), on seeded random states (``test_torch_cuda.random_*``).

Tolerance: exact equality everywhere; the path is integer arithmetic and
float32 with a defined rounding.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_tpu.core import engine as jengine
from shadow_tpu.core import soa as jsoa
from shadow_tpu_torch import kernels
from shadow_tpu_torch.core.engine import Simulation
from shadow_tpu_torch.core.state import (
    KIND_APP_MSG,
    KIND_APP_TIMER,
    NetParams,
)
from shadow_tpu_torch.flagship import build_phold_flagship
from shadow_tpu_torch.net.apps import PholdApp
from test_engine_phold import phold_oracle
from test_torch_cuda import random_route_inputs, random_select_inputs

MS = 1_000_000
SEC = 1_000_000_000
NEVER = np.iinfo(np.int64).max


@pytest.fixture(autouse=True)
def one_thread():
    """The loop path runs many small ops; intra-op threads only add
    overhead at these widths."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(latency, rel=1.0):
    return NetParams(
        latency_vv=torch.full((1, 1), latency, dtype=torch.int64),
        reliability_vv=torch.full((1, 1), rel, dtype=torch.float32),
        bootstrap_end=0,
    )


def _phold_sim(H, seed, latency, rel, msgload, runtime, stop, bulk):
    """test_engine_phold.build_phold_sim on the port: the loop path only."""
    app = PholdApp(H, msgload=msgload, size_bytes=64, start_time=SEC,
                   runtime=runtime)
    return Simulation(
        num_hosts=H, params=_params(latency, rel),
        host_vertex=np.zeros(H, np.int32), seed=seed, stop_time=stop,
        runahead=latency, handlers=app.handlers(),
        bulk_kinds=app.bulk_kinds() if bulk else None,
        event_capacity=4096, K=16, B=4, O=16,
        subs={PholdApp.SUB: app.init_sub()},
        initial_events=app.initial_events(),
        payload_words=PholdApp.PAYLOAD_WORDS, device="cpu",
    )


@pytest.mark.parametrize("H,seed,latency,rel,msgload,runtime,stop,bulk", [
    # test_phold_matches_oracle
    (5, 12345, 50 * MS, 1.0, 2, 5 * SEC, 10 * SEC, False),
    # test_phold_lossy_matches_oracle
    (4, 777, 10 * MS, 0.7, 3, 3 * SEC, 6 * SEC, False),
    # test_phold_bulk_matches_oracle (its plain arm runs inside the case)
    (5, 12345, 50 * MS, 0.9, 4, 5 * SEC, 10 * SEC, True),
    # test_phold_matrix_path_matches_oracle's case, on the loop path
    (5, 12345, 50 * MS, 0.8, 3, 5 * SEC, 10 * SEC, True),
])
def test_phold_loop_path_matches_oracle(H, seed, latency, rel, msgload,
                                        runtime, stop, bulk):
    sim = _phold_sim(H, seed, latency, rel, msgload, runtime, stop, bulk)
    windows = sim.run()
    oracle = phold_oracle(H, seed, latency, rel, msgload, SEC,
                          SEC + runtime, stop)
    sub = sim.state.subs[PholdApp.SUB]
    assert sub["received"].tolist() == oracle["received"]
    assert sub["forwarded"].tolist() == oracle["forwarded"]
    c = sim.counters()
    assert c["packets_sent"] == oracle["sent"]
    assert c["packets_dropped_loss"] == oracle["dropped"]
    assert c["pool_overflow_dropped"] == 0
    assert c["outbox_overflow_dropped"] == 0
    assert c["inbox_overflow_deferred"] == 0
    assert sim.state.host.rng_counter.tolist() == oracle["rng_counters"]
    snap = sim.obs_snapshot()["win"]
    assert snap["loop_dispatches"] == snap["windows_run"] == windows > 0
    assert c["micro_steps"] > windows
    if bulk:
        plain = _phold_sim(H, seed, latency, rel, msgload, runtime, stop,
                           False)
        plain.run()
        assert plain.counters()["events_committed"] == c["events_committed"]
        assert plain.audit_chain() == sim.audit_chain()
        assert c["micro_steps"] < plain.counters()["micro_steps"]


def test_loop_path_commits_what_the_matrix_path_commits():
    """The same PHOLD run forced through each path commits the same
    history (chain, per-host digests, counts) and ends with the same
    population; only the micro-step count differs."""
    runs = {}
    for path in ("matrix", "loop"):
        sim = build_phold_flagship(48, msgload=3, stop_s=3, device="cpu")
        sim._force_path = path
        sim.run()
        runs[path] = sim
    m, lp = runs["matrix"], runs["loop"]
    assert m.audit_chain() == lp.audit_chain()
    cm, cl = m.counters(), lp.counters()
    assert cm.pop("micro_steps") < cl.pop("micro_steps")
    assert cm == cl
    for k in ("host_events", "host_last_t", "host_digest"):
        assert np.array_equal(m.obs_snapshot()[k], lp.obs_snapshot()[k])
    for k in ("received", "forwarded"):
        assert torch.equal(m.state.subs["phold"][k],
                           lp.state.subs["phold"][k])
    assert torch.equal(m.state.host.rng_counter, lp.state.host.rng_counter)
    assert torch.equal(m.state.pool.time.sort().values,
                       lp.state.pool.time.sort().values)


# ---------------------------------------------------------------------------
# ordering and backpressure (tests/test_engine_phold.py, torch handlers)
# ---------------------------------------------------------------------------


def _recorder(H, T, field):
    """A handler appending each processed event's ``field`` to a per-host
    trace, as the JAX tests' ``record`` does."""

    def record(state, ev, emitter, params):
        sub = dict(state.subs["trace"])
        n = sub["n"]
        slot = n.clamp(0, T - 1).to(torch.int64)
        vals = sub[field].clone()
        rows = torch.arange(H)[ev.mask]
        vals[rows, slot[ev.mask]] = getattr(ev, field[:-1]).to(
            vals.dtype)[ev.mask]
        sub[field] = vals
        sub["n"] = n + ev.mask.to(torch.int32)
        return state.with_sub("trace", sub)

    return record


def _emit_after(record, H, delay):
    """A timer handler that records its event and emits a self message
    ``delay`` later."""

    def timer_then_emit(state, ev, emitter, params):
        state = record(state, ev, emitter, params)
        hosts = torch.arange(H, dtype=torch.int32)
        emitter.emit(ev.mask, ev.time + delay, hosts, KIND_APP_MSG,
                     ev.payload)
        return state

    return timer_then_emit


def _sim(H, handlers, subs, initial, K, O=8):
    return Simulation(
        num_hosts=H, params=_params(50 * MS),
        host_vertex=np.zeros(H, np.int32), seed=1, stop_time=SEC,
        runahead=50 * MS, handlers=handlers, event_capacity=64, K=K, B=4,
        O=O, subs=subs, initial_events=initial, device="cpu",
    )


def _trace(H, T, field, dtype):
    return {"trace": {field: torch.full((H, T), -1, dtype=dtype),
                      "n": torch.zeros(H, dtype=torch.int32)}}


def test_k_overflow_defers_self_emissions_past_leftovers():
    H, T = 1, 8
    rec = _recorder(H, T, "times")
    sim = _sim(H, {KIND_APP_TIMER: _emit_after(rec, H, 3 * MS),
                   KIND_APP_MSG: rec},
               _trace(H, T, "times", torch.int64),
               [(1 * MS, 0, 0, KIND_APP_TIMER, []),
                (2 * MS, 0, 0, KIND_APP_MSG, []),
                (3 * MS, 0, 0, KIND_APP_MSG, [])], K=2)
    sim.run()
    trace = sim.state.subs["trace"]
    assert trace["times"][0, :4].tolist() == [1 * MS, 2 * MS, 3 * MS, 4 * MS]
    assert int(trace["n"][0]) == 4


def test_intra_window_self_events_processed_in_order():
    H, T = 2, 8
    rec = _recorder(H, T, "times")
    sim = _sim(H, {KIND_APP_TIMER: _emit_after(rec, H, 2 * MS),
                   KIND_APP_MSG: rec},
               _trace(H, T, "times", torch.int64),
               [(1 * MS, 0, 0, KIND_APP_TIMER, []),
                (5 * MS, 0, 0, KIND_APP_MSG, []),
                (5 * MS, 1, 1, KIND_APP_MSG, [])], K=8)
    sim.run()
    trace = sim.state.subs["trace"]
    assert trace["times"][0, :3].tolist() == [1 * MS, 3 * MS, 5 * MS]
    assert int(trace["n"][0]) == 3
    assert trace["times"][1, :1].tolist() == [5 * MS]


def test_k_overflow_time_tie_exact_order():
    H, T, TIE = 4, 8, 20 * MS
    rec = _recorder(H, T, "srcs")
    sim = _sim(H, {KIND_APP_TIMER: _emit_after(rec, H, 10 * MS),
                   KIND_APP_MSG: rec},
               _trace(H, T, "srcs", torch.int32),
               [(10 * MS, 0, 1, KIND_APP_TIMER, []),
                (TIE, 0, 2, KIND_APP_MSG, []),
                (TIE, 0, 3, KIND_APP_MSG, [])], K=2)
    sim.run()
    trace = sim.state.subs["trace"]
    assert trace["srcs"][0, :4].tolist() == [1, 0, 2, 3]
    assert int(trace["n"][0]) == 4


def test_outbox_overflow_defers_never_drops():
    H, N = 2, 10

    def count_rx(state, ev, emitter, params):
        sub = dict(state.subs["trace"])
        sub["rx"] = sub["rx"] + ev.mask.to(torch.int32)
        return state.with_sub("trace", sub)

    def emit_cross(state, ev, emitter, params):
        hosts = torch.arange(H, dtype=torch.int32)
        emitter.emit(ev.mask, ev.time + 60 * MS, (hosts + 1) % H,
                     KIND_APP_MSG, ev.payload)
        return state

    sim = _sim(H, {KIND_APP_TIMER: emit_cross, KIND_APP_MSG: count_rx},
               {"trace": {"rx": torch.zeros(H, dtype=torch.int32)}},
               [(i * MS, 0, 0, KIND_APP_TIMER, []) for i in range(1, N + 1)],
               K=16, O=4)
    sim.run()
    c = sim.counters()
    assert int(sim.state.subs["trace"]["rx"][1]) == N
    assert c["outbox_overflow_dropped"] == 0
    assert c["outbox_stall_deferred"] > 0
    assert c["pool_overflow_dropped"] == 0


# ---------------------------------------------------------------------------
# loop_select / loop_route plain versions against the JAX package's steps
# ---------------------------------------------------------------------------


def _jax_select(a, K, G, O, bulk_kind, self_excluded, win_end, pool_budget):
    """make_loop_fns.body's selection, written with the JAX package's
    helpers (shadow_tpu/core/engine.py:807-902, 968-971)."""
    j = {k: (None if v is None else jnp.asarray(v)) for k, v in a.items()}
    Kc = K + 1
    dense = jengine._DenseWindow(time=j["d_t"], src=j["d_s"], seq=j["d_q"],
                                 kind=j["d_k"], payload=j["d_p"])
    inbox = jengine._Inbox(time=j["i_t"], src=j["i_s"], seq=j["i_q"],
                           kind=j["i_k"], payload=j["i_p"])
    ptr, gid = j["ptr"], j["gid"]
    m_t_raw, m_src, m_seq, m_kind, m_payload = jengine._read_col(dense, ptr,
                                                                 Kc)
    in_run = (ptr < K) & (m_t_raw != NEVER)
    m_time = jnp.where(in_run, m_t_raw, NEVER)
    i_time, i_src, i_seq, i_slot = jengine._inbox_min(inbox)
    use_inbox = jengine._key_lt(i_time, i_src, i_seq, m_time, m_src, m_seq)
    ev_time = jnp.where(use_inbox, i_time, m_time)
    ev_kind = jnp.where(use_inbox, jsoa.get_at(inbox.kind, i_slot), m_kind)
    bulk = []
    if bulk_kind >= 0 and G > 1:
        prev = (ev_time < win_end) & ~use_inbox & (ev_kind == bulk_kind)
        if self_excluded:
            prev = prev & (m_src != gid)
        gate = j["gate"]
        if gate is not None:
            prev = prev & (gate > 0)
        for g in range(1, G):
            ing = ptr + g < K
            tg_r, sg, qg, kg, pg = jengine._read_col(
                dense, jnp.where(ing, ptr + g, 0), Kc)
            ing = ing & (tg_r != NEVER)
            tg = jnp.where(ing, tg_r, NEVER)
            okg = (prev & ing & (kg == bulk_kind) & (tg < win_end)
                   & jengine._key_lt(tg, sg, qg, i_time, i_src, i_seq))
            if self_excluded:
                okg = okg & (sg != gid)
            if gate is not None:
                okg = okg & (gate >= g)
            bulk.append((tg, sg, qg, kg, pg, okg))
            prev = okg
        g_extra = sum(b[5].astype(jnp.int32) for b in bulk)
    else:
        g_extra = jnp.zeros(ptr.shape, jnp.int32)
    need_base = jnp.zeros(ptr.shape, jnp.int32)
    for k, e in enumerate(np.asarray(a["need_by_kind"])):
        if e:
            need_base = jnp.where(ev_kind == k, int(e), need_base)
    need = need_base * (1 + g_extra)
    room = (j["o_count"] + need) <= O
    hot = ev_time < win_end
    box_used = jnp.sum(j["o_count"]) + jnp.sum(inbox.time != NEVER,
                                               dtype=jnp.int32)
    need_hot = jnp.where(hot, need, 0)
    cum = jnp.cumsum(need_hot) - need_hot
    fits = (box_used + cum + need_hot) <= pool_budget
    valid = hot & room & fits
    stalled = hot & ~(room & fits)
    i_payload = jsoa.get_at(inbox.payload, i_slot)
    head = (ev_time, jnp.where(use_inbox, i_src, m_src),
            jnp.where(use_inbox, i_seq, m_seq), ev_kind,
            jnp.where(use_inbox[:, None], i_payload, m_payload), valid)
    cols = [head] + [b[:5] + (b[5] & valid,) for b in bulk]
    taken_extra = sum(c[5].astype(jnp.int32) for c in cols[1:]) if bulk \
        else 0
    new_ptr = jnp.where(valid & ~use_inbox, ptr + 1 + taken_extra, ptr)
    new_it = jengine._set_col(inbox.time, i_slot, valid & use_inbox, NEVER)
    take = [
        np.stack([np.asarray(jnp.where(c[5], c[0], NEVER)) for c in cols],
                 axis=1),
        *(np.stack([np.asarray(jnp.where(c[5], c[i], 0)) for c in cols],
                   axis=1) for i in (1, 2, 3)),
        np.stack([np.asarray(jnp.where(c[5][:, None], c[4], 0))
                  for c in cols], axis=1),
    ]
    if G > 1 and not bulk:
        H = ptr.shape[0]
        take = [np.concatenate([x, np.full((H, G - 1) + x.shape[2:],
                                           NEVER if i == 0 else 0, x.dtype)],
                               axis=1) for i, x in enumerate(take)]
    return take + [np.asarray(valid), np.asarray(stalled),
                   np.asarray(new_ptr), np.asarray(new_it)]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("G,gate,excl,bulk_kind,B", [
    (4, True, True, 3, 4), (1, False, False, 3, 4), (6, False, False, 3, 3),
    (4, True, True, -1, 5), (3, True, False, 3, 8),
])
def test_loop_select_plain_matches_jax(seed, G, gate, excl, bulk_kind, B):
    rs = np.random.default_rng(seed)
    arrays, kw = random_select_inputs(rs, G=G, B=B)
    if not gate:
        arrays["gate"] = None
    kw.update(self_excluded=excl, bulk_kind=bulk_kind)
    t = {k: (None if v is None else torch.from_numpy(v))
         for k, v in arrays.items()}
    got = kernels.loop_select_plain(
        *(t[k] for k in ("d_t", "d_s", "d_q", "d_k", "d_p", "ptr", "i_t",
                         "i_s", "i_q", "i_k", "i_p", "o_count", "gate",
                         "gid", "need_by_kind")), **kw)
    want = _jax_select(arrays, **kw)
    assert len(got) == len(want)
    for name, g, w in zip(got._fields, got, want):
        g = g.numpy()
        assert g.shape == w.shape, name
        assert np.array_equal(g, w.astype(g.dtype)), name
    assert got.valid.any() and got.stalled.any()


def _jax_route(rec, boxes, win_end):
    """make_loop_fns.body's routing loop with the JAX package's helpers
    (shadow_tpu/core/engine.py:1041-1097)."""
    j = {k: jnp.asarray(v) for k, v in {**rec, **boxes}.items()}
    gid, O = j["gid"], boxes["o_t"].shape[1]
    it, i_s, i_q, i_k, i_p = j["i_t"], j["i_s"], j["i_q"], j["i_k"], j["i_p"]
    ot, od, os_, oq, ok_, op = (j[k] for k in ("o_t", "o_d", "o_s", "o_q",
                                               "o_k", "o_p"))
    count, seq_next = j["o_count"], j["seq_next"]
    stats = np.zeros((gid.shape[0], 3), np.int64)
    for e in range(rec["m"].shape[0]):
        m, t, d, k, p = j["m"][e], j["t"][e], j["d"][e], j["k"][e], j["p"][e]
        seq = seq_next
        seq_next = jnp.where(m, seq + 1, seq)
        is_self = (m & (d == gid) & (t < win_end)
                   & jengine._key_lt(t, gid, seq, j["defer_t"], j["defer_s"],
                                     j["defer_q"]))
        free = it == NEVER
        ff = jnp.argmax(free, axis=1).astype(jnp.int32)
        has_free = jnp.any(free, axis=1)
        ins = is_self & has_free
        to_out = m & ~ins
        it = jengine._set_col(it, ff, ins, t)
        i_s = jengine._set_col(i_s, ff, ins, gid)
        i_q = jengine._set_col(i_q, ff, ins, seq)
        i_k = jengine._set_col(i_k, ff, ins, k)
        i_p = jengine._set_col(i_p, ff, ins, p)
        put = to_out & (count < O)
        ot = jengine._set_col(ot, count, put, t)
        od = jengine._set_col(od, count, put, d)
        os_ = jengine._set_col(os_, count, put, gid)
        oq = jengine._set_col(oq, count, put, seq)
        ok_ = jengine._set_col(ok_, count, put, k)
        op = jengine._set_col(op, count, put, p)
        count = count + put.astype(jnp.int32)
        stats += np.stack([np.asarray(m), np.asarray(is_self & ~has_free),
                           np.asarray(to_out & ~put)], axis=1)
    return [it, i_s, i_q, i_k, i_p, ot, od, os_, oq, ok_, op, count,
            seq_next, stats]


@pytest.mark.parametrize("seed", range(4))
def test_loop_route_plain_matches_jax(seed):
    rs = np.random.default_rng(100 + seed)
    rec, boxes, kw = random_route_inputs(rs)
    t = {k: torch.from_numpy(v) for k, v in rec.items()}
    bx = kernels.Boxes(**{k: torch.from_numpy(v) for k, v in boxes.items()})
    got = kernels.loop_route_plain(
        *(t[k] for k in ("m", "t", "d", "k", "p", "seq_next", "gid",
                         "defer_t", "defer_s", "defer_q")), bx, **kw)
    want = _jax_route(rec, boxes, kw["win_end"])
    got = list(got.boxes) + [got.seq_next, got.stats]
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    st = got[-1].sum(dim=0).tolist()
    assert st[1] > 0 and st[2] > 0  # full inboxes and outboxes were hit


GML_SPLIT = """
graph [
  node [ id 0 bandwidth_down "1 Gbit" bandwidth_up "1 Gbit" ]
  node [ id 1 bandwidth_down "1 Gbit" bandwidth_up "1 Gbit" ]
  edge [ source 0 target 0 latency "20 ms" packet_loss 0.1 ]
  edge [ source 1 target 1 latency "30 ms" packet_loss 0.0 ]
]
"""


def test_phold_on_an_unreachable_topology_matches_jax():
    """build_simulation gives PHOLD no matrix path where some destination
    is unreachable; every window then takes the loop path, in both
    packages, to the same final state."""
    from shadow_tpu.sim import build_simulation as jax_build
    from shadow_tpu_torch import interop
    from shadow_tpu_torch.sim import build_simulation
    from test_torch_phold import assert_states_equal, jax_state_to_numpy

    cfg = {
        "general": {"stop_time": 3, "seed": 3},
        "network": {"graph": {"type": "gml", "inline": GML_SPLIT}},
        "experimental": {"event_capacity": 1024,
                         "events_per_host_per_window": 8},
        "hosts": {f"g{v}": {"quantity": 3, "app_model": "phold",
                            "network_node_id": v,
                            "app_options": {"msgload": 2, "runtime": 2}}
                  for v in range(2)},
    }
    port = build_simulation(cfg, device="cpu")
    assert port.matrix_handler is None
    port.run()
    jsim = jax_build(cfg)
    jsim.run()
    c = port.counters()
    assert c == jsim.counters()
    assert c["packets_dropped_unreachable"] > 0
    assert c["packets_dropped_loss"] > 0
    assert port.audit_chain() == jsim.audit_chain()
    win = port.obs_snapshot()["win"]
    assert win == jsim.obs_snapshot()["win"]
    assert win["loop_dispatches"] == win["windows_run"] > 0
    paths = interop.state_paths(port.state)
    assert_states_equal(interop.state_to_numpy(port.state),
                        jax_state_to_numpy(jsim.state, paths))
