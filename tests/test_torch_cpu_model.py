"""The CPU model in the port (``cpu_ns_per_event``; kernel
``cpu_serialize``) and ``Simulation.run_stepwise``, against the JAX package.

* ``tests/test_engine_phold.py``'s CPU-model scenario (six hosts, three
  of them at 10 ms an event, their CPU clocks running away) on the loop
  path, the loop path with the bulk batch and the matrix path, each run
  by both packages' ``run_stepwise``: windows, counters
  (``cpu_delay_applied`` among them), audit chain and every state array
  (``cpu_avail`` among them) equal; the port's loop and matrix paths
  serialize alike, as the JAX test asserts; ``run_stepwise`` equals
  ``run`` in the port, whole and resumed from a cut.
* A small UDP flood with its server at 20 ms an event and its clients at
  60 ms (loop path, bulk batch), and the CPU model under ``run_optimistic`` on the mixed flood
  over ``tests/test_optimistic.py``'s two-vertex graph, whose windows
  roll back: windows, rollbacks, counters, chain and every state array
  equal to the JAX package's; a rolled-back attempt leaves its base's
  ``cpu_avail`` as it was. Where the model runs a destination's clock
  past a speculative window, the JAX package's driver retries the window
  forever (``ROADMAP.md`` C4); the port raises.
* ``cpu_serialize_plain`` in both forms against a scalar transcription
  of each JAX form on rows with empty cells, zero costs, a CPU free past
  the window, all-empty hosts and empty cells between real ones.

Tolerance: exact equality everywhere.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from shadow_tpu.core.engine import Simulation as JSimulation
from shadow_tpu.net.apps import PholdApp as JPholdApp
from shadow_tpu.sim import build_simulation as jax_build
from shadow_tpu_torch import kernels
from shadow_tpu_torch.core.engine import Simulation
from shadow_tpu_torch.core.simtime import NEVER
from shadow_tpu_torch.core.state import NetParams
from shadow_tpu_torch.net.apps import PholdApp
from shadow_tpu_torch.sim import build_simulation
from chip_smoke import mixed_flood
from test_engine_phold import make_params
from test_optimistic import MIXED_YAML
from test_qdisc import _flood_cfg
from test_torch_phold_variants import assert_runs_equal, run_all

MS = 1_000_000
SEC = 1_000_000_000
# test_cpu_model_serializes_and_skews: hosts 0-2 free, 3-5 at 10 ms an
# event against ≈800 offered a second
H, SEED, LAT, MSGLOAD = 6, 4242, 20 * MS, 32
COST = np.array([0, 0, 0, 10 * MS, 10 * MS, 10 * MS], dtype=np.int64)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _common(stop, cost):
    return dict(num_hosts=H, host_vertex=np.zeros(H, np.int32), seed=SEED,
                stop_time=stop, runahead=LAT, event_capacity=4096, K=16,
                B=4, O=16, payload_words=PholdApp.PAYLOAD_WORDS,
                cpu_ns_per_event=cost)


def _jax_scenario(path, stop=2 * SEC, cost=COST):
    """The scenario in the JAX package: "loop" (no bulk batch), "bulk"
    (the loop path with the bulk batch) or "matrix"."""
    japp = JPholdApp(H, msgload=MSGLOAD, size_bytes=64, start_time=SEC,
                     runtime=2 * SEC)
    return JSimulation(
        params=make_params(H, LAT, 1.0), handlers=japp.handlers(),
        subs={JPholdApp.SUB: japp.init_sub()},
        initial_events=japp.initial_events(),
        bulk_kinds=japp.bulk_kinds() if path != "loop" else None,
        matrix_handlers=japp.matrix_handlers() if path == "matrix" else None,
        **_common(stop, cost))


def _port_scenario(path, stop=2 * SEC, cost=COST):
    """The scenario in the port, as ``_jax_scenario`` builds it."""
    bulk = path in ("bulk", "matrix")
    app = PholdApp(H, msgload=MSGLOAD, size_bytes=64, start_time=SEC,
                   runtime=2 * SEC)
    common = _common(stop, cost)
    return Simulation(
        params=NetParams(
            latency_vv=torch.full((1, 1), LAT, dtype=torch.int64),
            reliability_vv=torch.ones((1, 1), dtype=torch.float32),
            bootstrap_end=0),
        handlers=app.handlers(), subs={PholdApp.SUB: app.init_sub()},
        initial_events=app.initial_events(),
        bulk_kinds=app.bulk_kinds() if bulk else None,
        matrix_handler=app.handle_msg_matrix if path == "matrix" else None,
        device="cpu", **common)


@pytest.fixture(scope="module")
def scenario_runs():
    """Each path's scenario run whole with ``run_stepwise`` by both
    packages (the JAX ones side by side), once for the tests that read
    it: {path: (port windows, port sim, JAX windows, JAX sim)}."""
    paths = ("loop", "bulk", "matrix")
    pairs = [(_jax_scenario(p), _port_scenario(p)) for p in paths]
    jwins, windows = run_all(pairs, lambda s: s.run_stepwise())
    return {p: (w, sim, jw, jsim) for p, (jsim, sim), jw, w
            in zip(paths, pairs, jwins, windows)}


@pytest.mark.parametrize("path", ["loop", "bulk", "matrix"])
def test_cpu_model_matches_jax(path, scenario_runs):
    windows, sim, jwin, jsim = scenario_runs[path]
    assert windows == jwin
    assert_runs_equal(jsim, sim)
    c = sim.counters()
    assert c["cpu_delay_applied"] > 0
    avail = sim.state.host.cpu_avail
    # the loaded hosts' CPU clocks run well past the free hosts'
    assert int(avail[3:].min()) > int(avail[:3].max()) + 200 * MS
    assert sim.state.host.cpu_cost.tolist() == COST.tolist()


def test_cpu_model_paths_and_stepwise_agree(scenario_runs):
    """The loop and matrix paths serialize alike (the JAX test's
    assertion); ``run_stepwise`` is ``run``, whole or from a cut; with
    every cost 0 the model is off and changes nothing."""
    (wl, lp), (wm, mx) = (scenario_runs[p][:2] for p in ("loop", "matrix"))
    cl, cm = lp.counters(), mx.counters()
    for k in ("cpu_delay_applied", "events_committed", "packets_sent"):
        assert cl[k] == cm[k] > 0, k
    assert torch.equal(lp.state.host.cpu_avail, mx.state.host.cpu_avail)
    assert lp.audit_chain() == mx.audit_chain()
    a = _port_scenario("matrix")
    b = _port_scenario("matrix")
    cut = SEC + 500 * MS
    assert a.run(until=cut) == b.run_stepwise(until=cut) > 0
    assert a.counters() == b.counters() != cm
    assert a.audit_chain() == b.audit_chain()
    assert torch.equal(a.state.host.cpu_avail, b.state.host.cpu_avail)
    a.run(), b.run_stepwise()
    for s in (a, b):
        assert s.audit_chain() == mx.audit_chain()
        assert s.counters()["cpu_delay_applied"] == cm["cpu_delay_applied"]
        assert torch.equal(s.state.host.cpu_avail, mx.state.host.cpu_avail)
    off = _port_scenario("matrix", cost=np.zeros(H, np.int64))
    none = _port_scenario("matrix", cost=None)
    assert not off.with_cpu and not none.with_cpu
    assert off.run() == none.run()
    assert off.counters() == none.counters()
    assert off.counters()["cpu_delay_applied"] == 0
    assert off.audit_chain() == none.audit_chain() != mx.audit_chain()


def _loaded_flood():
    """The flood with its server at 20 ms an event and its clients at
    60 ms."""
    cfg = _flood_cfg()
    cfg["hosts"]["server"]["cpu_ns_per_event"] = "20 ms"
    cfg["hosts"]["client"]["cpu_ns_per_event"] = "60 ms"
    return cfg


def _loaded_mixed():
    """The mixed flood with its eight far clients at 60 ms an event."""
    cfg = mixed_flood()
    cfg["hosts"]["far"]["cpu_ns_per_event"] = "60 ms"
    return cfg


@pytest.fixture(scope="module")
def flood_runs():
    """The loaded flood under ``run`` and the loaded mixed flood under
    ``run_optimistic``, each by both packages, the two JAX runs side by
    side: {name: (JAX sim, port sim, JAX result, port result)}."""
    jobs = {"flood": (_loaded_flood(), lambda s: s.run()),
            "mixed": (_loaded_mixed(), lambda s: s.run_optimistic())}
    pairs = {k: (jax_build(cfg), build_simulation(cfg, device="cpu"))
             for k, (cfg, _) in jobs.items()}
    with ThreadPoolExecutor(len(jobs)) as pool:
        refs = {k: pool.submit(run, pairs[k][0])
                for k, (_, run) in jobs.items()}
        got = {k: run(pairs[k][1]) for k, (_, run) in jobs.items()}
        return {k: (*pairs[k], refs[k].result(), got[k]) for k in jobs}


def test_cpu_model_udp_flood_matches_jax(flood_runs):
    """The server at 20 ms an event, and the clients at 60 ms against their
    50 ms timer, so their sends (the emitted history) run late."""
    jsim, sim, _, _ = flood_runs["flood"]
    assert_runs_equal(jsim, sim)
    c = sim.counters()
    assert c["cpu_delay_applied"] > 0 and c["packets_delivered"] > 0
    assert sim.obs_snapshot()["win"]["loop_dispatches"] > 0
    # a send every 60 ms for the clients' runtime of 1 s, not every 50 ms
    assert c["packets_sent"] < 3 * (SEC // (50 * MS))


def test_cpu_model_optimistic_matches_jax_and_rolls_back(flood_runs):
    """The mixed flood (speculative windows roll back on its loop path)
    with its eight far clients at 60 ms an event against a timer every
    40 ms: their sends fall behind. The loaded hosts receive from no other
    host, so no violation lands past a window (C4 cannot arise)."""
    jsim, sim, jres, res = flood_runs["mixed"]
    assert res == jres and res[1] > 0
    assert_runs_equal(jsim, sim)
    assert sim.counters()["cpu_delay_applied"] > 0
    # a rolled-back attempt leaves its base's CPU clocks as they were
    sim = build_simulation(_loaded_mixed(), device="cpu")
    cons = sim.runahead
    neg1 = torch.full((sim.num_hosts,), -1, dtype=torch.int64)
    sim.state = sim.state.with_host(done_t=neg1)
    ws = int(sim.state.pool.time.min())
    for _ in range(60):
        base = sim.state.snapshot()
        avail = base.host.cpu_avail
        before = avail.clone()
        st, mn, viol = sim.attempt(base, ws, ws + 8 * cons)
        if viol < NEVER and not torch.equal(st.host.cpu_avail, before):
            break
        sim.state = st.with_host(done_t=neg1)
        ws = mn
    assert viol < NEVER, "no attempt rolled back after moving a CPU clock"
    assert base.host.cpu_avail is avail and torch.equal(avail, before)


def test_cpu_model_optimistic_refuses_an_endless_retry():
    """ROADMAP.md C4: with the CPU model a destination's clock (done_t,
    the exec times) can run past a speculative window, so an emission at
    or after the window's end counts as a violation; the retried window
    is the same one, and the JAX package's driver retries it forever.
    The port raises there. Here: tests/test_optimistic.py's PHOLD with
    its two far hosts at 30 ms an event."""
    yaml = MIXED_YAML.replace(
        "  far:\n    quantity: 2\n",
        "  far:\n    quantity: 2\n    cpu_ns_per_event: 30000000\n")
    assert yaml != MIXED_YAML
    sim = build_simulation(yaml, device="cpu")
    with pytest.raises(RuntimeError, match="C4"):
        sim.run_optimistic()
    # the conservative driver runs it
    sim = build_simulation(yaml, device="cpu")
    sim.run()
    assert sim.counters()["cpu_delay_applied"] > 0


def _jax_forms(t, cost, avail, matrix):
    """Each JAX form (engine.py:1224-1254 and 904-966), one scalar at a
    time: (exec, cpu_avail, delay)."""
    H, W = t.shape
    ex = np.zeros_like(t)
    out = avail.copy()
    delay = 0
    for h in range(H):
        c, row, real = int(cost[h]), t[h], t[h] != NEVER
        if matrix:
            u = -(1 << 62)
            for k in range(W):
                if real[k]:
                    u = max(u, int(row[k]) - k * c)
                ex[h, k] = (max(u, int(avail[h])) + k * c if real[k]
                            else row[k])
            n = int(real.sum())
            last, busy = int(ex[h, max(n - 1, 0)]), n > 0
        else:
            prev = max(int(row[0]), int(avail[h]))
            ex[h, 0] = last = prev
            for k in range(1, W):
                # NEVER + cost wraps in int64
                nxt = (prev + c + (1 << 63)) % (1 << 64) - (1 << 63)
                prev = max(int(row[k]), nxt)
                ex[h, k] = prev
                if real[k]:
                    last = prev
            busy = bool(real[0])
        if busy:
            out[h] = last + c
        delay += int(np.where(real, ex[h] - row, 0).sum())
    return ex, out, delay


@pytest.mark.parametrize("matrix", [True, False])
def test_cpu_serialize_plain_matches_jax_forms(matrix):
    rs = np.random.default_rng(61)
    Hs, W = 64, 9
    t = np.sort(rs.integers(10**9, 10**9 + 50 * MS, (Hs, W)), axis=1)
    n = rs.integers(0, W + 1, Hs)
    t[np.arange(W)[None, :] >= n[:, None]] = NEVER  # empty tails
    t[0] = NEVER  # a host with nothing
    t[1, 3] = NEVER  # an empty cell between real ones
    cost = rs.choice([0, 1, 7 * MS, 10 * MS], Hs).astype(np.int64)
    cost[:8] = 0
    avail = np.where(rs.random(Hs) < 0.5, 0,
                     rs.integers(10**9, 10**9 + 200 * MS, Hs))
    avail[2] = 10**9 + 10 * SEC  # the CPU free past the window
    got = kernels.cpu_serialize_plain(*map(torch.from_numpy, (t, cost, avail)),
                                      matrix)
    ex, out, delay = _jax_forms(t, cost, avail, matrix)
    assert np.array_equal(got.exec_t.numpy(), ex)
    assert np.array_equal(got.cpu_avail.numpy(), out)
    assert int(got.delay) == delay > 0
    assert got.delay.dtype == torch.int64 and got.delay.dim() == 0
