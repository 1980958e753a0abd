"""PHOLD's hot-spot and local-span variants in the port, against the JAX
package.

* ``kernels.pick_dst`` in its three modes against the JAX package's
  jitted ``PholdApp._pick_dst`` (``ring_offset_dst`` for ``local_span``)
  on every draw the float32 uniform takes and the float32 values around
  each split (``chip_smoke.pick_sweep``). Jitted, XLA folds the hot
  split's divisions by constants into multiplies by float32 reciprocals
  (``kernels.hot_split``); a hot share whose reciprocal is inexact (0.3,
  0.6) shows the difference.
* Hot and local PHOLD runs on the matrix path and on the loop path (no
  matrix handler, the bulk batch on), the hot one with hot hosts past K
  (straggler passes): counters, audit chain and every state array equal.
* The variants' build checks, as the JAX package's ``PholdApp`` makes
  them.

Tolerance: exact equality everywhere.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import pick_sweep
from shadow_tpu.core.engine import Simulation as JSimulation
from shadow_tpu.net.apps import PholdApp as JPholdApp
from shadow_tpu.net.apps import ring_offset_dst
from shadow_tpu_torch import interop, kernels
from shadow_tpu_torch.core.engine import Simulation
from shadow_tpu_torch.core.state import NetParams
from shadow_tpu_torch.flagship import SELF_LOOP_50MS_GML
from shadow_tpu_torch.net.apps import PholdApp
from shadow_tpu_torch.sim import build_simulation
from test_engine_phold import make_params
from test_torch_phold import assert_states_equal, jax_state_to_numpy

MS = 1_000_000
SEC = 1_000_000_000


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The runs take many small ops; intra-op threads only add overhead
    at these widths."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("H,opts", [
    (1000, {}),
    (16384, {"hot_frac": 0.125, "hot_share": 0.5}),
    (1000, {"hot_frac": 0.13, "hot_share": 0.3}),
    (777, {"hot_frac": 0.3, "hot_share": 0.6}),
    (16384, {"local_span": 2}),
    (5, {"local_span": 4}),
])
def test_pick_matches_jax(H, opts):
    japp, app = JPholdApp(H, **opts), PholdApp(H, **opts)
    u, me = pick_sweep(H, app.hot_n, app.hot_share, app.local_span)
    want = np.asarray(jax.jit(japp._pick_dst)(jnp.asarray(u),
                                              jnp.asarray(me)))
    got = kernels.pick_dst(torch.from_numpy(u), torch.from_numpy(me), H,
                           **app.pick)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    if app.local_span:
        ring = jax.jit(lambda u, m: ring_offset_dst(u, m, app.local_span, H))
        assert np.array_equal(np.asarray(ring(u, me)), want)
    if app.hot_n:  # self-sends and both sides of the split are drawn
        assert (want < app.hot_n).any() and (want >= app.hot_n).any()


def _pair(opts, path, H=40, msgload=4, K=8, cost=None):
    """The same PHOLD shape in the JAX package and the port (uniform
    latency 50 ms, reliability 0.9, runtime 2 s, stop 3 s): the matrix
    path, or the loop path with the bulk batch (no matrix handler)."""
    seed, lat = 2024, 50 * MS
    japp = JPholdApp(H, msgload=msgload, size_bytes=64, start_time=SEC,
                     runtime=2 * SEC, **opts)
    app = PholdApp(H, msgload=msgload, size_bytes=64, start_time=SEC,
                   runtime=2 * SEC, **opts)
    common = dict(num_hosts=H, host_vertex=np.zeros(H, np.int32), seed=seed,
                  stop_time=3 * SEC, runahead=lat, event_capacity=4096, K=K,
                  B=4, O=K, payload_words=PholdApp.PAYLOAD_WORDS,
                  cpu_ns_per_event=cost)
    jsim = JSimulation(
        params=make_params(H, lat, 0.9), handlers=japp.handlers(),
        subs={JPholdApp.SUB: japp.init_sub()},
        initial_events=japp.initial_events(), bulk_kinds=japp.bulk_kinds(),
        matrix_handlers=japp.matrix_handlers() if path == "matrix" else None,
        **common)
    sim = Simulation(
        params=NetParams(
            latency_vv=torch.full((1, 1), lat, dtype=torch.int64),
            reliability_vv=torch.full((1, 1), 0.9, dtype=torch.float32),
            bootstrap_end=0),
        handlers=app.handlers(), subs={PholdApp.SUB: app.init_sub()},
        initial_events=app.initial_events(), bulk_kinds=app.bulk_kinds(),
        matrix_handler=app.handle_msg_matrix if path == "matrix" else None,
        device="cpu", **common)
    return jsim, sim


def run_both(jsim, sim, run):
    """Run both (the JAX one in a thread: XLA leaves the GIL); returns
    their results."""
    (ref,), (got,) = run_all([(jsim, sim)], run)
    return ref, got


def run_all(pairs, run, workers: int = 4):
    """Run every (JAX sim, port sim) pair: the JAX ones in threads, up to
    ``workers`` at once (XLA's compiles and runs leave the GIL), the port
    ones here meanwhile. Returns ([JAX results], [port results])."""
    with ThreadPoolExecutor(workers) as pool:
        refs = [pool.submit(run, jsim) for jsim, _ in pairs]
        got = [run(sim) for _, sim in pairs]
        return [r.result() for r in refs], got


def assert_runs_equal(jsim, sim):
    assert sim.counters() == jsim.counters()
    assert sim.audit_chain() == jsim.audit_chain()
    assert sim.obs_snapshot()["win"] == jsim.obs_snapshot()["win"]
    paths = interop.state_paths(sim.state)
    assert_states_equal(interop.state_to_numpy(sim.state),
                        jax_state_to_numpy(jsim.state, paths))


VARIANT_OPTS = [{"hot_frac": 0.1, "hot_share": 0.3}, {"local_span": 3}]
VARIANT_PATHS = ["matrix", "loop"]


@pytest.fixture(scope="module")
def variant_runs():
    """The four variant runs, each by both packages, the JAX ones side by
    side: {(opts index, path): (JAX sim, port sim, port windows)}."""
    keys = [(i, p) for i in range(len(VARIANT_OPTS)) for p in VARIANT_PATHS]
    pairs = [_pair(VARIANT_OPTS[i], p) for i, p in keys]
    _, windows = run_all(pairs, lambda s: s.run())
    return {k: (*pair, w) for k, pair, w in zip(keys, pairs, windows)}


@pytest.mark.parametrize("path", VARIANT_PATHS)
@pytest.mark.parametrize("opts", VARIANT_OPTS)
def test_variant_run_matches_jax(opts, path, variant_runs):
    jsim, sim, windows = variant_runs[(VARIANT_OPTS.index(opts), path)]
    assert_runs_equal(jsim, sim)
    win = sim.obs_snapshot()["win"]
    assert win["windows_run"] == windows
    assert win[f"{path}_dispatches"] == windows
    c = sim.counters()
    assert c["packets_dropped_loss"] > 0
    sub = sim.state.subs[PholdApp.SUB]
    # one window a runahead from 1 s to the stop, unless a host overflows K
    # and its leftovers step the window again
    slots = (3 * SEC - SEC) // (50 * MS) + 1
    if "hot_frac" in opts:
        assert windows > slots
        assert sub["received"][:4].min() > sub["received"][4:].max()
    else:
        assert windows <= slots


def test_variants_build_and_check_like_jax():
    """``build_simulation`` takes the variants from ``app_options``; the
    constructor's checks raise where the JAX package's do."""
    cfg = {
        "general": {"stop_time": 2, "seed": 3},
        "network": {"graph": {"type": "gml", "inline": SELF_LOOP_50MS_GML}},
        "hosts": {"h": {"quantity": 16, "app_model": "phold",
                        "app_options": {"hot_frac": 0.25,
                                        "hot_share": 0.5}}},
    }
    sim = build_simulation(cfg, device="cpu")
    assert (sim.app.hot_n, sim.app.local_span) == (4, 0)
    sim.run()
    assert sim.counters()["events_committed"] > 0
    for bad in ({"local_span": 2, "hot_frac": 0.1, "hot_share": 0.5},
                {"hot_frac": 0.1}, {"hot_share": 0.2},
                {"hot_frac": 0.1, "hot_share": 1.0},
                {"hot_frac": 1.5, "hot_share": 0.5},
                {"local_span": 16}, {"local_span": -1}):
        with pytest.raises(ValueError) as jerr:
            JPholdApp(16, **bad)
        with pytest.raises(ValueError, match=str(jerr.value)[:20]):
            PholdApp(16, **bad)
    assert PholdApp(16, hot_frac=0.01, hot_share=0.5).hot_n == 1
