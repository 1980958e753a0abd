"""The port's PHOLD flagship, run whole, against the JAX package and the
sequential heapq oracle.

* ``build_phold_flagship`` runs to the end in both packages: equal
  counters, audit chains, per-host digests, and the whole final state —
  every pool row (free rows included), host state, subs and obs block.
  The port also starts from the JAX package's state handed over mid-run
  (``shadow_tpu_torch.interop``) and must end in the same state.
* The matrix-path oracle cases of ``tests/test_engine_phold.py``, on the
  port: the same received/forwarded/sent/dropped counts and draw counters
  as ``phold_oracle``.

Tolerance: exact equality everywhere; the path is integer arithmetic and
float32 with a defined rounding.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from shadow_tpu.flagship import build_phold_flagship as jax_flagship
from shadow_tpu_torch import interop
from shadow_tpu_torch.core.engine import PoolExhausted, Simulation
from shadow_tpu_torch.core.state import KIND_APP_MSG, NetParams
from shadow_tpu_torch.flagship import build_phold_flagship
from shadow_tpu_torch.net.apps import PholdApp
from shadow_tpu_torch.sim import BuildError, build_simulation
from test_engine_phold import phold_oracle

MS = 1_000_000
SEC = 1_000_000_000


def jax_state_to_numpy(jstate, paths):
    """The JAX package's state flattened by the port's interop paths."""
    out = {}
    for path in paths:
        obj = jstate
        for part in path.split("."):
            obj = obj[part] if isinstance(obj, dict) else getattr(obj, part)
        out[path] = np.asarray(jax.device_get(obj))
    return out


def assert_states_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for path in want:
        g, w = got[path], want[path]
        assert g.dtype == w.dtype and g.shape == w.shape, path
        assert np.array_equal(g, w), path


@pytest.mark.parametrize("H,msgload", [(64, 2), (256, 4)])
def test_flagship_matches_jax_whole_and_from_midrun(H, msgload):
    kw = dict(msgload=msgload, stop_s=3)
    jsim = jax_flagship(H, **kw)
    port = build_phold_flagship(H, device="cpu", **kw)
    paths = interop.state_paths(port.state)
    # the same built state: baked paths, seeded pool, seq_next, keys
    assert_states_equal(interop.state_to_numpy(port.state),
                        jax_state_to_numpy(jsim.state, paths))
    assert np.array_equal(port.params.latency_vv.numpy(),
                          np.asarray(jsim.params.latency_vv))
    assert np.array_equal(port.params.reliability_vv.numpy(),
                          np.asarray(jsim.params.reliability_vv))

    def jax_run():
        jsim.run(until=2 * SEC)
        mid = jax_state_to_numpy(jsim.state, paths)
        jsim.run()
        return mid, jax_state_to_numpy(jsim.state, paths)

    # the JAX run spends its time in XLA, outside the GIL, so it runs in a
    # second thread beside the port's
    with ThreadPoolExecutor(1) as pool:
        ref = pool.submit(jax_run)
        windows = port.run()
        mid, want = ref.result()
    assert windows == port.counters()["micro_steps"] > 0
    assert port.counters() == jsim.counters()
    assert port.audit_chain() == jsim.audit_chain()
    snap, jsnap = port.obs_snapshot(), jsim.obs_snapshot()
    assert snap["win"] == jsnap["win"]
    for k in ("host_events", "host_last_t", "host_digest"):
        assert np.array_equal(snap[k], jsnap[k]), k
    assert_states_equal(interop.state_to_numpy(port.state), want)

    handed = build_phold_flagship(H, device="cpu", **kw)
    handed.state = interop.state_from_numpy(mid, "cpu")
    handed.run()
    assert_states_equal(interop.state_to_numpy(handed.state), want)
    assert handed.audit_chain() == jsim.audit_chain()


def _oracle_sim(H, seed, latency, rel, msgload, runtime, stop):
    app = PholdApp(H, msgload=msgload, size_bytes=64, start_time=SEC,
                   runtime=runtime)
    params = NetParams(
        latency_vv=torch.full((1, 1), latency, dtype=torch.int64),
        reliability_vv=torch.full((1, 1), rel, dtype=torch.float32),
        bootstrap_end=0,
    )
    sim = Simulation(
        num_hosts=H, params=params, host_vertex=np.zeros(H, np.int32),
        seed=seed, stop_time=stop, runahead=latency,
        handlers=app.handlers(), bulk_kinds=app.bulk_kinds(),
        matrix_handler=app.handle_msg_matrix, event_capacity=4096, K=16,
        subs={PholdApp.SUB: app.init_sub()},
        initial_events=app.initial_events(),
        payload_words=PholdApp.PAYLOAD_WORDS, device="cpu",
    )
    return sim


@pytest.mark.parametrize("H,seed,latency,rel,msgload,runtime,stop", [
    # test_phold_matches_oracle / test_phold_matrix_path_matches_oracle
    (5, 12345, 50 * MS, 1.0, 2, 5 * SEC, 10 * SEC),
    (5, 12345, 50 * MS, 0.8, 3, 5 * SEC, 10 * SEC),
    # test_phold_lossy_matches_oracle
    (4, 777, 10 * MS, 0.7, 3, 3 * SEC, 6 * SEC),
])
def test_phold_matches_oracle(H, seed, latency, rel, msgload, runtime, stop):
    sim = _oracle_sim(H, seed, latency, rel, msgload, runtime, stop)
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
    assert c["bulk_contract_violations"] == 0
    assert sim.state.host.rng_counter.tolist() == oracle["rng_counters"]
    # one pass per window: the matrix path ran every window
    assert c["micro_steps"] == windows > 0


def test_port_refuses_what_it_does_not_run():
    """Shapes the JAX package refuses, and paths the port does not have
    yet, raise at build instead of running something else."""
    with pytest.raises(BuildError, match="outbox_slots"):
        build_phold_flagship(40, msgload=2, K=3, device="cpu")
    # islands build, and refuse what the port does not run under them:
    # run() under async islands (the JAX default), shard_map, the loop
    # path (and its NIC tallies) and rebalancing, each naming its
    # ROADMAP.md item
    isl = build_phold_flagship(64, num_shards=2, device="cpu")
    with pytest.raises(NotImplementedError, match="A 9, the async driver"):
        isl.run()
    with pytest.raises(NotImplementedError, match="A 9, the loop path"):
        isl.host_trackers()
    with pytest.raises(NotImplementedError, match="A 9, balancer and mesh"):
        build_phold_flagship(64, num_shards=2, island_mode="shard_map",
                             device="cpu")
    flood = {
        "general": {"stop_time": 2},
        "network": {"graph": {"type": "1_gbit_switch"}},
        "experimental": {"num_shards": 2, "event_capacity": 4096},
        "hosts": {"s": {"app_model": "udp_flood",
                        "app_options": {"role": "server"}},
                  "c": {"quantity": 3, "app_model": "udp_flood"}},
    }
    with pytest.raises(NotImplementedError, match="A 9, the loop path"):
        build_simulation(flood, device="cpu")
    with pytest.raises(NotImplementedError, match="A 9, balancer and mesh"):
        build_simulation({
            "general": {"stop_time": 2},
            "network": {"graph": {"type": "1_gbit_switch"}},
            "experimental": {"num_shards": 2, "rebalance": True,
                             "event_capacity": 4096},
            "hosts": {"h": {"quantity": 4, "app_model": "phold"}},
        }, device="cpu")
    with pytest.raises(BuildError, match="A 6"):
        build_simulation({
            "general": {"stop_time": 2},
            "network": {"graph": {"type": "1_gbit_switch"}},
            "experimental": {"pool_gears": 2},
            "hosts": {"h": {"quantity": 2, "app_model": "phold",
                            "app_options": {"hot_frac": 0.5,
                                            "hot_share": 0.5}}},
        }, device="cpu")
    # occupancy at the spill mark, where the JAX package would spill
    sim = build_phold_flagship(64, msgload=2, event_capacity=140,
                               device="cpu")
    with pytest.raises(PoolExhausted, match="spill"):
        sim.run()
    # a window holding an event of a kind without a handler takes the
    # loop path, which commits it without running anything (the JAX
    # package's engine does the same)
    sim = _oracle_sim(4, 1, 50 * MS, 1.0, 1, SEC, 3 * SEC)
    sim.state.pool.kind[0] = KIND_APP_MSG + 1
    sim.run()
    win = sim.obs_snapshot()["win"]
    assert win["loop_dispatches"] == 1
    assert win["matrix_dispatches"] == win["windows_run"] - 1
    assert sim.counters()["events_committed"] == int(
        sim.state.subs[PholdApp.SUB]["received"].sum()) + 1
    with pytest.raises(BuildError, match="ROADMAP"):
        build_simulation({
            "general": {"stop_time": 2},
            "network": {"graph": {"type": "1_gbit_switch"}},
            "experimental": {"flight_recorder": 8},
            "hosts": {"h": {"quantity": 2, "app_model": "phold",
                            "cpu_ns_per_event": 1000}},
        }, device="cpu")
