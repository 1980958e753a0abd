"""The port's optimistic driver (``Simulation.run_optimistic``) and the
four kernels of its path (``spec_check``, ``nic_refill``,
``send_dequeue``, ``link_send``) against the JAX package.

* ``tests/test_optimistic.py``'s global-engine cases on the port:
  ``MIXED_YAML`` (asymmetric latencies force rollbacks) with the adaptive
  and the fixed factor, and the uniform-latency variant (no rollbacks),
  each against a JAX ``run_optimistic`` of the same YAML: windows,
  rollbacks, counters, window-plane counters, audit chain and every state
  array (``xmit_min`` among them); the same results as the port's own
  conservative run; a forged violation in a conservative-width window
  raises "refusing to commit".
* Optimistic ``udp_flood`` runs against goldens from the JAX package
  (``GOLDEN``; a JAX compile of the flood's attempt takes ≈40 s on a CPU,
  so they are pinned): BASELINE config 4's shape at 64 hosts, and a
  flood over ``MIXED_YAML``'s graph, whose rollbacks take the loop path.
  The same floods with JAX live are marked ``slow``.
* A rolled-back attempt leaves its snapshot as it was: every tensor of
  the base state the same object, with the same version and values.
* The four kernels' plain versions against the JAX functions on seeded
  synthetic inputs: NEVER lanes, filler destinations, token debt, long
  idle gaps, wrapped ring heads, unreachable pairs, control packets,
  bootstrap lanes and loss 0.5.

Tolerance: exact equality everywhere (integer arithmetic and float32
draws with a defined rounding).
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_tpu.core import rng as jrng
from shadow_tpu.core import state as jstate
from shadow_tpu.core.engine import Emitter as JEmitter
from shadow_tpu.net import link as jlink
from shadow_tpu.net import nic as jnic
from shadow_tpu.net.qdisc import FifoDiscipline as JFifo
from shadow_tpu.sim import build_simulation as jax_build
from shadow_tpu_torch import interop, kernels
from shadow_tpu_torch.core import rng as trng
from shadow_tpu_torch.core import state as tstate
from shadow_tpu_torch.core.engine import Emitter, PoolExhausted, Simulation
from shadow_tpu_torch.core.simtime import NEVER
from shadow_tpu_torch.core.state import KIND_APP_TIMER, NetParams
from shadow_tpu_torch.net import link as tlink
from shadow_tpu_torch.net import nic as tnic
from shadow_tpu_torch.net.qdisc import FifoDiscipline
from shadow_tpu_torch.sim import build_simulation
from chip_smoke import MIXED_GML, config4, mixed_flood, tensors_of
from test_optimistic import MIXED_YAML
from test_torch_phold import assert_states_equal, jax_state_to_numpy

MS = 1_000_000


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The runs are many small ops; intra-op threads only add overhead."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# whole optimistic runs
# ---------------------------------------------------------------------------

UNIFORM_YAML = MIXED_YAML.replace('latency "50 ms"', 'latency "10 ms"')
# (yaml, window_factor, adaptive)
CASES = {
    "mixed_adaptive": (MIXED_YAML, 8, True),
    "mixed_fixed": (MIXED_YAML, 8, False),
    "uniform_adaptive": (UNIFORM_YAML, 8, True),
}


@pytest.fixture(scope="module")
def runs():
    """Each case run once by both packages (and the port's conservative
    run of each YAML)."""
    out = {}
    for name, (yaml, factor, adaptive) in CASES.items():
        port = build_simulation(yaml, device="cpu")
        res = port.run_optimistic(window_factor=factor, adaptive=adaptive)
        jsim = jax_build(yaml)
        jres = jsim.run_optimistic(window_factor=factor, adaptive=adaptive)
        out[name] = (port, res, jsim, jres)
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_optimistic_matches_jax(runs, name):
    port, (windows, rollbacks), jsim, jres = runs[name]
    assert (windows, rollbacks) == jres
    if name.startswith("mixed"):
        assert rollbacks > 0
    else:
        assert rollbacks == 0
    assert port.counters() == jsim.counters()
    assert port.audit_chain() == jsim.audit_chain()
    assert port.obs_snapshot()["win"] == jsim.obs_snapshot()["win"]
    paths = interop.state_paths(port.state)
    assert "xmit_min" in paths
    assert_states_equal(interop.state_to_numpy(port.state),
                        jax_state_to_numpy(jsim.state, paths))


def test_adaptive_rolls_back_no_more_than_fixed(runs):
    assert 0 < runs["mixed_adaptive"][1][1] <= runs["mixed_fixed"][1][1]


def _fingerprint(sim):
    """Counters and sub-states without the schedule's own counts
    (``tests/test_optimistic.py:_final_fingerprint``)."""
    c = sim.counters()
    for k in ("pool_overflow_dropped", "micro_steps", "outbox_stall_deferred",
              "exchange_sent", "exchange_deferred"):
        c.pop(k)
    subs = {k: v for k, v in interop.state_to_numpy(sim.state).items()
            if k.startswith("subs.")}
    return c, subs


@pytest.mark.parametrize("name", ["mixed_adaptive", "uniform_adaptive"])
def test_optimistic_equals_conservative(runs, name):
    port = runs[name][0]
    cons = build_simulation(CASES[name][0], device="cpu")
    cons.run()
    (c1, s1), (c2, s2) = _fingerprint(cons), _fingerprint(port)
    assert c1 == c2
    assert_states_equal(s2, s1)
    assert cons.audit_chain() == port.audit_chain()


def _noop_sim():
    """``tests/test_optimistic.py:_noop_sim``: 8 hosts, a no-op timer
    handler, 200 events over 200 runaheads."""
    H = 8
    initial = [((i + 1) * MS, i % H, (i + 3) % H, KIND_APP_TIMER, [0])
               for i in range(200)]
    params = NetParams(latency_vv=torch.full((1, 1), MS, dtype=torch.int64),
                       reliability_vv=torch.ones((1, 1)), bootstrap_end=0)
    return Simulation(
        num_hosts=H, handlers={KIND_APP_TIMER: lambda st, ev, em, p: st},
        params=params, host_vertex=np.zeros(H, np.int32), seed=1,
        stop_time=300 * MS, runahead=MS, event_capacity=512, K=32,
        initial_events=initial, device="cpu",
    )


def test_floor_width_violation_refuses_commit():
    """A violation reported inside a conservative-width window means the
    invariant broke: the driver raises instead of committing."""
    sim = _noop_sim()
    sim.attempt = lambda base, ws, we: (base, we, ws)
    with pytest.raises(RuntimeError, match="refusing to commit"):
        sim.run_optimistic(window_factor=1)
    # unforged, the pre-scheduled work commits long windows
    opt, cons = _noop_sim(), _noop_sim()
    windows, rollbacks = opt.run_optimistic(window_factor=64)
    assert rollbacks == 0 and windows <= cons.run() / 8
    assert opt.audit_chain() == cons.audit_chain()


def test_rolled_back_attempt_leaves_snapshot_untouched():
    """Step MIXED_YAML's windows as the driver does, outside inference
    mode so every tensor keeps its version counter, until an attempt rolls
    back; that attempt changed no tensor of its base and replaced none."""
    sim = build_simulation(MIXED_YAML, device="cpu")
    cons = sim.runahead
    neg1 = torch.full((sim.num_hosts,), -1, dtype=torch.int64)
    sim.state = sim.state.with_host(done_t=neg1)
    ws = int(sim.state.pool.time.min())
    for _ in range(50):
        base = sim.state.snapshot()
        before = {p: (t, t._version, t.clone())
                  for p, t in tensors_of(base).items()}
        st, mn, viol = sim.attempt(base, ws, ws + 8 * cons)
        if viol < NEVER:
            break
        sim.state = st.with_host(done_t=neg1)
        ws = mn
    assert viol < NEVER, "no attempt rolled back"
    after = tensors_of(base)
    assert sorted(after) == sorted(before)
    for p, (t, version, value) in before.items():
        assert after[p] is t, p
        assert t._version == version, p
        assert torch.equal(t, value), p
    # the attempt's own state moved on
    assert int(st.counters.events_committed) > int(
        base.counters.events_committed)


# ---------------------------------------------------------------------------
# optimistic floods against the JAX package's goldens
# ---------------------------------------------------------------------------


def test_mixed_gml_is_test_optimistic_graph():
    """``chip_smoke.MIXED_GML`` (the mixed runs' graph, which the card's
    tests import without JAX) is ``MIXED_YAML``'s."""
    inline = MIXED_YAML.split("inline: |\n", 1)[1].split("experimental:")[0]
    strip = lambda g: [ln.strip() for ln in g.splitlines()  # noqa: E731
                       if ln.strip()]
    assert strip(inline) == strip(MIXED_GML)


FLOODS = {"config4_64": lambda: config4(64), "mixed_flood": mixed_flood}

# JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/test_torch_optimistic.py
# (the JAX package's build_simulation, then run_optimistic())
GOLDEN = {
    "config4_64": {
        "windows": 25, "rollbacks": 0,
        "chain": 0x71612FD8D95A7F34,
        "counters": {
            "bulk_contract_violations": 0, "bytes_delivered": 2_865_152,
            "bytes_sent": 2_945_600, "cpu_delay_applied": 0,
            "events_committed": 5598, "events_emitted": 5598,
            "exchange_deferred": 0, "exchange_sent": 0,
            "inbox_overflow_deferred": 0, "micro_steps": 200,
            "outbox_overflow_dropped": 0, "outbox_stall_deferred": 0,
            "packets_delivered": 2798, "packets_dropped_loss": 2,
            "packets_dropped_unreachable": 0, "packets_sent": 2800,
            "pool_overflow_dropped": 0
        },
        "win": {
            "windows_run": 75, "matrix_dispatches": 0, "loop_dispatches": 75,
            "window_shrinks": 0, "rollbacks": 0, "opt_stalls": 0,
            "spill_fires": 0, "gear_shifts": 0, "fault_actions": 0
        },
        "digest": "419360eeedb91916",
    },
    "mixed_flood": {
        "windows": 25, "rollbacks": 5,
        "chain": 0x297D13156060D542,
        "counters": {
            "bulk_contract_violations": 0, "bytes_delivered": 350_208,
            "bytes_sent": 368_200, "cpu_delay_applied": 0,
            "events_committed": 692, "events_emitted": 700,
            "exchange_deferred": 0, "exchange_sent": 0,
            "inbox_overflow_deferred": 0, "micro_steps": 54,
            "outbox_overflow_dropped": 0, "outbox_stall_deferred": 0,
            "packets_delivered": 342, "packets_dropped_loss": 0,
            "packets_dropped_unreachable": 0, "packets_sent": 350,
            "pool_overflow_dropped": 0
        },
        "win": {
            "windows_run": 26, "matrix_dispatches": 0, "loop_dispatches": 26,
            "window_shrinks": 5, "rollbacks": 5, "opt_stalls": 0,
            "spill_fires": 0, "gear_shifts": 0, "fault_actions": 0
        },
        "digest": "17f2ac9338867866",
    },
}


def state_digest(arrays: dict) -> str:
    """A digest of every state array: path, dtype, shape and bytes."""
    h = hashlib.sha256()
    for path in sorted(arrays):
        a = np.ascontiguousarray(arrays[path])
        h.update(f"{path}:{a.dtype.str}:{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()[:16]


def summary(windows, rollbacks, counters, win, chain, arrays) -> dict:
    return {"windows": windows, "rollbacks": rollbacks, "chain": chain,
            "counters": counters, "win": win,
            "digest": state_digest(arrays)}


@pytest.mark.parametrize("name", sorted(FLOODS))
def test_optimistic_flood_matches_jax_golden(name):
    sim = build_simulation(FLOODS[name](), device="cpu")
    windows, rollbacks = sim.run_optimistic()
    got = summary(windows, rollbacks, sim.counters(),
                  sim.obs_snapshot()["win"], sim.audit_chain(),
                  interop.state_to_numpy(sim.state))
    assert got == GOLDEN[name]
    if name == "mixed_flood":
        assert rollbacks > 0
        assert got["win"]["matrix_dispatches"] == 0


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(FLOODS))
def test_optimistic_flood_matches_jax_live(name):
    """The same floods with the JAX package run live: its summary equals
    both the port's and the pinned golden."""
    sim = build_simulation(FLOODS[name](), device="cpu")
    windows, rollbacks = sim.run_optimistic()
    got = summary(windows, rollbacks, sim.counters(),
                  sim.obs_snapshot()["win"], sim.audit_chain(),
                  interop.state_to_numpy(sim.state))
    assert got == jax_golden(name) == GOLDEN[name]


def test_undersized_pool_raises_instead_of_spinning():
    """Config 4's shape at 64 hosts with a pool of 128 rows (the staged
    2^17 rows at 50,176 hosts are short the same way): a speculative
    window's inflow, about three rows a client, finds no headroom, the
    pool-headroom gate stalls every host and a sub-step commits nothing.
    The JAX package's attempt loop spins there; the port raises."""
    sim = build_simulation(config4(64, event_capacity=128), device="cpu")
    with pytest.raises(PoolExhausted, match="committed nothing"):
        sim.run_optimistic()


def test_config4_experimental_keys_build():
    """Config 4's experimental keys reach the engine and the stack."""
    sim = build_simulation(config4(64), device="cpu")
    assert (sim.K, sim.O, sim.B) == (12, 8, 4)
    assert sim.state.pool.capacity == 1 << 17
    assert sim.state.subs["router"].q_src.shape == (64, 16)
    assert sim.matrix_handler is None


# ---------------------------------------------------------------------------
# the kernels' plain versions against the JAX functions
# ---------------------------------------------------------------------------


def _jax_xmit(bt, bd, bs, done_t):
    """The global engine's check, as ``shadow_tpu/core/engine.py`` writes
    it in the loop path's ``finish``."""
    H = done_t.shape[0]
    cross = (bd != bs) & (bt != NEVER)
    dst_last = done_t[jnp.clip(bd, 0, H - 1)]
    violates = cross & (bt <= dst_last)
    return jnp.min(jnp.where(violates, bt, NEVER))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_spec_check_plain_matches_jax(seed):
    rs = np.random.default_rng(seed)
    H, N = 40, 600
    done_t = rs.integers(-1, 400 * MS, H)
    done_t[:5] = -1
    t = rs.integers(0, 500 * MS, N)
    t[rs.random(N) < 0.2] = NEVER
    dst = rs.integers(0, H, N).astype(np.int32)
    # filler destinations outside [0, H) read the clipped clock
    dst[rs.random(N) < 0.1] = rs.choice([-3, -1, H, H + 7])
    src = np.where(rs.random(N) < 0.2, dst, rs.integers(0, H, N)).astype(
        np.int32)
    if seed == 2:  # none behind its clock
        t = np.where(t == NEVER, NEVER, 500 * MS + t)
    want = int(_jax_xmit(jnp.asarray(t), jnp.asarray(dst), jnp.asarray(src),
                         jnp.asarray(done_t)))
    got = kernels.spec_check_plain(_t(t), _t(dst), _t(src), _t(done_t))
    assert got.dtype == torch.int64 and got.shape == ()
    assert int(got) == want
    assert (want == NEVER) == (seed == 2)


def test_nic_refill_plain_matches_jax():
    rs = np.random.default_rng(5)
    H = 64
    refill = rs.integers(1, 200_000, H)
    cap = refill + 1500
    rem = rs.integers(-50_000, 200_000, H)  # token debt too
    tick = rs.integers(0, 5_000, H)
    nows = [
        rs.integers(0, 6_000 * MS, H),
        # long idle gaps, and NEVER lanes whose product wraps
        np.where(rs.random(H) < 0.3, NEVER,
                 tick * MS + rs.integers(0, 10**15, H)),
        np.int64(2_500 * MS),  # one value for every host (the bulk gate)
    ]
    for now in nows:
        for mask in (None, rs.random(H) < 0.6):
            j = jnic.lazy_refill(*(jnp.asarray(a) for a in
                                   (rem, tick, refill, cap, now)),
                                 None if mask is None else jnp.asarray(mask))
            tn = kernels.nic_refill_plain(
                _t(rem), _t(tick), _t(refill), _t(cap), torch.as_tensor(now),
                None if mask is None else _t(mask))
            for g, w in zip(tn, j):
                assert np.array_equal(g.numpy(), np.asarray(w))
            rem, tick = tn[0].numpy(), tn[1].numpy()


@pytest.mark.parametrize("seed", [3, 4])
def test_send_dequeue_plain_matches_jax(seed):
    rs = np.random.default_rng(seed)
    H, NQ, P = 48, 8, 12
    head = rs.integers(0, 3 * NQ, H).astype(np.int32)
    head[:3] = [2**31 - 2 * NQ, 0, NQ - 1]
    tail = (head + rs.integers(0, NQ + 1, H)).astype(np.int32)
    fields = dict(
        q_payload=rs.integers(-2**31, 2**31, (H, NQ, P)).astype(np.int32),
        q_dst=rs.integers(0, H, (H, NQ)).astype(np.int32),
        q_head=head, q_tail=tail,
    )
    want_mask = rs.random(H) < 0.7
    bw = np.full(H, 10**9, np.int64)
    jsub = jnic.init(jnp.asarray(bw), jnp.asarray(bw), NQ, payload_words=P)
    jsub = jsub.replace(**{k: jnp.asarray(v) for k, v in fields.items()})
    tsub = tnic.init(bw, bw, NQ, payload_words=P)
    tsub = tsub.replace(**{k: _t(v) for k, v in fields.items()})

    class _J:
        subs = {"nic": jsub}

        def with_sub(self, key, value):
            return value

    jn, jdo, jpl, jdst = JFifo().dequeue(_J(), jnp.int64(0),
                                         jnp.asarray(want_mask))
    ts = tstate.SimState(now=0, pool=None, host=None, counters=None,
                         rng_keys=None, subs={"nic": tsub})
    ts, tdo, tpl, tdst = FifoDiscipline().dequeue(ts, 0, _t(want_mask),
                                                 kernels.PLAIN_OPS)
    for g, w in ((tdo, jdo), (tpl, jpl), (tdst, jdst),
                 (ts.subs["nic"].q_head, jn.q_head)):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype and np.array_equal(g.numpy(), w)
    assert tdo.any() and (want_mask & (tail == head)).any()


def _link_params(kind: str):
    """(latency [U, U], reliability [U, U], vertex of each host, whether
    the global vertex table is given) for a topology kind."""
    H = 48
    if kind == "single":
        return (np.full((1, 1), 10 * MS, np.int64),
                np.full((1, 1), 0.5, np.float32), np.zeros(H, np.int32))
    U = 3
    lat = np.array([[10, 40, NEVER], [40, 20, 60], [NEVER, 60, 30]],
                   np.int64)
    lat = np.where(lat == NEVER, NEVER, lat * MS)
    rel = np.array([[0.5, 0.9, 1.0], [0.9, 0.25, 0.5], [1.0, 0.5, 0.75]],
                   np.float32)
    return lat, rel, (np.arange(H) % U).astype(np.int32)


@pytest.mark.parametrize("kind", ["single", "multi_table", "multi_own"])
def test_link_send_matches_jax(kind):
    rs = np.random.default_rng(len(kind))
    H, P, seed, boot = 48, 12, 21, 1_000 * MS
    lat, rel, vertex = _link_params(kind)
    table = kind == "multi_table"
    mask = rs.random(H) < 0.8
    dst = rs.integers(0, H, H).astype(np.int32)
    # lanes that send nothing may carry any destination: JAX's gather
    # counts a negative one from the end, then clips
    odd = np.flatnonzero(~mask)[:4]
    dst[odd] = [-1, -H - 3, H + 5, -7][:len(odd)]
    now = rs.integers(boot - 50 * MS, boot + 50 * MS, H)
    size = np.where(rs.random(H) < 0.2, 0, rs.integers(1, 1500, H))
    control = rs.random(H) < 0.15
    payload = rs.integers(-2**31, 2**31, (H, P)).astype(np.int32)
    ctr = rs.integers(0, 2**32, H, dtype=np.int64)
    ctr[:2] = [2**32 - 1, 2**32 - 2]

    jparams = jstate.NetParams(
        latency_vv=jnp.asarray(lat), reliability_vv=jnp.asarray(rel),
        bootstrap_end=jnp.int64(boot),
        vertex_g=jnp.asarray(vertex) if table else None)
    jhost = jstate.make_host_state(H, vertex).replace(
        rng_counter=jnp.asarray(ctr.astype(np.uint32)))
    js = jstate.SimState(
        now=jnp.int64(0), pool=jstate.EventPool.empty(8, P), host=jhost,
        counters=jstate.Counters.zeros(), rng_keys=jrng.host_keys(seed, H))
    jem = JEmitter()
    js = jlink.send(js, jem, jnp.asarray(mask), jnp.asarray(dst),
                    jnp.asarray(now), 3, jnp.asarray(payload), jparams,
                    jnp.asarray(size), control_mask=jnp.asarray(control))

    tparams = NetParams(latency_vv=_t(lat), reliability_vv=_t(rel),
                        bootstrap_end=boot,
                        vertex_g=_t(vertex) if table else None)
    th = tstate.make_host_state(H, vertex)
    th.rng_counter = _t(ctr)
    ts = tstate.SimState(now=0, pool=tstate.EventPool.empty(8, P), host=th,
                         counters=tstate.Counters.zeros(),
                         rng_keys=trng.host_keys(seed, H))
    tem = Emitter(kernels.PLAIN_OPS)
    ts = tlink.send(ts, tem, _t(mask), _t(dst), _t(now), 3, _t(payload),
                    tparams, _t(size), control_mask=_t(control))

    (jr,), (tr,) = jem.records, tem.records
    for f in ("mask", "time", "dst", "kind", "payload"):
        g, w = getattr(tr, f).numpy(), np.asarray(getattr(jr, f))
        assert g.dtype == w.dtype and np.array_equal(g, w), f
    assert np.array_equal(ts.host.rng_counter.numpy(),
                          np.asarray(js.host.rng_counter).astype(np.int64))
    tc, jc = ts.counters, js.counters
    for k in ("packets_sent", "packets_dropped_loss",
              "packets_dropped_unreachable", "bytes_sent"):
        assert int(getattr(tc, k)) == int(getattr(jc, k)), k
    # the inputs took every branch
    assert int(jc.packets_dropped_loss) > 0
    assert (int(jc.packets_dropped_unreachable) > 0) == (kind != "single")


def jax_golden(name: str) -> dict:
    jsim = jax_build(FLOODS[name]())
    windows, rollbacks = jsim.run_optimistic()
    port = build_simulation(FLOODS[name](), device="cpu")
    arrays = jax_state_to_numpy(jsim.state, interop.state_paths(port.state))
    return summary(windows, rollbacks, jsim.counters(),
                   jsim.obs_snapshot()["win"], jsim.audit_chain(), arrays)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    for name in FLOODS:
        print(f"    {name!r}: {jax_golden(name)!r},", flush=True)
