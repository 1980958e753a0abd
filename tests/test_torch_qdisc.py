"""The port's device-queue disciplines (pifo, eiffel) against the JAX
package.

* ``qdisc_enqueue_plain`` and ``qdisc_dequeue_plain`` against the JAX
  disciplines' jitted ``enqueue`` and ``dequeue`` on random planes made
  with numpy (``chip_smoke.synthetic_qdisc_plane``: 64 hosts, 8 slots,
  three classes, empty and full rows): steps of enqueues and dequeues
  over both disciplines, the three rankers, shaping on and off and the
  three drop policies; every field of the plane, ``ok``, ``have`` and
  the packet handed up must be equal after every step.
* RED's inter-drop interval against the jitted ``red_enqueue`` for every
  average in [0, Q << 8] (XLA folds the division by the constant span
  into a multiply by its reciprocal; ``RedConfig.scale`` is that
  constant).
* Whole runs: ``configs/incast.yaml`` (pifo, wfq, RED),
  ``configs/bufferbloat.yaml`` (pifo, CoDel) cut to 1.5 s of its 8,
  ``tests/test_qdisc.py``'s overload flood under eiffel with wfq and
  codel cut to 2 s of its 3, and under pifo with wfq and codel through
  ``run_optimistic()`` the 16-host mixed flood at 200 Kbit (the overload
  flood's speculative windows roll back none; this one rolls back 4):
  windows, rollbacks, counters (micro-steps among them), audit chain, a
  digest of every ``subs["qdisc"]`` array and one of every state array
  equal to the JAX package's, pinned (``python
  tests/test_torch_qdisc.py`` prints them from the JAX package, ≈2 min;
  ``-m slow`` reruns them with JAX live and compares the states array by
  array).

Tolerance: exact equality everywhere (integer arithmetic; RED's interval
and the CoDel control law are float64 with the JAX package's rounding).
"""

import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from shadow_tpu.net.qdisc import drops as jdrops
from shadow_tpu.sim import build_simulation as jax_build
from shadow_tpu.net.qdisc import ranks as jranks
from shadow_tpu.net.qdisc.eiffel import EiffelDiscipline as JEiffel
from shadow_tpu.net.qdisc.pifo import PifoDiscipline as JPifo
from chip_smoke import (
    QDISC_CASES,
    mixed_flood,
    qdisc_discipline,
    synthetic_qdisc_plane,
)
from shadow_tpu_torch import interop, kernels
from shadow_tpu_torch.net.qdisc import drops
from shadow_tpu_torch.sim import build_simulation
from test_qdisc import _overload_cfg
from test_torch_cuda import qdisc_steps
from test_torch_optimistic import state_digest
from test_torch_phold import assert_states_equal, jax_state_to_numpy

MS = 1_000_000
SEC = 1_000_000_000
H, Q = 64, 8
NEVER = np.iinfo(np.int64).max
JAX_MODULES = (jranks, jdrops, JPifo, JEiffel)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _State:
    """The JAX disciplines' view of a SimState: the subs and with_sub."""

    def __init__(self, subs):
        self.subs = subs

    def with_sub(self, key, val):
        return _State({**self.subs, key: val})


def _jax_steps(jd):
    def enq(qd, mask, dst, payload, now):
        st, ok = jd.enqueue(_State({"qdisc": qd}), mask, dst, payload, now)
        return st.subs["qdisc"], ok

    def deq(qd, now, want):
        st, have, payload, dst = jd.dequeue(_State({"qdisc": qd}), now, want)
        return st.subs["qdisc"], have, payload, dst

    return jax.jit(enq), jax.jit(deq)


@pytest.mark.parametrize("case", QDISC_CASES)
def test_plain_matches_jax_discipline_steps(case):
    disc, rank, shaped, drop = case
    td = qdisc_discipline(*case, H, Q, "cpu")
    jd = qdisc_discipline(*case, H, Q, "cpu", modules=JAX_MODULES)
    names = td.spec.names
    enq, deq = _jax_steps(jd)
    rs = np.random.default_rng(100 + QDISC_CASES.index(case))
    plane = synthetic_qdisc_plane(rs, disc, 2 * SEC, H, Q)
    jqd = [{k: jnp.asarray(v) for k, v in plane.items()}]

    def check(kind, fields, args, want):
        a = [jnp.asarray(x.numpy()) for x in args]
        if kind == "enqueue":
            jqd[0], ok = enq(jqd[0], *a)
            outs = [(want.ok, ok)]
        else:
            jqd[0], have, payload, dst = deq(jqd[0], *a)
            outs = [(want.have, have), (want.payload, payload),
                    (want.dst, dst)]
        for g, w in outs:
            assert np.array_equal(g.numpy(), np.asarray(w)), kind
        for name, g in zip(names, want.fields):
            w = np.asarray(jqd[0][name])
            assert g.numpy().dtype == w.dtype, (kind, name)
            assert np.array_equal(g.numpy(), w), (kind, name)

    seen = qdisc_steps(rs, td, plane, 2 * SEC, 9, check)
    assert {"enqueued", "dequeued"} <= seen
    # the steps took the case's branches
    final = jax.device_get(jqd[0])
    moved = {n for n in names if not np.array_equal(final[n], plane[n])}
    want_moved = {"drops_overflow", {"none": "sojourn_sum", "red": "drops_red",
                                     "codel": "drops_codel"}[drop]}
    want_moved |= {"shape_next"} if shaped else set()
    want_moved |= {"finish"} if rank == "wfq" else set()
    assert want_moved <= moved


@pytest.mark.parametrize("slots,max_p", [(8, 0.3), (10, 0.1), (32, 0.1),
                                         (13, 0.07)])
def test_red_interval_matches_jitted_jax_at_every_average(slots, max_p):
    jred = jdrops.RedConfig(slots, 0.25, 0.75, max_p)
    red = drops.RedConfig(slots, 0.25, 0.75, max_p)
    avg = np.arange((slots << 8) + 1, dtype=np.int64)

    @jax.jit
    def interval(a):
        qd = {"red_avg": a, "red_count": jnp.zeros_like(a),
              "drops_red": jnp.zeros_like(a)}
        p = jred.max_p * (a - jred.min_fp).astype(jnp.float64) / float(
            jred.max_fp - jred.min_fp)
        n = jnp.ceil(1.0 / jnp.maximum(p, 1e-9)).astype(jnp.int64)
        # the whole step too: at count n - 1 the ramp drops exactly where
        # the interval is reached
        qd = dict(qd, red_count=jnp.maximum(n - 2, 0))
        _, drop = jdrops.red_enqueue(qd, jnp.ones(a.shape, bool),
                                     a >> 8, jred)
        return n, drop

    want_n, want_drop = (np.asarray(x) for x in interval(jnp.asarray(avg)))
    got_n = drops.red_interval(torch.as_tensor(avg), red).numpy()
    assert np.array_equal(got_n, want_n)
    qd = {"red_avg": torch.as_tensor(avg),
          "red_count": torch.as_tensor(np.maximum(want_n - 2, 0)),
          "drops_red": torch.zeros(avg.shape, dtype=torch.int64)}
    drop = drops.red_enqueue(qd, torch.ones(avg.shape, dtype=torch.bool),
                             torch.as_tensor(avg >> 8), red)
    assert np.array_equal(drop.numpy(), want_drop)
    assert want_drop.any() and not want_drop.all()


# ---------------------------------------------------------------------------
# whole runs
# ---------------------------------------------------------------------------


def _shipped(name: str, stop_time=None) -> dict:
    """A shipped scenario as its first sweep job runs it (the sweep's
    seeds start at the config's own)."""
    doc = yaml.safe_load((pathlib.Path(__file__).parent.parent / "configs"
                          / name).read_text())
    doc.pop("sweep")
    if stop_time is not None:
        doc["general"]["stop_time"] = stop_time
    return doc


def _overload(qdisc: dict, stop_time: int) -> dict:
    cfg = _overload_cfg(qdisc)
    cfg["general"]["stop_time"] = stop_time
    return cfg


def _mixed_pifo() -> dict:
    cfg = mixed_flood("200 Kbit")
    cfg["qdisc"] = {"discipline": "pifo", "rank": "wfq", "drop": "codel",
                    "queue_slots": 32}
    return cfg


# name: (config, through run_optimistic)
RUNS = {
    "incast": (lambda: _shipped("incast.yaml"), False),
    "bufferbloat_1500ms": (lambda: _shipped("bufferbloat.yaml", 1.5), False),
    "overload_eiffel_2s": (lambda: _overload(
        {"discipline": "eiffel", "rank": "wfq", "drop": "codel",
         "bucket_width": 4096}, 2), False),
    "mixed_pifo_optimistic": (_mixed_pifo, True),
}

GOLDEN = {
    'incast': {'windows': 200,
     'rollbacks': 0,
     'chain': 9587170247265110946,
     'counters': {'bulk_contract_violations': 0,
                  'bytes_delivered': 179200,
                  'bytes_sent': 195168,
                  'cpu_delay_applied': 0,
                  'events_committed': 19944,
                  'events_emitted': 19960,
                  'exchange_deferred': 0,
                  'exchange_sent': 0,
                  'inbox_overflow_deferred': 0,
                  'micro_steps': 2687,
                  'outbox_overflow_dropped': 0,
                  'outbox_stall_deferred': 0,
                  'packets_delivered': 448,
                  'packets_dropped_loss': 0,
                  'packets_dropped_unreachable': 0,
                  'packets_sent': 456,
                  'pool_overflow_dropped': 0},
     'qdisc': 'c168690eaf930b08',
     'state': '34ee9113e9de991c'},
    'bufferbloat_1500ms': {'windows': 499,
     'rollbacks': 0,
     'chain': 11479574592642132846,
     'counters': {'bulk_contract_violations': 0,
                  'bytes_delivered': 58368,
                  'bytes_sent': 62100,
                  'cpu_delay_applied': 0,
                  'events_committed': 862,
                  'events_emitted': 864,
                  'exchange_deferred': 0,
                  'exchange_sent': 0,
                  'inbox_overflow_deferred': 0,
                  'micro_steps': 1304,
                  'outbox_overflow_dropped': 0,
                  'outbox_stall_deferred': 0,
                  'packets_delivered': 114,
                  'packets_dropped_loss': 0,
                  'packets_dropped_unreachable': 0,
                  'packets_sent': 115,
                  'pool_overflow_dropped': 0},
     'qdisc': '823256e553b68927',
     'state': 'e9d73f0cedbe3c0e'},
    'overload_eiffel_2s': {'windows': 100,
     'rollbacks': 0,
     'chain': 7090257868545165654,
     'counters': {'bulk_contract_violations': 0,
                  'bytes_delivered': 33600,
                  'bytes_sent': 37236,
                  'cpu_delay_applied': 0,
                  'events_committed': 3669,
                  'events_emitted': 3675,
                  'exchange_deferred': 0,
                  'exchange_sent': 0,
                  'inbox_overflow_deferred': 0,
                  'micro_steps': 1295,
                  'outbox_overflow_dropped': 0,
                  'outbox_stall_deferred': 0,
                  'packets_delivered': 84,
                  'packets_dropped_loss': 0,
                  'packets_dropped_unreachable': 0,
                  'packets_sent': 87,
                  'pool_overflow_dropped': 0},
     'qdisc': '772002f0481c331e',
     'state': '2e7df5008a5da8a2'},
    'mixed_pifo_optimistic': {'windows': 43,
     'rollbacks': 4,
     'chain': 15805609934220476036,
     'counters': {'bulk_contract_violations': 0,
                  'bytes_delivered': 49152,
                  'bytes_sent': 353472,
                  'cpu_delay_applied': 0,
                  'events_committed': 11142,
                  'events_emitted': 11166,
                  'exchange_deferred': 0,
                  'exchange_sent': 0,
                  'inbox_overflow_deferred': 0,
                  'micro_steps': 1184,
                  'outbox_overflow_dropped': 0,
                  'outbox_stall_deferred': 0,
                  'packets_delivered': 48,
                  'packets_dropped_loss': 0,
                  'packets_dropped_unreachable': 0,
                  'packets_sent': 336,
                  'pool_overflow_dropped': 0},
     'qdisc': 'a4b0f9158e177ad7',
     'state': '0d04936853a7b3b0'},
}


def run_summary(sim, optimistic: bool, arrays: dict) -> dict:
    res = sim.run_optimistic() if optimistic else (sim.run(), 0)
    return {"windows": sim.obs_snapshot()["win"]["windows_run"],
            "rollbacks": res[1], "chain": sim.audit_chain(),
            "counters": sim.counters(),
            "qdisc": state_digest({k: v for k, v in arrays().items()
                                   if k.startswith("subs.qdisc.")}),
            "state": state_digest(arrays())}


def port_summary(name: str):
    cfg, opt = RUNS[name]
    sim = build_simulation(cfg(), device="cpu")
    return sim, run_summary(sim, opt,
                            lambda: interop.state_to_numpy(sim.state))


def jax_summary(name: str, paths) -> tuple:
    cfg, opt = RUNS[name]
    jsim = jax_build(cfg())
    return jsim, run_summary(jsim, opt,
                             lambda: jax_state_to_numpy(jsim.state, paths))


@pytest.mark.parametrize("name", RUNS)
def test_run_matches_jax_golden(name):
    sim, got = port_summary(name)
    assert got == GOLDEN[name]
    qd = sim.state.subs["qdisc"]
    assert int(qd.enqueues.sum()) > 0 and int(qd.dequeues.sum()) > 0
    # the drop policy dropped (the mixed flood's queues stay short)
    policy = {"incast": "drops_red", "bufferbloat_1500ms": "drops_codel",
              "overload_eiffel_2s": "drops_codel"}.get(name)
    assert policy is None or int(getattr(qd, policy).sum()) > 0
    if RUNS[name][1]:
        assert got["rollbacks"] > 0
        # a snapshot owns every plane the kernels write in place
        snap = sim.state.snapshot().subs["qdisc"]
        for f in dataclasses.fields(qd):
            shared = getattr(snap, f.name) is getattr(qd, f.name)
            assert shared == (f.name == "cls"), f.name


@pytest.mark.slow
@pytest.mark.parametrize("name", RUNS)
def test_run_matches_jax_live(name):
    """The same runs with the JAX package live: its summary equals the
    port's and the pinned golden, and every state array the port's."""
    sim, got = port_summary(name)
    jsim, want = jax_summary(name, interop.state_paths(sim.state))
    assert got == want == GOLDEN[name]
    assert_states_equal(interop.state_to_numpy(sim.state),
                        jax_state_to_numpy(jsim.state,
                                           interop.state_paths(sim.state)))


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    for name in RUNS:
        port, _ = port_summary(name)
        _, want = jax_summary(name, interop.state_paths(port.state))
        print(f"    {name!r}: {want!r},", flush=True)
