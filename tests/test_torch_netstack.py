"""The port's UDP network stack against the JAX package.

* The pinned audit chains of ``tests/test_qdisc.py`` (``_GOLDEN_FLOOD``
  under fifo and roundrobin, ``_GOLDEN_ECHO``) come out of the port.
* A congested flood that makes CoDel drop and the router ring overflow
  runs in both packages: equal counters, chain and every state array; the
  port also takes the JAX package's state over mid-run and ends in the
  same state.
* The stack's pieces on their own: ``codel_dequeue_plain`` against JAX
  ``codel.dequeue`` step by step on ``tests/test_net_stack.py``'s CoDel
  sequences and on seeded random router states; ``ring_append_plain``
  against ``codel.enqueue`` and ``nic.enqueue_send``; ``lazy_refill`` on
  ``test_net_stack.py``'s grid; ``bulk_gate`` on token debt.
* What the port refuses still raises, naming its ``ROADMAP.md`` item.

Tolerance: exact equality everywhere (integer arithmetic; the CoDel
control law is float64 with ties to even in both packages).
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_tpu.net import codel as jcodel
from shadow_tpu.net import nic as jnic
from shadow_tpu.net.stack import NetStack as JNetStack
from shadow_tpu.sim import build_simulation as jax_build
from shadow_tpu_torch import interop, kernels
from shadow_tpu_torch.core.state import SimState
from shadow_tpu_torch.net import codel, nic
from shadow_tpu_torch.net.stack import NetStack
from shadow_tpu_torch.sim import BuildError, build_simulation
from test_qdisc import GML_2V, _GOLDEN_ECHO, _GOLDEN_FLOOD, _flood_cfg
from test_torch_cuda import CONGESTED_FLOOD, random_ring, random_router
from test_torch_phold import assert_states_equal, jax_state_to_numpy

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


def _chain(cfg):
    sim = build_simulation(cfg, device="cpu")
    sim.run()
    return sim.audit_chain(), sim.counters()["events_committed"]


@pytest.mark.parametrize("cfg", [
    _flood_cfg(),
    _flood_cfg(interface_qdisc="fifo"),
    _flood_cfg(qdisc={"discipline": "fifo"}),
    _flood_cfg(interface_qdisc="roundrobin"),
    _flood_cfg(qdisc={"discipline": "roundrobin"}),
], ids=["default", "fifo", "qdisc-fifo", "roundrobin", "qdisc-roundrobin"])
def test_flood_golden_chain(cfg):
    assert _chain(cfg) == _GOLDEN_FLOOD


def test_echo_golden_chain():
    cfg = {
        "general": {"stop_time": 4, "seed": 5},
        "network": {"graph": {"type": "gml", "inline": GML_2V}},
        "experimental": {"event_capacity": 4096,
                         "events_per_host_per_window": 8},
        "hosts": {
            "server": {"network_node_id": 0, "app_model": "udp_echo",
                       "app_options": {"role": "server"}},
            "client": {"network_node_id": 1, "app_model": "udp_echo",
                       "app_options": {"interval": "200 ms", "runtime": 2,
                                       "size": 512}},
        },
    }
    assert _chain(cfg) == _GOLDEN_ECHO
    sim = build_simulation(cfg, device="cpu")
    sim.run()
    sub = sim.state.subs["udp_echo"]
    # 2 s of 200 ms requests, echoed over the 50 ms path both ways
    assert int(sub["rtt_count"].sum()) == int(sub["echoed"].sum()) == 10
    assert int(sub["rtt_sum"].sum()) >= 10 * 100 * MS


def _jax_congested(paths):
    """The JAX package's congested flood: its initial state, its state at
    t = 2.95 s, and the finished simulation with its final state."""
    jsim = jax_build(CONGESTED_FLOOD)
    init = jax_state_to_numpy(jsim.state, paths)
    jsim.run(until=2_950_000_000)
    mid = jax_state_to_numpy(jsim.state, paths)
    jsim.run()
    return jsim, init, mid, jax_state_to_numpy(jsim.state, paths)


def test_congested_flood_matches_jax_whole_and_from_midrun():
    port = build_simulation(CONGESTED_FLOOD, device="cpu")
    paths = interop.state_paths(port.state)
    start = interop.state_to_numpy(port.state)
    # the JAX run spends its time in XLA, outside the GIL, so it runs in a
    # second thread beside the port's
    with ThreadPoolExecutor(1) as pool:
        ref = pool.submit(_jax_congested, paths)
        port.run()
        jsim, init, mid, want = ref.result()
    assert_states_equal(start, init)

    c = port.counters()
    assert c == jsim.counters()
    assert port.audit_chain() == jsim.audit_chain() == 0x45D3C1148D003C58
    assert c["events_committed"] == 4384 and c["micro_steps"] == 3386
    r = port.state.subs["router"]
    assert int(r.codel_dropped) == 100 and int(r.overflow_dropped) == 788
    assert port.obs_snapshot()["win"] == jsim.obs_snapshot()["win"]
    assert_states_equal(interop.state_to_numpy(port.state), want)

    handed = build_simulation(CONGESTED_FLOOD, device="cpu")
    handed.state = interop.state_from_numpy(mid, "cpu")
    handed.run()
    assert_states_equal(interop.state_to_numpy(handed.state), want)


# ---------------------------------------------------------------------------
# the stack's pieces
# ---------------------------------------------------------------------------


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _assert_router_equal(tr, jr):
    for f in ("q_head", "q_tail", "drop_mode", "interval_expire",
              "next_drop", "drop_count", "drop_count_last", "total_size",
              "codel_dropped", "overflow_dropped", "q_payload", "q_src",
              "q_enq_ts"):
        assert np.array_equal(getattr(tr, f).numpy(),
                              np.asarray(getattr(jr, f))), f


_jenqueue = jax.jit(jcodel.enqueue)
_jdequeue = jax.jit(jcodel.dequeue, static_argnames=("aqm",))


class _Both:
    """One JAX router and its port copy, driven by the same calls."""

    def __init__(self, Q):
        self.j = jcodel.init(1, Q)
        self.t = codel.init(1, Q)

    def enqueue(self, t, size=1472):
        p = np.zeros((1, 12), np.int32)
        p[0, 0], p[0, 3] = 17, size
        m = np.array([True])
        src = np.zeros(1, np.int32)
        self.j = _jenqueue(self.j, jnp.asarray(m), jnp.asarray(p),
                           jnp.asarray(src), jnp.int64(t))
        self.t = codel.enqueue(self.t, _t(m), _t(p), _t(src),
                               torch.tensor(t), kernels.PLAIN_OPS)

    def dequeue(self, t):
        m = np.array([True])
        self.j, jh, jp, js = _jdequeue(self.j, jnp.int64(t), jnp.asarray(m))
        self.t, th, tp, ts = codel.dequeue(
            self.t, torch.tensor([t]), _t(m), kernels.PLAIN_OPS)
        assert bool(th[0]) == bool(jh[0])
        assert np.array_equal(tp.numpy(), np.asarray(jp))
        assert np.array_equal(ts.numpy(), np.asarray(js))
        _assert_router_equal(self.t, self.j)
        return bool(th[0])


def test_codel_sequences_match_jax():
    """tests/test_net_stack.py's CoDel cases, step by step."""
    # below target: immediate dequeues deliver everything
    b = _Both(32)
    for _ in range(5):
        b.enqueue(0)
    assert sum(b.dequeue(1 * MS) for _ in range(5)) == 5
    # sustained delay: 40 packets at t=0, one dequeue every 10 ms
    b = _Both(64)
    for _ in range(40):
        b.enqueue(0)
    t = 50 * MS
    while True:
        have = b.dequeue(t)
        if not have and not bool(codel.nonempty(b.t)[0]):
            break
        t += 10 * MS
    assert int(b.t.codel_dropped) > 0
    # a fresh packet in hand ends drop mode
    b = _Both(8)
    b.enqueue(0)
    b.enqueue(199 * MS)
    dm = dict(drop_mode=[True], next_drop=[200 * MS],
              interval_expire=[150 * MS])
    b.j = b.j.replace(**{k: jnp.asarray(v) for k, v in dm.items()})
    b.t = b.t.replace(**{k: torch.tensor(v) for k, v in dm.items()})
    assert b.dequeue(200 * MS)
    assert int(b.t.codel_dropped) == 1 and not bool(b.t.drop_mode[0])
    # ring overflow is counted
    b = _Both(4)
    for _ in range(6):
        b.enqueue(0)
    _assert_router_equal(b.t, b.j)
    assert int(b.t.overflow_dropped) == 2


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("aqm", [True, False])
def test_codel_dequeue_plain_matches_jax(seed, aqm):
    rs = np.random.default_rng(200 + seed)
    arrays, now, mask = random_router(rs)
    jr = jcodel.init(mask.shape[0], arrays["q_src"].shape[1]).replace(
        **{k: jnp.asarray(v) for k, v in arrays.items()})
    jr, jh, jp, js = jcodel.dequeue(jr, jnp.asarray(now), jnp.asarray(mask),
                                    aqm=aqm)
    out = kernels.codel_dequeue_plain(
        *(_t(v) for v in arrays.values()), _t(now), _t(mask), aqm=aqm)
    for f in ("q_head", "total_size", "interval_expire", "drop_mode",
              "next_drop", "drop_count", "drop_count_last"):
        assert np.array_equal(getattr(out, f).numpy(),
                              np.asarray(getattr(jr, f))), f
    assert int(out.dropped.sum()) == int(jr.codel_dropped)
    assert np.array_equal(out.have.numpy(), np.asarray(jh))
    assert np.array_equal(out.payload.numpy(), np.asarray(jp))
    assert np.array_equal(out.src.numpy(), np.asarray(js))
    if aqm:
        assert int(jr.codel_dropped) > 0


@pytest.mark.parametrize("seed", range(4))
def test_ring_append_plain_matches_jax(seed):
    rs = np.random.default_rng(300 + seed)
    H, Q = 64, 8
    # the router ring: codel.enqueue
    a = random_ring(rs, H, Q, with_ts=True)
    now = rs.integers(0, 2**40, H).astype(np.int64)
    a["ts"] = now
    jr = jcodel.init(H, Q).replace(
        q_payload=jnp.asarray(a["q_payload"]), q_src=jnp.asarray(a["q_col"]),
        q_enq_ts=jnp.asarray(a["q_ts"]), q_head=jnp.asarray(a["q_head"]),
        q_tail=jnp.asarray(a["q_tail"]),
        total_size=jnp.asarray(a["total_size"]))
    jr = jcodel.enqueue(jr, jnp.asarray(a["mask"]),
                        jnp.asarray(a["payload"]), jnp.asarray(a["col"]),
                        jnp.asarray(now))
    out = kernels.ring_append_plain(*(None if v is None else _t(v)
                                      for v in a.values()))
    for g, w in ((out.payload, jr.q_payload), (out.col, jr.q_src),
                 (out.ts, jr.q_enq_ts), (out.tail, jr.q_tail),
                 (out.total_size, jr.total_size)):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert int((_t(a["mask"]) & ~out.ok).sum()) == int(jr.overflow_dropped)
    # the NIC send ring: nic.enqueue_send
    a = random_ring(rs, H, Q, with_ts=False)
    up = np.full(H, 10**9, np.int64)
    jn = jnic.init(jnp.asarray(up), jnp.asarray(up), Q).replace(
        q_payload=jnp.asarray(a["q_payload"]), q_dst=jnp.asarray(a["q_col"]),
        q_head=jnp.asarray(a["q_head"]), q_tail=jnp.asarray(a["q_tail"]))
    jn, jok = jnic.enqueue_send(jn, jnp.asarray(a["mask"]),
                                jnp.asarray(a["col"]),
                                jnp.asarray(a["payload"]))
    tn = nic.init(up, up, Q).replace(
        q_payload=_t(a["q_payload"]), q_dst=_t(a["q_col"]),
        q_head=_t(a["q_head"]), q_tail=_t(a["q_tail"]))
    tn, tok = nic.enqueue_send(tn, _t(a["mask"]), _t(a["col"]),
                               _t(a["payload"]), kernels.PLAIN_OPS)
    assert np.array_equal(tok.numpy(), np.asarray(jok))
    for f in ("q_payload", "q_dst", "q_tail", "sendq_dropped"):
        assert np.array_equal(getattr(tn, f).numpy(),
                              np.asarray(getattr(jn, f))), f
    assert int(tn.sendq_dropped) > 0


def test_lazy_refill_grid_matches_jax():
    """tests/test_net_stack.py's grid, plus masked NEVER lanes and debt."""
    rem = np.array([0, 500, -3000, 700], np.int64)
    tick = np.array([0, 0, 1, 2], np.int64)
    refill = np.array([1000, 1000, 1000, 1000], np.int64)
    cap = refill + 1500
    for now, mask in ((3_500_000, None), (3_600_000, None),
                      (np.array([3_500_000, NEVER, 9_000_000, NEVER]),
                       np.array([True, False, True, False]))):
        j = jnic.lazy_refill(
            jnp.asarray(rem), jnp.asarray(tick), jnp.asarray(refill),
            jnp.asarray(cap), jnp.asarray(now),
            None if mask is None else jnp.asarray(mask))
        t = nic.lazy_refill(_t(rem), _t(tick), _t(refill), _t(cap),
                            _t(np.asarray(now, np.int64)),
                            None if mask is None else _t(mask))
        for g, w in zip(t, j):
            assert np.array_equal(g.numpy(), np.asarray(w))
        rem, tick = t[0].numpy(), t[1].numpy()


def test_bulk_gate_matches_jax_on_token_debt():
    """Negative token buckets floor-divide by the MTU as JAX's // does
    (truncation would grant one more batched arrival)."""
    rs = np.random.default_rng(7)
    H = 32
    bw = np.full(H, 8 * 10**6, np.int64)
    js = JNetStack(H, jnp.asarray(bw), jnp.asarray(bw), with_tcp=False)
    ts = NetStack(H, bw, bw)
    jsub, tsub = js.init_subs(), ts.init_subs()
    fields = dict(
        tx_rem=rs.integers(-6000, 6000, H), rx_rem=rs.integers(-6000, 6000, H),
        tx_tick=rs.integers(0, 4, H), rx_tick=rs.integers(0, 4, H),
        send_pending=rs.random(H) < 0.2, recv_pending=rs.random(H) < 0.2,
    )
    jsub["nic"] = jsub["nic"].replace(
        **{k: jnp.asarray(v) for k, v in fields.items()})
    tsub["nic"] = tsub["nic"].replace(**{k: _t(v) for k, v in fields.items()})

    class _J:
        subs = jsub

    state = SimState(now=0, pool=None, host=None, counters=None,
                     rng_keys=None, subs=tsub)
    for ws, we, boot in ((3 * MS, 13 * MS, 0), (3 * MS, 13 * MS, 20 * MS)):
        jp = type("P", (), {"bootstrap_end": jnp.int64(boot)})()
        tp = type("P", (), {"bootstrap_end": boot})()
        want = np.asarray(js.bulk_gate(_J, jp, ws, we))
        got = ts.bulk_gate(state, tp, ws, we).numpy()
        assert np.array_equal(got, want)
    assert (fields["rx_rem"] < 0).any() and want.any()


def test_port_refuses_what_it_does_not_run():
    def cfg(app="udp_flood", **exp):
        return {
            "general": {"stop_time": 2},
            "network": {"graph": {"type": "1_gbit_switch"}},
            "experimental": exp,
            "hosts": {"s": {"app_model": app,
                            "app_options": {"role": "server"}},
                      "c": {"quantity": 2, "app_model": app}},
        }

    for bad, match in ((cfg("tcp_bulk"), "B11"),
                       (cfg(interface_qdisc="roundrobin",
                            packet_trails=True), "A 7")):
        with pytest.raises(BuildError, match=match):
            build_simulation(bad, device="cpu")
    c = cfg()
    c["qdisc"] = {"discipline": "pifo"}
    with pytest.raises(BuildError, match="B9"):
        build_simulation(c, device="cpu")
    with pytest.raises(NotImplementedError, match="B11"):
        NetStack(2, np.ones(2, np.int64), np.ones(2, np.int64),
                 with_tcp=True)
    # the flood itself builds and runs: every window on the loop path
    sim = build_simulation(cfg(), device="cpu")
    sim.run()
    win = sim.obs_snapshot()["win"]
    assert win["loop_dispatches"] == win["windows_run"] > 0
    assert win["matrix_dispatches"] == 0
    assert jax.devices()[0].platform == "cpu"
