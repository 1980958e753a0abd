"""The NIC's admission (``nic_tx``, ``nic_rx``, ``nic_gate``) against the
JAX package.

The port's ``NetStack._tx``, ``on_pkt_deliver`` and ``bulk_gate`` run
through the plain versions (``kernels.PLAIN_OPS``: ``nic_tx_plain``,
``nic_rx_plain``, ``nic_gate_plain``) and the JAX package's same methods
run eagerly, on one state made from a seed with numpy at 48 hosts: a
UDP flood over two vertices with no path between them (one pair
unreachable) and loss 0.5 within vertex 0, bootstrap to 1 s. The states
hold token debt, NEVER ``now`` on unmasked lanes, queued NICs and
routers (full rings too), armed pumps, loopback and control packets, and
times on both sides of the end of bootstrap, and windows wholly inside
it. Every state array (the NIC and router sub-states, the draw counters
and the counters among them), every emitted record in order and ``ok``
must be equal.

Tolerance: exact equality (integer arithmetic, and the loss roll's
float32 uniform, the same bits in both packages).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_tpu.core.engine import Emitter as JEmitter
from shadow_tpu.core.engine import EventView as JEventView
from shadow_tpu.sim import build_simulation as jax_build
from shadow_tpu_torch import interop, kernels
from shadow_tpu_torch.core.engine import Emitter, EventView
from shadow_tpu_torch.core.simtime import NEVER
from shadow_tpu_torch.core.state import KIND_PKT_DELIVER
from shadow_tpu_torch.sim import build_simulation
from test_torch_phold import assert_states_equal, jax_state_to_numpy
from test_torch_tcp import _to_jax_state

MS = 1_000_000
SEC = 1_000_000_000
H = 48
P = 12

# no edge between the vertices: every cross pair is unreachable
GML_LOSSY_SPLIT = """\
graph [
  node [ id 0 bandwidth_down "1 Gbit" bandwidth_up "1 Gbit" ]
  node [ id 1 bandwidth_down "1 Gbit" bandwidth_up "1 Gbit" ]
  edge [ source 0 target 0 latency "10 ms" packet_loss 0.5 ]
  edge [ source 1 target 1 latency "20 ms" packet_loss 0.0 ]
]
"""
CFG = {
    "general": {"stop_time": 3, "seed": 11, "bootstrap_end_time": "1 s"},
    "network": {"graph": {"type": "gml", "inline": GML_LOSSY_SPLIT}},
    "experimental": {"event_capacity": 4096,
                     "events_per_host_per_window": 8,
                     "router_queue_slots": 8},
    "hosts": {
        **{f"server{v}": {"network_node_id": v, "app_model": "udp_flood",
                          "app_options": {"role": "server"}}
           for v in range(2)},
        **{f"client{v}": {"quantity": H // 2 - 1, "network_node_id": v,
                          "app_model": "udp_flood",
                          "app_options": {"interval": "10 ms",
                                          "size": 1000}}
           for v in range(2)},
    },
}


@pytest.fixture(scope="module")
def sims():
    port = build_simulation(CFG, device="cpu")
    jsim = jax_build(CFG)
    assert port.num_hosts == H and port.params.bootstrap_end == SEC
    assert port.stack.deliver_batch > 1  # the gate runs
    return port, jsim, jsim.handlers[KIND_PKT_DELIVER].__self__


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _state(port, rs, now):
    """The port's built state with the NIC's buckets, counters, send ring
    and pump flags, the router's ring and CoDel state and the draw
    counters drawn from ``rs``, buckets last refilled 0 to 3 grid ticks
    before ``now`` (or later)."""
    st = port.state.snapshot()
    n, r = st.subs["nic"], st.subs["router"]
    NQ, Q = n.q_dst.shape[1], r.q_src.shape[1]

    def ring(size):
        head = rs.integers(0, 1000, H)
        fill = np.select([rs.random(H) < 0.6, rs.random(H) < 0.5],
                         [0, size], rs.integers(1, size, H))
        return _t(head.astype(np.int32)), _t((head + fill).astype(np.int32))

    tick = np.maximum(now // MS - rs.integers(-1, 4, H), 0)
    nh, nt = ring(NQ)
    st.subs["nic"] = n.replace(
        tx_rem=_t(rs.integers(-6000, 6000, H)),
        rx_rem=_t(rs.integers(-6000, 6000, H)),
        tx_tick=_t(tick), rx_tick=_t(np.roll(tick, 1)),
        tx_packets=_t(rs.integers(0, 100, H)),
        tx_bytes=_t(rs.integers(0, 10**6, H)),
        q_head=nh, q_tail=nt,
        q_payload=_t(rs.integers(0, 2000, n.q_payload.shape).astype(
            np.int32)),
        send_pending=_t(rs.random(H) < 0.3),
        recv_pending=_t(rs.random(H) < 0.3))
    rh, rt = ring(Q)
    st.subs["router"] = r.replace(
        q_head=rh, q_tail=rt,
        total_size=_t(rs.integers(0, 10**5, H)),
        interval_expire=_t(np.where(rs.random(H) < 0.5, 0,
                                    now + rs.integers(0, 10**8, H))),
        drop_mode=_t(rs.random(H) < 0.5))
    st = st.with_host(rng_counter=_t(rs.integers(0, 2**32, H)))
    return st


def _packets(rs):
    """[H, P] UDP packets to the servers' port, a sixth of them control
    packets (length 0)."""
    pl = np.zeros((H, P), np.int32)
    pl[:, 0] = 17
    pl[:, 1] = rs.integers(1, 9, H)
    pl[:, 2] = 9000
    pl[:, 3] = np.where(rs.random(H) < 1 / 6, 0, rs.integers(1, 1473, H))
    pl[:, 9] = np.arange(H)
    return pl


def _now(rs, mask, around):
    """Per-host times within 3 ms of ``around``, NEVER on half the
    unmasked lanes."""
    now = around + rs.integers(-3 * MS, 3 * MS, H)
    return np.where(~mask & (rs.random(H) < 0.5), NEVER, now)


def _same(port, st, em, jst, jem):
    paths = interop.state_paths(port.state)
    assert_states_equal(interop.state_to_numpy(st),
                        jax_state_to_numpy(jst, paths))
    assert len(em.records) == len(jem.records)
    for r, jr in zip(em.records, jem.records):
        for f, jf in zip(r, jr):
            assert np.array_equal(f.numpy(), np.broadcast_to(
                np.asarray(jf), f.shape))


@pytest.mark.parametrize("seed,around,scalar_now", [
    (0, SEC + 500 * MS, False),  # after bootstrap: debt, loss rolls
    (1, SEC, False),  # across the end of bootstrap
    (2, SEC + 20 * MS, True),  # one time for every host
])
def test_tx_matches_jax(sims, seed, around, scalar_now):
    """``_tx``: queued NICs, token debt, loopback, unreachable and lossy
    paths, control packets."""
    port, jsim, jstack = sims
    rs = np.random.default_rng(100 + seed)
    mask = rs.random(H) < 0.8
    now = around if scalar_now else _now(rs, mask, around)
    st = _state(port, rs, np.broadcast_to(now, (H,)))
    gid = np.arange(H)
    dst = np.where(rs.random(H) < 0.15, gid, rs.integers(0, H, H))
    payload = _packets(rs)
    jst = _to_jax_state(jsim.state, interop.state_to_numpy(st))

    em = Emitter(kernels.PLAIN_OPS)
    out, ok = port.stack._tx(st, em, _t(mask), _t(np.asarray(now)),
                             _t(dst), _t(payload), params=port.params)
    jem = JEmitter()
    jout, jok = jstack._tx(jst, jem, jnp.asarray(mask), jnp.asarray(now),
                           jnp.asarray(dst), jnp.asarray(payload),
                           params=jsim.params)
    _same(port, out, em, jout, jem)
    assert np.array_equal(ok.numpy(), np.asarray(jok))
    # the case reached what it is for
    c = out.counters
    assert int(c.packets_sent) > 0 and ok.any() and not ok.all()
    if around > SEC:
        assert int(c.packets_dropped_loss) > 0
        assert int(c.packets_dropped_unreachable) > 0


@pytest.mark.parametrize("seed,around", [(0, SEC + 500 * MS), (1, SEC)])
def test_pkt_deliver_matches_jax(sims, seed, around):
    """``on_pkt_deliver``: loopback and remote arrivals, empty, queued and
    full router rings, token debt, CoDel in drop mode."""
    port, jsim, jstack = sims
    rs = np.random.default_rng(200 + seed)
    mask = rs.random(H) < 0.8
    now = _now(rs, mask, around)
    st = _state(port, rs, now)
    gid = np.arange(H)
    src = np.where(rs.random(H) < 0.15, gid, rs.integers(0, H, H))
    ev = dict(mask=mask, time=now, src=src.astype(np.int32),
              seq=rs.integers(0, 100, H).astype(np.int32),
              kind=np.full(H, KIND_PKT_DELIVER, np.int32),
              payload=_packets(rs))
    jst = _to_jax_state(jsim.state, interop.state_to_numpy(st))

    em = Emitter(kernels.PLAIN_OPS)
    out = port.stack.on_pkt_deliver(
        st, EventView(**{k: _t(v) for k, v in ev.items()}), em, port.params)
    jem = JEmitter()
    jout = jstack.on_pkt_deliver(
        jst, JEventView(**{k: jnp.asarray(v) for k, v in ev.items()}), jem,
        jsim.params)
    _same(port, out, em, jout, jem)
    r0, r1 = st.subs["router"], out.subs["router"]
    assert int(r1.overflow_dropped) > int(r0.overflow_dropped)
    assert bool((r1.q_tail > r0.q_tail).any())
    assert int(out.counters.packets_delivered) > 0


@pytest.mark.parametrize("seed,ws,we", [
    (0, SEC + 3 * MS, SEC + 13 * MS),  # token debt
    (1, SEC - 30 * MS, SEC - 20 * MS),  # wholly inside bootstrap
    (2, SEC - 5 * MS, SEC + 5 * MS),  # across its end
])
def test_bulk_gate_matches_jax(sims, seed, ws, we):
    port, jsim, jstack = sims
    rs = np.random.default_rng(300 + seed)
    st = _state(port, rs, np.full(H, ws))
    jst = _to_jax_state(jsim.state, interop.state_to_numpy(st))
    got = port.stack.bulk_gate(st, port.params, ws, we, kernels.PLAIN_OPS)
    want = np.asarray(jstack.bulk_gate(jst, jsim.params, ws, we))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert want.any() and not want.all()
