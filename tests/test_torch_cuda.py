"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Each kernel (``shadow_tpu_torch/csrc``) runs on CUDA tensors and its plain
version runs on the same tensors; the outputs must be equal bit for bit.
The whole path is integer arithmetic or float32/float64 with a defined
rounding, so there is no tolerance. Inputs come from real windows of
small PHOLD runs, plus seeded numpy variations (draw counters about to
wrap, random seq numbers, lossy and multi-vertex topologies); the loop
path's kernels take seeded random states (``random_*`` below: NEVER
lanes, full rings and boxes, key ties, token debt, drop mode) and whole
runs of a congested UDP flood; the TCP kernels take seeded lossy tables
(``chip_smoke.synthetic_tcp_*`` and ``random_tcp_*``: every branch of
the ACK and reorder blocks, sequence numbers across the wrap, slots
outside [0, S) on masked-off hosts) and a whole lossy TCP run; the
optimistic driver's four kernels take the synthetic tables of
``chip_smoke.synthetic_*`` (violations and filler destinations, idle
gaps and NEVER lanes, wrapped ring heads, unreachable pairs and control
packets) and whole optimistic runs that roll back on both paths.

Marked ``cuda``: the card decides inside the fixture, and the tests skip
where there is none. This file imports neither jax nor the JAX package,
so it runs on a machine without them:

    pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from shadow_tpu_torch import kernels
from shadow_tpu_torch.core import engine
from shadow_tpu_torch.core.simtime import NEVER
from shadow_tpu_torch.flagship import build_phold_flagship
from shadow_tpu_torch.sim import build_simulation

pytestmark = pytest.mark.cuda

THREE_VERTEX_GML = """\
graph [
  node [ id 0 bandwidth_down "1 Gbit" bandwidth_up "1 Gbit" ]
  node [ id 1 bandwidth_down "1 Gbit" bandwidth_up "1 Gbit" ]
  node [ id 2 bandwidth_down "1 Gbit" bandwidth_up "1 Gbit" ]
  edge [ source 0 target 0 latency "20 ms" packet_loss 0.05 ]
  edge [ source 1 target 1 latency "25 ms" packet_loss 0.0 ]
  edge [ source 2 target 2 latency "30 ms" packet_loss 0.1 ]
  edge [ source 0 target 1 latency "40 ms" packet_loss 0.2 ]
  edge [ source 1 target 2 latency "45 ms" packet_loss 0.0 ]
  edge [ source 0 target 2 latency "50 ms" packet_loss 0.3 ]
]
"""


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    kernels.build()
    return torch.device("cuda")


def _three_vertex_sim(device):
    return build_simulation({
        "general": {"stop_time": 4, "seed": 7, "bootstrap_end_time": "1100 ms"},
        "network": {"graph": {"type": "gml", "inline": THREE_VERTEX_GML}},
        "experimental": {"event_capacity": 4096,
                         "events_per_host_per_window": 6},
        "hosts": {
            f"g{v}": {"quantity": 20, "app_model": "phold",
                      "network_node_id": v,
                      "app_options": {"msgload": 3, "runtime": 2}}
            for v in range(3)
        },
    }, device=device)


def _sims(device):
    return [
        build_phold_flagship(96, msgload=3, stop_s=3, device=device),
        build_phold_flagship(40, msgload=2, stop_s=3, K=4, device=device),
        _three_vertex_sim(device),
    ]


def _windows(sim, n):
    """The first n windows of a run: (state, ws, we) before each."""
    out = []
    for _ in range(n):
        ws = int(sim.state.pool.time.min())
        if ws >= sim.stop_time:
            break
        we = min(ws + sim.runahead, sim.stop_time)
        out.append((sim.state, ws, we))
        sim.state = _clone_state(sim.state)
        sim.step(ws, we)
    return out


def _clone_state(st):
    from shadow_tpu_torch import interop

    return interop.state_from_numpy(interop.state_to_numpy(st),
                                    st.pool.time.device)


def _eq(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def test_extract_slots_matches_plain(card):
    for sim in _sims(card):
        H = sim.num_hosts
        for st, ws, we in _windows(sim, 4):
            s_k1, _ = engine.window_keys(st.pool, ws, we, H, sim.K)
            n = kernels.EXTRACT_SLOTS.launches
            got = kernels.extract_slots(s_k1, H, sim.K)
            assert kernels.EXTRACT_SLOTS.launches == n + 1
            _eq([got], [kernels.extract_slots_plain(s_k1, H, sim.K)])


def test_phold_forward_matches_plain(card):
    rs = np.random.default_rng(5)
    for sim in _sims(card):
        H, K = sim.num_hosts, sim.K
        p = sim.params
        for st, ws, we in _windows(sim, 3):
            dense, _ = engine.dense_extract(st.pool, ws, we, H, K,
                                            kernels.PLAIN_OPS)
            h = st.host
            ctr = torch.as_tensor(
                rs.integers(0, 2**32, H, dtype=np.int64), device=card)
            ctr[:4] = torch.tensor([0, 1, 2**31, 2**32 - 1])
            seq = torch.as_tensor(
                rs.integers(0, 2**31 - 64, H).astype(np.int32), device=card)
            for c, q in ((h.rng_counter, h.seq_next), (ctr, seq)):
                args = (dense.time, dense.payload, st.rng_keys, c, q, h.gid,
                        h.vertex, p.latency_vv, p.reliability_vv, p.vertex_g)
                kw = dict(num_hosts=sim.num_hosts,
                          stop_sending=sim.app.stop_sending,
                          bootstrap_end=p.bootstrap_end, win_end=we, kind=1)
                _eq(kernels.phold_forward(*args, **kw),
                    kernels.phold_forward_plain(*args, **kw))


def test_audit_commit_matches_plain(card):
    rs = np.random.default_rng(9)
    for sim in _sims(card):
        H, K = sim.num_hosts, sim.K
        for st, ws, we in _windows(sim, 3):
            dense, _ = engine.dense_extract(st.pool, ws, we, H, K,
                                            kernels.PLAIN_OPS)
            ob = st.obs
            digest = torch.as_tensor(
                rs.integers(-2**63, 2**63 - 1, H, dtype=np.int64),
                device=card)
            for dg in (ob.host_digest, digest):
                args = (dense.time, dense.src, dense.kind, st.host.gid, dg,
                        ob.host_events, ob.host_last_t, st.host.done_t)
                _eq(kernels.audit_commit(*args),
                    kernels.audit_commit_plain(*args))


def test_run_through_kernels_matches_plain_run(card):
    """A whole run through the kernels equals the plain versions' run on
    the card, and each matrix-path kernel launched once a window (the
    loop path's kernels not at all)."""
    a = build_phold_flagship(128, msgload=4, stop_s=4, device=card)
    b = build_phold_flagship(128, msgload=4, stop_s=4, device=card)
    b.ops = kernels.PLAIN_OPS
    kernels.reset_launches()
    wa = a.run()
    want = {k.name: wa if k.name in ("extract_slots", "phold_forward",
                                     "audit_commit", "spec_check") else 0
            for k in kernels.KERNELS}
    assert {k.name: k.launches for k in kernels.KERNELS} == want
    wb = b.run()
    assert {k.name: k.launches for k in kernels.KERNELS} == want
    assert wa == wb
    assert a.counters() == b.counters()
    assert a.audit_chain() == b.audit_chain()
    from shadow_tpu_torch import interop

    na, nb = interop.state_to_numpy(a.state), interop.state_to_numpy(b.state)
    for path in na:
        assert np.array_equal(na[path], nb[path]), path


def test_kernels_refuse_bad_arguments(card):
    s_k1 = torch.zeros(8, dtype=torch.int32, device=card)
    with pytest.raises(ValueError):
        kernels.extract_slots(s_k1, 2, 2)
    with pytest.raises(ValueError):
        kernels.extract_slots(torch.zeros(8, dtype=torch.int64,
                                          device=card)[::2], 2, 2)
    t = torch.full((4, 3), NEVER, dtype=torch.int64, device=card)
    with pytest.raises(ValueError):
        kernels.audit_commit(t, t, t, t, t, t, t, t)


# ---------------------------------------------------------------------------
# the loop path's kernels: seeded random states (also used by the CPU tests
# against the JAX package)
# ---------------------------------------------------------------------------

W_LEN, W_SOCKET = 3, 10


def _packets(rs, shape, P=12):
    """int32 packet words: UDP or TCP, lengths 0..1472, random words."""
    pl = rs.integers(-2**31, 2**31, size=shape + (P,)).astype(np.int32)
    pl[..., 0] = np.where(rs.random(shape) < 0.8, 17, 6)
    pl[..., W_LEN] = rs.integers(0, 1473, size=shape)
    pl[..., W_SOCKET] = rs.integers(0, 8, size=shape)
    return pl


def random_select_inputs(rs, H=64, K=8, B=4, O=8, PP=6, G=4, kinds=(1, 2, 3,
                                                                    100)):
    """A micro-step's selection inputs: sorted dense rows per host with
    ties in time and src and NEVER fillers, inboxes with free slots and
    ties, filling outboxes, gates and a tight pool budget. Returns
    (arrays as numpy, keyword arguments)."""
    Kc = K + 1
    ws, we = 1_000_000_000, 1_010_000_000
    d_t = np.full((H, Kc), NEVER, np.int64)
    d_s = np.zeros((H, Kc), np.int32)
    d_q = np.zeros((H, Kc), np.int32)
    d_k = np.zeros((H, Kc), np.int32)
    for h in range(H):
        n = rs.integers(0, Kc + 1)
        t = ws + rs.integers(0, 4, n) * 2_500_000
        s = rs.integers(0, 6, n).astype(np.int32)
        s[rs.random(n) < 0.3] = h % 6
        q = rs.integers(0, 50, n).astype(np.int32)
        order = np.lexsort((q, s, t))
        d_t[h, :n], d_s[h, :n], d_q[h, :n] = t[order], s[order], q[order]
        d_k[h, :n] = rs.choice([3] * 8 + list(kinds), n)
    d_t[d_t >= we] = NEVER
    d_p = rs.integers(-2**62, 2**62, (H, Kc, PP), dtype=np.int64)
    i_t = np.where(rs.random((H, B)) < 0.75, NEVER,
                   ws + rs.integers(2, 4, (H, B)) * 2_500_000)
    i_t[:4] = NEVER  # empty inboxes: stale keys compete at NEVER
    i_s = rs.integers(0, 6, (H, B)).astype(np.int32)
    i_q = rs.integers(0, 50, (H, B)).astype(np.int32)
    i_k = rs.choice(list(kinds), (H, B)).astype(np.int32)
    i_p = rs.integers(-2**62, 2**62, (H, B, PP), dtype=np.int64)
    need = np.zeros(max(kinds) + 1, np.int32)
    for k in kinds:
        need[k] = rs.integers(0, 3)
    need[3] = 1
    arrays = dict(
        d_t=d_t, d_s=d_s, d_q=d_q, d_k=d_k, d_p=d_p,
        ptr=rs.integers(0, K + 1, H).astype(np.int32),
        i_t=i_t.astype(np.int64), i_s=i_s, i_q=i_q, i_k=i_k, i_p=i_p,
        o_count=np.minimum(rs.integers(0, O + 4, H), O).astype(np.int32)
        * (rs.random(H) < 0.5),
        gate=rs.integers(0, G, H).astype(np.int32),
        gid=np.arange(H, dtype=np.int32) % 6, need_by_kind=need,
    )
    # a budget that lets the first hosts in and stalls the rest
    box_used = int(arrays["o_count"].sum() + (i_t != NEVER).sum())
    kw = dict(K=K, G=G, O=O, bulk_kind=3, self_excluded=True, win_end=we,
              pool_budget=box_used + int(rs.integers(H // 2, 2 * H)))
    return arrays, kw


def random_route_inputs(rs, H=64, E=5, B=4, O=6, PP=6):
    """A micro-step's emission records and boxes: self and cross-host
    emissions inside and past the window, inboxes and outboxes near full,
    deferred keys that tie the records' times."""
    ws, we = 1_000_000_000, 1_010_000_000
    gid = np.arange(H, dtype=np.int32)
    t = ws + rs.integers(0, 8, (E, H)) * 2_500_000
    d = np.where(rs.random((E, H)) < 0.5, gid[None, :],
                 rs.integers(0, H, (E, H))).astype(np.int32)
    boxes = dict(
        i_t=np.where(rs.random((H, B)) < 0.6, NEVER,
                     ws + rs.integers(0, 4, (H, B)) * 2_500_000),
        i_s=rs.integers(0, H, (H, B)).astype(np.int32),
        i_q=rs.integers(0, 99, (H, B)).astype(np.int32),
        i_k=rs.integers(0, 5, (H, B)).astype(np.int32),
        i_p=rs.integers(-2**62, 2**62, (H, B, PP), dtype=np.int64),
        o_t=rs.integers(ws, 2 * we, (H, O)).astype(np.int64),
        o_d=rs.integers(0, H, (H, O)).astype(np.int32),
        o_s=rs.integers(0, H, (H, O)).astype(np.int32),
        o_q=rs.integers(0, 99, (H, O)).astype(np.int32),
        o_k=rs.integers(0, 5, (H, O)).astype(np.int32),
        o_p=rs.integers(-2**62, 2**62, (H, O, PP), dtype=np.int64),
        o_count=rs.integers(0, O + 1, H).astype(np.int32),
    )
    boxes["i_t"] = boxes["i_t"].astype(np.int64)
    records = dict(
        m=rs.random((E, H)) < 0.7, t=t.astype(np.int64), d=d,
        k=rs.integers(0, 5, (E, H)).astype(np.int32),
        p=rs.integers(-2**62, 2**62, (E, H, PP), dtype=np.int64),
        seq_next=rs.integers(0, 90, H).astype(np.int32), gid=gid,
        defer_t=np.where(rs.random(H) < 0.3, NEVER,
                         ws + rs.integers(0, 8, H) * 2_500_000
                         ).astype(np.int64),
        defer_s=rs.integers(0, H, H).astype(np.int32),
        defer_q=rs.integers(0, 99, H).astype(np.int32),
    )
    return records, boxes, dict(win_end=we)


def random_router(rs, H=64, Q=8, P=12):
    """CoDel router states: empty, partial and full rings, stale and
    fresh packets, hosts in drop mode with due and future drops, armed
    and unarmed intervals. Returns (arrays, now, mask)."""
    now = 2_000_000_000 + rs.integers(0, 50_000_000, H)
    head = rs.integers(0, 1000, H).astype(np.int32)
    n = rs.integers(0, Q + 1, H)
    n[:3] = (0, Q, 1)
    age = np.where(rs.random((H, Q)) < 0.5, rs.integers(0, 9_000_000, (H, Q)),
                   rs.integers(10_000_000, 400_000_000, (H, Q)))
    pl = _packets(rs, (H, Q), P)
    arrays = dict(
        q_payload=pl,
        q_src=rs.integers(0, H, (H, Q)).astype(np.int32),
        q_enq_ts=(now[:, None] - age).astype(np.int64),
        q_head=head, q_tail=(head + n).astype(np.int32),
        drop_mode=rs.random(H) < 0.5,
        interval_expire=np.where(
            rs.random(H) < 0.4, 0,
            now + rs.integers(-200_000_000, 100_000_000, H)).astype(np.int64),
        next_drop=(now + rs.integers(-100_000_000, 100_000_000, H)
                   ).astype(np.int64),
        drop_count=rs.integers(0, 40, H).astype(np.int32),
        drop_count_last=rs.integers(0, 40, H).astype(np.int32),
        total_size=(rs.integers(0, 3, H) * 1500
                    + (pl[..., W_LEN] + 28).sum(axis=1)).astype(np.int64),
    )
    mask = rs.random(H) < 0.8
    now = np.where(mask, now, NEVER).astype(np.int64)
    return arrays, now, mask


def random_ring(rs, H=64, Q=8, P=12, with_ts=True):
    """Rings empty to full with heads past int32 wrap of nothing (heads
    only grow), and packets to append."""
    head = rs.integers(0, 5000, H).astype(np.int32)
    n = rs.integers(0, Q + 1, H)
    n[:2] = (Q, 0)
    out = dict(
        q_payload=_packets(rs, (H, Q), P),
        q_col=rs.integers(0, H, (H, Q)).astype(np.int32),
        q_ts=rs.integers(0, 2**40, (H, Q)).astype(np.int64)
        if with_ts else None,
        q_head=head, q_tail=(head + n).astype(np.int32),
        mask=rs.random(H) < 0.7, payload=_packets(rs, (H,), P),
        col=rs.integers(0, H, H).astype(np.int32),
        ts=rs.integers(0, 2**40, H).astype(np.int64) if with_ts else None,
        total_size=rs.integers(0, 10**6, H).astype(np.int64)
        if with_ts else None,
    )
    return out


def to_torch(d: dict, device):
    return {k: None if v is None else torch.as_tensor(v, device=device)
            for k, v in d.items()}


@pytest.mark.parametrize("seed", range(4))
def test_loop_select_matches_plain(card, seed):
    rs = np.random.default_rng(seed)
    for G, gate, excl, bk, B in ((4, True, True, 3, 4), (1, False, False, 3, 4),
                                 (6, False, False, 3, 3), (4, True, True, -1, 5)):
        arrays, kw = random_select_inputs(rs, G=G, B=B)
        a = to_torch(arrays, card)
        if not gate:
            a["gate"] = None
        kw.update(self_excluded=excl, bulk_kind=bk)
        args = [a[k] for k in ("d_t", "d_s", "d_q", "d_k", "d_p", "ptr",
                               "i_t", "i_s", "i_q", "i_k", "i_p", "o_count",
                               "gate", "gid", "need_by_kind")]
        n = kernels.LOOP_SELECT.launches
        got = kernels.loop_select(*args, **kw)
        assert kernels.LOOP_SELECT.launches == n + 1
        _eq(got, kernels.loop_select_plain(*args, **kw))


@pytest.mark.parametrize("seed", range(4))
def test_loop_route_matches_plain(card, seed):
    rs = np.random.default_rng(100 + seed)
    records, boxes, kw = random_route_inputs(rs)
    r = to_torch(records, card)
    bx = kernels.Boxes(**to_torch(boxes, card))
    args = [r[k] for k in ("m", "t", "d", "k", "p", "seq_next", "gid",
                           "defer_t", "defer_s", "defer_q")]
    got = kernels.loop_route(*args, bx, **kw)
    want = kernels.loop_route_plain(*args, bx, **kw)
    _eq(got.boxes, want.boxes)
    _eq(got[1:], want[1:])


@pytest.mark.parametrize("seed", range(4))
def test_codel_dequeue_matches_plain(card, seed):
    rs = np.random.default_rng(200 + seed)
    for aqm in (True, False):
        arrays, now, mask = random_router(rs)
        a = to_torch(arrays, card)
        args = list(a.values()) + [torch.as_tensor(now, device=card),
                                   torch.as_tensor(mask, device=card)]
        want = kernels.codel_dequeue_plain(*args, aqm=aqm)
        if aqm:
            assert int(want.dropped.sum()) > 0  # the drop branches ran
        _eq(kernels.codel_dequeue(*args, aqm=aqm), want)


@pytest.mark.parametrize("seed", range(4))
def test_ring_append_matches_plain(card, seed):
    rs = np.random.default_rng(300 + seed)
    for with_ts in (True, False):
        a = to_torch(random_ring(rs, with_ts=with_ts), card)
        got = kernels.ring_append(*a.values())
        want = kernels.ring_append_plain(*a.values())
        assert (got.ts is None) == (want.ts is None) == (not with_ts)
        _eq([x for x in got if x is not None],
            [x for x in want if x is not None])


CONGESTED_FLOOD = {
    "general": {"stop_time": 3, "seed": 6},
    "network": {"graph": {"type": "gml", "inline": (
        'graph [ node [ id 0 bandwidth_down "10 Mbit" '
        'bandwidth_up "10 Mbit" ] edge [ source 0 target 0 '
        'latency "10 ms" packet_loss 0.0 ] ]')}},
    "experimental": {"event_capacity": 4096,
                     "events_per_host_per_window": 8},
    "hosts": {
        "server": {"app_model": "udp_flood",
                   "app_options": {"role": "server"},
                   "bandwidth_down": "1 Mbit", "bandwidth_up": "10 Mbit"},
        "client": {"quantity": 3, "app_model": "udp_flood",
                   "app_options": {"interval": "5 ms", "size": 1000,
                                   "runtime": 2}},
    },
}


def test_flood_through_kernels_matches_plain_run(card):
    """The congested flood (CoDel drops, router overflow, stalls) through
    the kernels equals the plain versions' run on the card, state array by
    state array, and every kernel of the loop path launched."""
    from shadow_tpu_torch import interop

    a = build_simulation(CONGESTED_FLOOD, device=card)
    b = build_simulation(CONGESTED_FLOOD, device=card)
    b.ops = kernels.PLAIN_OPS
    kernels.reset_launches()
    wa = a.run()
    launches = {k.name: k.launches for k in kernels.KERNELS}
    for name in ("extract_slots", "audit_commit", "loop_select",
                 "loop_route", "codel_dequeue", "ring_append", "spec_check",
                 "nic_refill", "link_send"):
        assert launches[name] > 0, name
    assert launches["phold_forward"] == 0
    assert b.run() == wa
    assert {k.name: k.launches for k in kernels.KERNELS} == launches
    assert a.counters() == b.counters()
    assert a.audit_chain() == b.audit_chain() == 0x45D3C1148D003C58
    assert int(a.state.subs["router"].codel_dropped) == 100
    na, nb = interop.state_to_numpy(a.state), interop.state_to_numpy(b.state)
    for path in na:
        assert np.array_equal(na[path], nb[path]), path


# ---------------------------------------------------------------------------
# the TCP stack's kernels
# ---------------------------------------------------------------------------

MSS = 1460


def _i32(a):
    return (np.asarray(a, np.int64) & 0xFFFFFFFF).astype(np.uint32).view(
        np.int32)


def random_tcp_demux(rs, H=256, S=8):
    """Socket tables with listeners and connections sharing ports, ties
    between sockets (the lowest slot wins), unused sockets that would
    match, and segments that match nothing."""
    hs = (H, S)
    ports = np.array([80, 9000, 40000, 40001], np.int32)
    state = rs.choice([0, 1, 3, 4, 5, 9], size=hs).astype(np.int32)
    arrays = dict(
        used=rs.random(hs) < 0.7,
        local_port=rs.choice(ports, size=hs).astype(np.int32),
        peer_host=np.where(state == 1, -1, rs.integers(0, 4, hs)).astype(
            np.int32),
        peer_port=rs.choice(ports, size=hs).astype(np.int32),
        state=state,
        mask=rs.random(H) < 0.8,
        dport=rs.choice(ports, size=H).astype(np.int32),
        sport=rs.choice(ports, size=H).astype(np.int32),
        src=rs.integers(0, 4, H).astype(np.int32),
    )
    return arrays


def random_tcp_out(rs, H=256, S=8):
    """Output-pump inputs: windows open and closed, data left and not,
    re-walks over SACKed chunks, FINs pending and sent, sockets that are
    unused or cannot send, and masked-off hosts with slots outside
    [0, S)."""
    hs = (H, S)
    una = rs.integers(-2**31, 2**31, hs)
    nxt = una + rs.integers(0, 30, hs) * MSS
    smax = nxt + rs.integers(0, 5, hs) * MSS * (rs.random(hs) < 0.4)
    buf = nxt + np.where(rs.random(hs) < 0.3, 0,
                         rs.integers(-MSS, 40 * MSS, hs))
    mask = rs.random(H) < 0.85
    slot = np.where(~mask & (rs.random(H) < 0.3), rs.integers(-3, S + 3, H),
                    rs.integers(0, S, H))
    f = dict(
        out_pending=rs.random(hs) < 0.5, used=rs.random(hs) < 0.9,
        state=rs.choice([2, 3, 4, 5, 7, 9, 10], size=hs),
        snd_una=una, snd_nxt=nxt, snd_max=smax, snd_buf_end=buf,
        cwnd=rs.integers(MSS, 40 * MSS, hs),
        snd_wnd=rs.integers(0, 1 << 20, hs),
        sack_bits=rs.integers(0, 2**32, hs) * (rs.random(hs) < 0.5),
        fin_pending=rs.random(hs) < 0.4, fin_sent=rs.random(hs) < 0.2,
        rcv_nxt=rs.integers(-2**31, 2**31, hs),
        peer_host=rs.integers(0, H, hs), rtt_armed=rs.random(hs) < 0.5,
        rtt_seq=rs.integers(-2**31, 2**31, hs),
        rtt_start=rs.integers(0, 10**10, hs),
        fin_seq=rs.integers(-2**31, 2**31, hs),
    )
    per_host = (mask, _i32(slot), 2_000_000_000 + rs.integers(0, 10**8, H))
    return per_host, f


@pytest.mark.parametrize("seed", range(4))
def test_tcp_demux_matches_plain(card, seed):
    a = to_torch(random_tcp_demux(np.random.default_rng(400 + seed)), card)
    n = kernels.TCP_DEMUX.launches
    got = kernels.tcp_demux(*a.values())
    assert kernels.TCP_DEMUX.launches == n + 1
    want = kernels.tcp_demux_plain(*a.values())
    assert int(want.found.sum()) > int(want.is_listener.sum()) > 0
    _eq(got, want)


@pytest.mark.parametrize("seed", range(4))
def test_tcp_ack_matches_plain(card, seed):
    from chip_smoke import BRANCHES, synthetic_tcp_ack

    args, kw = synthetic_tcp_ack(2048, 8, card, seed=500 + seed)
    got, want = kernels.tcp_ack(*args, **kw), kernels.tcp_ack_plain(*args,
                                                                    **kw)
    for b in BRANCHES["tcp_ack"].values():  # every branch ran
        assert int(((want.flags >> b) & 1).sum()) > 0, b
    _eq(got.fields, want.fields)
    _eq(got[1:], want[1:])


@pytest.mark.parametrize("seed", range(4))
def test_tcp_reorder_matches_plain(card, seed):
    from chip_smoke import BRANCHES, synthetic_tcp_reorder

    for W in (64, 20):
        args, kw = synthetic_tcp_reorder(2048, 8, W, card, seed=600 + seed)
        got = kernels.tcp_reorder(*args, **kw)
        want = kernels.tcp_reorder_plain(*args, **kw)
        for b in BRANCHES["tcp_reorder"].values():
            assert int(((want.flags >> b) & 1).sum()) > 0, b
        _eq(got, want)


@pytest.mark.parametrize("seed", range(4))
def test_tcp_out_matches_plain(card, seed):
    (mask, slot, now), f = random_tcp_out(np.random.default_rng(700 + seed))
    per = (torch.as_tensor(mask, device=card),
           torch.as_tensor(slot, device=card),
           torch.as_tensor(now, device=card))
    fields = tuple(torch.as_tensor(
        _i32(f[n]) if kernels.TCP_DTYPES[n] == torch.int32 else f[n],
        dtype=kernels.TCP_DTYPES[n], device=card) for n in kernels.OUT_IN)
    got = kernels.tcp_out(*per, *fields, mss=MSS)
    want = kernels.tcp_out_plain(*per, *fields, mss=MSS)
    for b in range(5):
        assert int(((want.flags >> b) & 1).sum()) > 0, b
    _eq(got.fields, want.fields)
    _eq(got[1:], want[1:])


# tests/test_torch_tcp.py's "lossy" scenario: 5 % loss, 3 clients
LOSSY_TCP = {
    "general": {"stop_time": 30, "seed": 2, "bootstrap_end_time": 0},
    "network": {"graph": {"type": "gml", "inline": (
        'graph [ node [ id 0 bandwidth_down "100 Mbit" '
        'bandwidth_up "100 Mbit" ] node [ id 1 bandwidth_down "100 Mbit" '
        'bandwidth_up "100 Mbit" ] edge [ source 0 target 0 latency "1 ms" ]'
        ' edge [ source 1 target 1 latency "1 ms" ] edge [ source 0 '
        'target 1 latency "20 ms" packet_loss 0.05 ] ]')}},
    "experimental": {"event_capacity": 4096,
                     "events_per_host_per_window": 8},
    "hosts": {
        "server": {"network_node_id": 0, "app_model": "tcp_bulk",
                   "app_options": {"role": "server"}},
        **{f"client{i}": {"network_node_id": 1, "app_model": "tcp_bulk",
                          "app_options": {"total": "30 KiB"}}
           for i in range(3)},
    },
}


def test_tcp_run_through_kernels_matches_plain_run(card):
    """A lossy TCP transfer (fast, partial and SACK retransmits) through
    the kernels equals the plain versions' run on the card, state array
    by state array, and every kernel of its path launched."""
    from shadow_tpu_torch import interop

    a = build_simulation(LOSSY_TCP, device=card)
    b = build_simulation(LOSSY_TCP, device=card)
    b.ops = kernels.PLAIN_OPS
    kernels.reset_launches()
    wa = a.run()
    launches = {k.name: k.launches for k in kernels.KERNELS}
    for name in ("extract_slots", "audit_commit", "loop_select",
                 "loop_route", "codel_dequeue", "ring_append", "tcp_demux",
                 "tcp_ack", "tcp_reorder", "tcp_out", "spec_check",
                 "nic_refill", "send_dequeue", "link_send"):
        assert launches[name] > 0, name
    assert b.run() == wa
    assert {k.name: k.launches for k in kernels.KERNELS} == launches
    assert a.counters() == b.counters()
    # the JAX package's chain (tests/test_torch_tcp.py, GOLDEN["lossy"])
    assert a.audit_chain() == b.audit_chain() == 0x8CF80602A987429A
    na, nb = interop.state_to_numpy(a.state), interop.state_to_numpy(b.state)
    for path in na:
        assert np.array_equal(na[path], nb[path]), path


# ---------------------------------------------------------------------------
# the optimistic driver's kernels
# ---------------------------------------------------------------------------


def _same(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    _eq(got, want)


@pytest.mark.parametrize("H,N,seed", [(64, 512, 0), (5000, 300_000, 1),
                                      (7, 0, 2)])
def test_spec_check_matches_plain(card, H, N, seed):
    from chip_smoke import synthetic_spec_check

    args, _ = synthetic_spec_check(H, N, card, seed)
    n = kernels.SPEC_CHECK.launches
    got = kernels.spec_check(*args)
    assert kernels.SPEC_CHECK.launches == n + 1
    _same(got, kernels.spec_check_plain(*args))
    assert (int(got) == NEVER) == (N == 0)


@pytest.mark.parametrize("seed", range(3))
def test_nic_refill_matches_plain(card, seed):
    from chip_smoke import synthetic_nic_refill

    args, _ = synthetic_nic_refill(4099, card, seed)
    _same(kernels.nic_refill(*args), kernels.nic_refill_plain(*args))
    # every host updated; one `now` for every host (the bulk gate)
    _same(kernels.nic_refill(*args[:5]), kernels.nic_refill_plain(*args[:5]))
    now = torch.tensor(2_500_000_000, device=card)
    _same(kernels.nic_refill(*args[:4], now),
          kernels.nic_refill_plain(*args[:4], now))


@pytest.mark.parametrize("seed", range(3))
def test_send_dequeue_matches_plain(card, seed):
    from chip_smoke import synthetic_send_dequeue

    args, _ = synthetic_send_dequeue(3001, 64, 12, card, seed)
    n = kernels.SEND_DEQUEUE.launches
    got = kernels.send_dequeue(*args)
    assert kernels.SEND_DEQUEUE.launches == n + 1
    _same(got, kernels.send_dequeue_plain(*args))
    assert got.sent.any() and not got.sent.all()


@pytest.mark.parametrize("variant", ["table", "own_vertex", "single",
                                     "broadcast"])
def test_link_send_matches_plain(card, variant):
    from chip_smoke import synthetic_link_send

    args, kw = synthetic_link_send(5003, card, seed=len(variant))
    args = list(args)
    if variant == "own_vertex":
        args[5] = None  # the hosts' own vertex column
    if variant in ("single", "broadcast"):
        args[6] = args[6][:1, :1].contiguous()
        args[7] = torch.full((1, 1), 0.5, device=card)
    if variant == "broadcast":
        args[2] = torch.tensor(kw["bootstrap_end"] + 5, device=card)
        args[3] = torch.tensor(False, device=card)
    got = kernels.link_send(*args, **kw)
    want = kernels.link_send_plain(*args, **kw)
    _same(got, want)
    assert got.deliver.any() and got.drop.any()
    unreachable = args[0] & ~(got.deliver | got.drop)
    assert bool(unreachable.any()) == (variant in ("table", "own_vertex"))


@pytest.mark.parametrize("name", ["mixed_phold", "mixed_flood"])
def test_optimistic_run_through_kernels_matches_plain_run(card, name):
    """Optimistic runs that roll back, on the matrix path (PHOLD over the
    two-vertex graph) and on the loop path (the mixed flood), through the
    kernels and through the plain versions on the card: equal windows,
    rollbacks, counters, chain and state arrays."""
    import chip_smoke
    from shadow_tpu_torch import interop

    cfg = (chip_smoke.mixed_phold(1024, 4) if name == "mixed_phold"
           else chip_smoke.mixed_flood())
    a = build_simulation(cfg, device=card)
    b = build_simulation(cfg, device=card)
    b.ops = kernels.PLAIN_OPS
    kernels.reset_launches()
    ra = a.run_optimistic()
    launches = {k.name: k.launches for k in kernels.KERNELS}
    assert launches["spec_check"] > 0 and ra[1] > 0
    assert b.run_optimistic() == ra
    assert {k.name: k.launches for k in kernels.KERNELS} == launches
    assert a.counters() == b.counters()
    assert a.audit_chain() == b.audit_chain()
    if name == "mixed_flood":
        assert a.audit_chain() == chip_smoke.MIXED_FLOOD_CHAIN
    na, nb = interop.state_to_numpy(a.state), interop.state_to_numpy(b.state)
    for path in na:
        assert np.array_equal(na[path], nb[path]), path
