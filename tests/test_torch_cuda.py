"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Each kernel (``shadow_tpu_torch/csrc``) runs on CUDA tensors and its plain
version runs on the same tensors; the outputs must be equal bit for bit.
The whole path is integer arithmetic or float32/float64 with a defined
rounding, so there is no tolerance. Inputs come from real windows of
small PHOLD runs, plus seeded numpy variations (draw counters about to
wrap, random seq numbers, lossy and multi-vertex topologies); the loop
path's kernels take seeded random states (``random_*`` below: NEVER
lanes, full rings and boxes, key ties, token debt, drop mode;
``chip_smoke.synthetic_select`` at widths over many blocks, with pool
budgets that bind at a block boundary) and whole runs of a congested UDP
flood; ``loop_route``, ``ring_append``, ``tcp_ack``, ``tcp_reorder`` and
``tcp_out`` write into the tensors they are given, so each is handed
clones after its plain version has run, and must return the clones with
every cell its plain version leaves as it was unchanged (the TCP kernels
every cell outside the masked hosts' slots); the TCP kernels take seeded
lossy
tables
(``chip_smoke.synthetic_tcp_*`` and ``random_tcp_*``: every branch of
the ACK and reorder blocks, sequence numbers across the wrap, slots
outside [0, S) on masked-off hosts) and a whole lossy TCP run; the
optimistic driver's four kernels take the synthetic tables of
``chip_smoke.synthetic_*`` (violations and filler destinations, idle
gaps and NEVER lanes, wrapped ring heads, unreachable pairs and control
packets) and whole optimistic runs that roll back on both paths, one of
them after appending to both rings; the NIC's admission kernels
(``nic_tx``, ``nic_rx``, ``nic_gate``) take ``chip_smoke.synthetic_nic_*``
tables (token debt, NEVER lanes, both sides of the end of bootstrap,
queued NICs and full or wrapped router rings, loopback, unreachable and
lossy paths, control packets, one ``now`` or ``dst`` for every host, a
window wholly inside bootstrap), one launch a call. ``phold_forward``
also runs PHOLD's hot-spot and local-span variants, and its pick alone
(``kernels.phold_pick``) every draw the uniform takes and the float32
values around each split; ``cpu_serialize`` takes seeded rows (empty
tails and hosts, an empty cell between real ones, cost-0 hosts, CPU
clocks past the window) in both forms, and whole runs with the CPU model
on both paths; ``audit_commit`` takes exec times apart from its times.

Marked ``cuda``: the card decides inside the fixture, and the tests skip
where there is none. This file imports neither jax nor the JAX package,
so it runs on a machine without them:

    pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import chip_smoke
from shadow_tpu_torch import kernels
from shadow_tpu_torch.core import engine
from shadow_tpu_torch.core.simtime import NEVER
from shadow_tpu_torch.flagship import SELF_LOOP_50MS_GML, build_phold_flagship
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
    """PHOLD at K = 19, 4, 24 (the bench shape's K, on 37 hosts: not a
    multiple of phold_forward's 8 hosts a block) and 40 (chunks of 32
    columns), on one host, and over the three-vertex table."""
    return [
        build_phold_flagship(96, msgload=3, stop_s=3, device=device),
        build_phold_flagship(40, msgload=2, stop_s=3, K=4, device=device),
        build_phold_flagship(37, msgload=8, stop_s=3, device=device),
        build_phold_flagship(41, msgload=3, stop_s=3, K=40, device=device),
        build_phold_flagship(1, msgload=2, stop_s=3, device=device),
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


def _extract_args(pool, ws, we, H, Kc):
    s_k1, perm = engine.window_keys(pool, ws, we, H, Kc)
    return (s_k1, perm, pool.time, pool.dst, pool.src, pool.seq, pool.kind,
            pool.payload, H, Kc)


def _flat_extract(out):
    return [*out.dense, *out.tail]


def _extract_eq(args):
    n = kernels.EXTRACT_SLOTS.launches
    got = kernels.extract_slots(*args)
    assert kernels.EXTRACT_SLOTS.launches == n + 1
    want = kernels.extract_slots_plain(*args)
    _eq(_flat_extract(got), _flat_extract(want))


def _random_pool(rs, C, H, ws, we, PP, device):
    """Rows in and past the window, free rows, destinations outside
    [0, H), a hot host past Kc, ties in (time, src)."""
    u = rs.random(C)
    time = np.where(u < 0.5, ws + rs.integers(0, 6, C) * ((we - ws) // 6),
                    np.where(u < 0.8, we + rs.integers(0, we - ws, C),
                             NEVER)).astype(np.int64)
    dst = rs.integers(-2, H + 2, C).astype(np.int32)
    dst[rs.random(C) < 0.2] = 0
    cols = dict(
        time=time, dst=dst, src=rs.integers(0, 4, C).astype(np.int32),
        seq=rs.integers(0, 2**31 - 1, C).astype(np.int32),
        kind=rs.integers(0, 4, C).astype(np.int32),
        payload=rs.integers(-2**63, 2**63 - 1, (C, PP), dtype=np.int64),
    )
    from shadow_tpu_torch.core.state import EventPool

    return EventPool(**{k: torch.as_tensor(v, device=device)
                        for k, v in cols.items()})


def test_extract_slots_matches_plain(card):
    """extract_slots places every row as its plain version's sort does:
    PHOLD windows at Kc = K and at the loop path's K + 1, the congested
    flood's loop-path windows, pools whose C is not a multiple of the
    block, and a Kc whose halo reaches past the block before."""
    for sim in _sims(card):
        H = sim.num_hosts
        for st, ws, we in _windows(sim, 4):
            for Kc in (sim.K, sim.K + 1):
                _extract_eq(_extract_args(st.pool, ws, we, H, Kc))
    sim = build_simulation(CONGESTED_FLOOD, device=card)
    for _ in range(6):
        mn, occ, _, _ = sim._frontier(sim.stop_time)
        we = min(mn + sim.runahead, sim.stop_time)
        _extract_eq(_extract_args(sim.state.pool, mn, we, sim.num_hosts,
                                  sim.K + 1))
        sim.step_loop(mn, we, occ)
    rs = np.random.default_rng(21)
    ws, we = 1_000_000_000, 1_050_000_000
    for C, H, Kc, PP in ((1000, 37, 5, 1), (777, 20, 13, 6),
                         (900, 3, 300, 1), (5, 1, 1, 1)):
        pool = _random_pool(rs, C, H, ws, we, PP, card)
        _extract_eq(_extract_args(pool, ws, we, H, Kc))


def test_extract_slots_past_halo_matches_plain(card):
    """A Kc past the halo a block stages in shared memory (``kMaxKc``)
    is no longer refused: its instance searches the keys in device memory
    and equals the plain version, at the limit and past it (1,025 and
    more), with hosts whose runs fill and overfill their Kc columns."""
    rs = np.random.default_rng(22)
    Kc = kernels.csrc_constant("extract_slots.cu", "kMaxKc")
    for C, H, kc in ((300, 2, Kc), (3000, 2, Kc + 1), (5000, 3, 1500),
                     (2500, 1, Kc + 1)):
        pool = _random_pool(rs, C, H, 0, 10**9, 2, card)
        # host 0's run: up to 1,600 rows in the window
        n = min(C, 1600)
        pool.time[:n] = torch.arange(n, device=card) * 1000
        pool.dst[:n] = 0
        args = _extract_args(pool, 0, 10**9, H, kc)
        _extract_eq(args)
        if kc > Kc:  # some host's run passes the halo's reach
            want = kernels.extract_slots_plain(*args)
            assert bool((want.dense.time[:, Kc:] != NEVER).any())


def _sort_eq(args):
    n = kernels.WINDOW_SORT.launches
    got = kernels.window_sort(*args)
    assert kernels.WINDOW_SORT.launches == n + 1
    _eq(got, kernels.window_sort_plain(*args))


def _sort_args(pool, ws, we, H, Kc):
    return (pool.time, pool.dst, pool.src, pool.seq, ws, we, H, Kc)


def test_window_sort_matches_plain(card):
    """window_sort's (s_k1, perm) equal the plain version's two stable
    sorts: PHOLD's and the congested flood's real windows at Kc = K and
    K + 1; seeded pools at the bench shape (C = 196,608, H = 16,384,
    Kc = 24 and 25), at C not a multiple of the tile, at one row and one
    host, at Kc = 1,025; a window over 2^44 ns whose clipped rows tie the
    fillers' k1 on both sides of them in k2; pools whose src and seq are
    the same on every row (their digits skipped), and every row NEVER."""
    for sim in _sims(card)[:4]:
        H = sim.num_hosts
        for st, ws, we in _windows(sim, 3):
            for Kc in (sim.K, sim.K + 1):
                _sort_eq(_sort_args(st.pool, ws, we, H, Kc))
    sim = build_simulation(CONGESTED_FLOOD, device=card)
    for _ in range(4):
        mn, occ, _, _ = sim._frontier(sim.stop_time)
        we = min(mn + sim.runahead, sim.stop_time)
        _sort_eq(_sort_args(sim.state.pool, mn, we, sim.num_hosts,
                            sim.K + 1))
        sim.step_loop(mn, we, occ)
    rs = np.random.default_rng(31)
    ws, we = 5_000_000_000, 5_010_000_000
    for C, H, Kc in ((196_608, 16_384, 24), (196_608, 16_384, 25),
                     (4097, 37, 5), (1, 1, 1), (300, 1, 1025)):
        pool = _random_pool(rs, C, H, ws, we, 1, card)
        _sort_eq(_sort_args(pool, ws, we, H, Kc))
    pool = _random_pool(rs, 3000, 9, ws, we, 1, card)
    clip = torch.as_tensor(rs.random(3000) < 0.3, device=card)
    pool.time[clip] = ws + kernels.DT_MAX + 1
    pool.dst[clip] = 2
    pool.src[clip & (pool.seq & 1 == 0)] = 0
    pool.seq[clip & (pool.seq & 2 == 0)] = 0
    _sort_eq(_sort_args(pool, ws, ws + kernels.DT_MAX + 8, 9, 3))
    pool.src[:] = 3
    pool.seq[:] = 7
    _sort_eq(_sort_args(pool, ws, we, 9, 3))
    pool.time[:] = NEVER
    _sort_eq(_sort_args(pool, ws, we, 9, 3))


def _merge_eq(blocks, C):
    n = kernels.POOL_MERGE.launches
    got = kernels.pool_merge(blocks, C)
    assert kernels.POOL_MERGE.launches == n + 1
    want = kernels.pool_merge_plain(blocks, C)
    _eq(got, want)
    return want


def _merge_block(rs, n, PP, device, H=None, cut=False, never=0.4,
                 span=40_000_000):
    t = rs.integers(0, span, n).astype(np.int64)
    t[rs.random(n) < never] = NEVER
    t[rs.random(n) < 0.1] = 5  # ties across blocks
    b = dict(
        time=t, dst=rs.integers(-1, 50, H or n).astype(np.int32),
        src=rs.integers(0, 9, n).astype(np.int32),
        seq=rs.integers(0, 9, n).astype(np.int32),
        kind=rs.integers(0, 4, n).astype(np.int32),
        payload=rs.integers(-2**62, 2**62, (n, PP), dtype=np.int64),
        cut=rs.integers(0, n // H + 1, H).astype(np.int32) if cut else None)
    return kernels.MergeBlock(**{k: None if v is None else
                                 torch.as_tensor(v, device=device)
                                 for k, v in b.items()})


def test_pool_merge_matches_plain(card):
    """pool_merge's next pool and dropped count equal the plain version's
    cat, stable sort by time and gathers: every merge of PHOLD runs (two
    blocks: the tail and the emissions) and of the congested flood and an
    optimistic mixed run that rolls back (four: the dense cells after
    each host's cursor, the tail, the outbox, the inbox, their dst one a
    host), each call through the kernel and the plain version; seeded
    blocks at the bench shape (C = 196,608 and 393,216 emissions), with
    live rows past C (dropped > 0), with every row NEVER, with times past
    2^40 ns (every digit but the top sorted), one row to spare, and
    payloads of 1 and 6 words."""
    calls = []

    def checked(blocks, C):
        calls.append(len(blocks))
        return _merge_eq(blocks, C)

    ops = kernels.KERNEL_OPS._replace(pool_merge=checked)
    for sim in (*_sims(card)[:2], build_simulation(CONGESTED_FLOOD,
                                                   device=card)):
        sim.ops = ops
        sim.run(until=sim.stop_time // 2)
    from chip_smoke import mixed_phold

    sim = build_simulation(mixed_phold(64, 2), device=card)
    sim.ops = ops
    _, rollbacks = sim.run_optimistic(until=1_500_000_000)
    assert rollbacks > 0
    assert 2 in calls and 4 in calls
    rs = np.random.default_rng(41)
    C, H = 196_608, 16_384
    want = _merge_eq([_merge_block(rs, C, 6, card, never=0.3),
                      _merge_block(rs, H * 24, 6, card, never=0.6)], C)
    assert int(want.dropped) > 0
    for PP in (1, 6):
        blocks = [_merge_block(rs, 20 * 9, PP, card, H=20, cut=True),
                  _merge_block(rs, 3000, PP, card),
                  _merge_block(rs, 20 * 8, PP, card),
                  _merge_block(rs, 20 * 4, PP, card, H=20, never=0.7)]
        M = sum(b.time.shape[0] for b in blocks)
        for cap in (2000, 3000, M):
            _merge_eq(blocks, cap)
        blocks = [_merge_block(rs, 2048, PP, card, never=1.0),
                  _merge_block(rs, 100, PP, card, never=1.0)]
        assert int(_merge_eq(blocks, 2048).dropped) == 0
        blocks = [_merge_block(rs, 5000, PP, card, never=0.0, span=2**50)]
        _merge_eq(blocks, 1000)
        _merge_eq(blocks, 5000)


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
            ctr[:4] = torch.tensor([0, 1, 2**31, 2**32 - 1])[:H]
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


def _variant(device, **opts):
    """The flagship's shape at 64 hosts with PHOLD options ``opts``, hot
    hosts past K = 8 where hot."""
    return build_simulation({
        "general": {"stop_time": 3, "seed": 11},
        "network": {"graph": {"type": "gml", "inline": SELF_LOOP_50MS_GML}},
        "experimental": {"event_capacity": 1024,
                         "events_per_host_per_window": 8,
                         "outbox_slots": 8, "inbox_slots": 4},
        "hosts": {"peer": {"quantity": 64, "app_model": "phold",
                           "app_options": {"msgload": 4, "runtime": 2,
                                           **opts}}},
    }, device=device)


@pytest.mark.parametrize("opts", [
    {"hot_frac": 0.125, "hot_share": 0.5},
    {"hot_frac": 0.13, "hot_share": 0.3},
    {"local_span": 2},
    {"local_span": 31},
])
def test_phold_forward_variants_match_plain(card, opts):
    sim = _variant(card, **opts)
    H, K, p, app = sim.num_hosts, sim.K, sim.params, sim.app
    for st, ws, we in _windows(sim, 6):
        dense, _ = engine.dense_extract(st.pool, ws, we, H, K,
                                        kernels.PLAIN_OPS)
        h = st.host
        args = (dense.time, dense.payload, st.rng_keys, h.rng_counter,
                h.seq_next, h.gid, h.vertex, p.latency_vv, p.reliability_vv,
                p.vertex_g)
        kw = dict(num_hosts=H, stop_sending=app.stop_sending,
                  bootstrap_end=p.bootstrap_end, win_end=we, kind=1,
                  **app.pick)
        _eq(kernels.phold_forward(*args, **kw),
            kernels.phold_forward_plain(*args, **kw))


@pytest.mark.parametrize("H,opts", [
    (1000, {}),
    (16384, {"hot_frac": 0.125, "hot_share": 0.5}),
    (1000, {"hot_frac": 0.13, "hot_share": 0.3}),
    (777, {"hot_frac": 0.3, "hot_share": 0.6}),
    (16384, {"local_span": 2}),
    (5, {"local_span": 4}),
])
def test_phold_pick_matches_plain_on_swept_draws(card, H, opts):
    """phold_forward's pick on every draw the uniform takes and the
    float32 values around each split (chip_smoke.pick_sweep)."""
    from chip_smoke import pick_sweep
    from shadow_tpu_torch.net.apps import PholdApp

    app = PholdApp(H, **opts)
    u, me = (torch.as_tensor(x, device=card)
             for x in pick_sweep(H, **app.pick))
    got = kernels.phold_pick(u, me, H, **app.pick)
    assert torch.equal(got, kernels.pick_dst(u, me, H, **app.pick))


def random_serialize(rs, H, W, device):
    """(t, cost, cpu_avail) for cpu_serialize: each host's sorted times
    with an empty tail, hosts with nothing, an empty cell between real
    ones, cost-0 hosts, CPU clocks at 0, inside and past the window."""
    t = np.sort(rs.integers(10**9, 10**9 + 50_000_000, (H, W)), axis=1)
    n = rs.integers(0, W + 1, H)
    t[np.arange(W)[None, :] >= n[:, None]] = NEVER
    t[rs.random(H) < 0.05] = NEVER
    if W > 3:
        t[rs.random(H) < 0.05, W // 2] = NEVER
    cost = rs.choice([0, 1, 5_000_000, 10_000_000], H).astype(np.int64)
    avail = rs.integers(10**9, 10**9 + 200_000_000, H)
    avail[rs.random(H) < 0.3] = 0
    avail[rs.random(H) < 0.1] = 10**9 + 10**10
    return tuple(torch.as_tensor(x, device=device) for x in (t, cost, avail))


@pytest.mark.parametrize("matrix", [True, False])
@pytest.mark.parametrize("H,W", [(1000, 24), (4097, 8), (37, 1), (129, 33)])
def test_cpu_serialize_matches_plain(card, matrix, H, W):
    args = random_serialize(np.random.default_rng(H * W), H, W, card)
    n = kernels.CPU_SERIALIZE.launches
    got = kernels.cpu_serialize(*args, matrix)
    assert kernels.CPU_SERIALIZE.launches == n + 1
    want = kernels.cpu_serialize_plain(*args, matrix)
    _eq(got, want)
    # events were delayed (the delay's sum may wrap: on the loop form a
    # real cell after an empty one of a cost-0 host executes at NEVER, as
    # the JAX package's chain computes it; the loop path's taken events
    # are a prefix, so it never gets such a row)
    assert bool(((want.exec_t != args[0]) & (args[0] != NEVER)).any())


def test_cpu_model_runs_match_plain_runs(card):
    """PHOLD with a quarter of its hosts at 10 ms an event (the matrix
    path) and a flood with its servers at 5 ms (the loop path): through
    the kernels and the plain versions, the same counters, chain and
    state; cpu_serialize launched once a window pass, or once a micro-step
    that commits."""
    from shadow_tpu_torch import interop

    flood = {
        "general": {"stop_time": 2, "seed": 7},
        "network": {"graph": {"type": "gml", "inline": SELF_LOOP_50MS_GML}},
        "experimental": {"event_capacity": 4096,
                         "events_per_host_per_window": 8},
        "hosts": {"server": {"quantity": 4, "app_model": "udp_flood",
                             "app_options": {"role": "server"},
                             "cpu_ns_per_event": "5 ms"},
                  "client": {"quantity": 28, "app_model": "udp_flood",
                             "app_options": {"interval": "20 ms",
                                             "runtime": 1}}},
    }
    phold = {"general": {"stop_time": 3, "seed": 11},
             "network": {"graph": {"type": "gml",
                                   "inline": SELF_LOOP_50MS_GML}},
             "experimental": {"event_capacity": 1024,
                              "events_per_host_per_window": 8,
                              "outbox_slots": 8, "inbox_slots": 4},
             "hosts": {
                 "peer": {"quantity": 48, "app_model": "phold",
                          "app_options": {"msgload": 4, "runtime": 2}},
                 "loaded": {"quantity": 16, "app_model": "phold",
                            "app_options": {"msgload": 4, "runtime": 2},
                            "cpu_ns_per_event": "10 ms"}}}
    for cfg in (phold, flood):
        a = build_simulation(cfg, device=card)
        b = build_simulation(cfg, device=card)
        b.ops = kernels.PLAIN_OPS
        kernels.reset_launches()
        wa = a.run()
        n = kernels.CPU_SERIALIZE.launches
        assert n == (wa if cfg is phold else kernels.AUDIT_COMMIT.launches)
        assert b.run() == wa
        assert kernels.CPU_SERIALIZE.launches == n
        assert a.counters() == b.counters()
        assert a.counters()["cpu_delay_applied"] > 0
        assert a.audit_chain() == b.audit_chain()
        na = interop.state_to_numpy(a.state)
        nb = interop.state_to_numpy(b.state)
        for path in na:
            assert np.array_equal(na[path], nb[path]), path


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
            # exec times: the times (the CPU model off), or shifted later
            shift = torch.as_tensor(rs.integers(0, 2**30, (H, K)),
                                    device=card)
            shifted = torch.where(dense.time != NEVER, dense.time + shift,
                                  dense.time)
            for dg, e_t in ((ob.host_digest, dense.time), (digest, shifted)):
                args = (dense.time, e_t, dense.src, dense.kind, st.host.gid,
                        dg, ob.host_events, ob.host_last_t, st.host.done_t)
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
    want = {k.name: wa if k.name in ("window_sort", "extract_slots",
                                     "phold_forward", "audit_commit",
                                     "spec_check", "pool_merge") else 0
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
    pool = _random_pool(np.random.default_rng(23), 4, 2, 0, 10, 1, card)
    args = _extract_args(pool, 0, 10, 2, 2)
    with pytest.raises(ValueError):  # int32 keys
        kernels.extract_slots(args[0].to(torch.int32), *args[1:])
    with pytest.raises(ValueError):  # a strided pool column
        kernels.extract_slots(*args[:2], torch.zeros(
            8, dtype=torch.int64, device=card)[::2], *args[3:])
    t = torch.full((4, 3), NEVER, dtype=torch.int64, device=card)
    with pytest.raises(ValueError):
        kernels.audit_commit(t, t, t, t, t, t, t, t, t)
    from chip_smoke import synthetic_tcp_reorder

    args, kw = synthetic_tcp_reorder(64, 2, 65, card)
    with pytest.raises(ValueError):  # a board row wider than 64 chunks
        kernels.tcp_reorder(*args, **kw)


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


def _need_hot(args, kw):
    """Each host's need where it is hot, 0 elsewhere: the taken events of
    the same call with no outbox or pool limit (the batch plan depends on
    neither), where every hot host is valid."""
    free = kernels.loop_select_plain(*args, **{**kw, "O": 2**30,
                                               "pool_budget": 2**62})
    need_by_kind = args[14]
    k0 = free.take_k[:, 0].long()
    known = (k0 >= 0) & (k0 < need_by_kind.shape[0])
    base = torch.where(known, need_by_kind[k0.clamp(0, need_by_kind.shape[0]
                                                    - 1)], 0)
    taken = (free.take_t != NEVER).sum(dim=1)  # the head and its batch
    return torch.where(free.valid, base * taken, 0).long()


@pytest.mark.parametrize("B", [1, 3, 8, 32, 33, 64])
@pytest.mark.parametrize("H,K", [(3 * 256 + 17, 8), (50_176, 4)])
def test_loop_select_across_blocks_matches_plain(card, H, K, B):
    """Widths over several blocks and no multiple of the block: a random
    budget, one that stalls host 0, and one whose first stall is the first
    host of the second block (the prefix carried across blocks); inboxes
    of B slots whose free slots keep stale src and seq."""
    from chip_smoke import synthetic_select

    G, O = 4, 8
    args, kw = synthetic_select(H, K, B, O, 6, G,
                                np.array([1, 2, 1, 3], np.int32), card,
                                seed=H + B, bulk_kind=2)
    args = list(args)
    # hosts 0 and SELECT_BLOCK hot: their dense head at the window start,
    # first in key order; room for any need
    for h in (0, kernels.SELECT_BLOCK):
        args[0][h, 0], args[1][h, 0], args[2][h, 0] = 1_000_000_000, 0, 0
        args[5][h] = 0
        args[11][h] = 0
    stale = args[6] == NEVER
    assert bool((stale & ((args[7] != 0) | (args[8] != 0))).any())
    need = _need_hot(args, kw)
    assert int(need[0]) > 0 and int(need[kernels.SELECT_BLOCK]) > 0
    box_used = int(args[11].sum() + (args[6] != NEVER).sum())
    cum = torch.cumsum(need, dim=0)
    budgets = {"random": kw["pool_budget"],
               "host 0": box_used + int(need[0]) - 1,
               "second block": box_used + int(cum[kernels.SELECT_BLOCK]) - 1}
    # no pool limit: every hot host with room is valid
    free = kernels.loop_select_plain(*args, **{**kw, "pool_budget": 2**62})
    S = kernels.SELECT_BLOCK
    assert bool(free.valid[0]) and bool(free.valid[S])
    for what, budget in budgets.items():
        kw["pool_budget"] = budget
        n = kernels.LOOP_SELECT.launches
        got = kernels.loop_select(*args, **kw)
        assert kernels.LOOP_SELECT.launches == n + 1
        want = kernels.loop_select_plain(*args, **kw)
        if what == "host 0":
            assert bool(want.stalled[0]) and not bool(want.valid.any())
        if what == "second block":
            assert torch.equal(want.valid[:S], free.valid[:S])
            assert bool(want.stalled[S]) and not bool(want.valid[S:].any())
        _eq(got, want)


@pytest.mark.parametrize("B", [33, 64, 100])
def test_loop_select_wide_inbox_matches_plain(card, B):
    """Inboxes wider than the tournament held in registers (``kMaxB``):
    the same tournament walked from device memory, on random states with
    key ties, stale empty slots and every gate."""
    rs = np.random.default_rng(B)
    for G, gate, excl, bk in ((4, True, True, 3), (1, False, False, 3),
                              (4, True, True, -1)):
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
        want = kernels.loop_select_plain(*args, **kw)
        _eq(got, want)
        # some hosts take their event from the inbox
        assert bool((want.inbox_time != args[6]).any())


@pytest.mark.parametrize("seed", range(4))
def test_loop_route_matches_plain(card, seed):
    rs = np.random.default_rng(100 + seed)
    records, boxes, kw = random_route_inputs(rs)
    r = to_torch(records, card)
    bx = kernels.Boxes(**to_torch(boxes, card))
    args = [r[k] for k in ("m", "t", "d", "k", "p", "seq_next", "gid",
                           "defer_t", "defer_s", "defer_q")]
    got = kernels.loop_route(*args, kernels.Boxes(*(x.clone() for x in bx)),
                             **kw)
    want = kernels.loop_route_plain(*args, bx, **kw)
    _eq(got.boxes, want.boxes)
    _eq(got[1:], want[1:])


@pytest.mark.parametrize("E", [2, 9, 40])
def test_loop_route_in_place_matches_plain(card, E):
    """The kernel writes into the boxes it is given and returns them;
    over several blocks, with full inboxes (self emissions deferred) and
    full outboxes (records dropped), and with more records than the 32
    whose masks the kernel reads at a time."""
    rs = np.random.default_rng(150 + E)
    H, B, O = 3 * 256 + 17, 4, 6
    records, boxes, kw = random_route_inputs(rs, H=H, E=E, B=B, O=O)
    boxes["i_t"][: H // 4] = 1_000_000_000 + rs.integers(0, 4, (H // 4, B))
    boxes["o_count"][H // 4: H // 2] = O
    r = to_torch(records, card)
    bx = kernels.Boxes(**to_torch(boxes, card))
    args = [r[k] for k in ("m", "t", "d", "k", "p", "seq_next", "gid",
                           "defer_t", "defer_s", "defer_q")]
    work = kernels.Boxes(*(x.clone() for x in bx))
    n = kernels.LOOP_ROUTE.launches
    got = kernels.loop_route(*args, work, **kw)
    assert kernels.LOOP_ROUTE.launches == n + 1
    assert all(g is w for g, w in zip(got.boxes, work))
    want = kernels.loop_route_plain(*args, bx, **kw)
    assert int(want.stats[:, 1].sum()) > 0 and int(want.stats[:, 2].sum()) > 0
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


def _in_place(got_planes, work, before, want_planes):
    """An in-place kernel's result: the planes it returned are the clones
    it was given, and every cell the plain version left as it was is as
    it was."""
    assert len(got_planes) == len(work)
    for g, w, b, p in zip(got_planes, work, before, want_planes):
        assert g is w
        kept = p == b
        assert torch.equal(g[kept], b[kept])


@pytest.mark.parametrize("seed", range(4))
def test_ring_append_matches_plain(card, seed):
    """The plain version runs first, on the inputs; the kernel then
    writes into clones of the ring planes, in place."""
    rs = np.random.default_rng(300 + seed)
    for with_ts, P in ((True, 12), (False, 12), (True, 13)):
        a = list(to_torch(random_ring(rs, P=P, with_ts=with_ts),
                          card).values())
        want = kernels.ring_append_plain(*a)
        work = [None if x is None else x.clone() for x in a[:3]]
        n = kernels.RING_APPEND.launches
        got = kernels.ring_append(*work, *a[3:])
        assert kernels.RING_APPEND.launches == n + 1
        assert (got.ts is None) == (want.ts is None) == (not with_ts)
        assert int(want.ok.sum()) > 0
        _eq([x for x in got if x is not None],
            [x for x in want if x is not None])
        planes = [x for x in a[:3] if x is not None]
        _in_place([x for x in got[:3] if x is not None],
                  [x for x in work if x is not None], planes,
                  [x for x in want[:3] if x is not None])
        # the input tail is not written: a second call writes the same
        # cells
        _eq([x for x in kernels.ring_append(*work, *a[3:]) if x is not None],
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
                 "nic_refill", "nic_tx", "nic_rx", "nic_gate"):
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


def _tcp_in_place(k, n_per_host, args, kw):
    """The plain version on ``args``, then the kernel ``k`` (tcp_ack or
    tcp_out) on clones of the fields it writes: equal results, the clones
    returned, and every cell outside the masked hosts' slots as it was."""
    name = k.name
    want = getattr(kernels, f"{name}_plain")(*args, **kw)
    work = list(args)
    for i in k.writes:
        work[i] = args[i].clone()
    n = k.launches
    got = getattr(kernels, name)(*work, **kw)
    assert k.launches == n + 1
    _eq(got.fields, want.fields)
    _eq(got[1:], want[1:])
    mask, slot = args[0], args[1].long()
    S = args[n_per_host].shape[1]
    hit = mask[:, None] & (slot[:, None]
                           == torch.arange(S, device=mask.device)[None, :])
    for i, (_, j) in k.writes.items():
        assert got.fields[j] is work[i]
        assert torch.equal(work[i][~hit], args[i][~hit])
    return want


@pytest.mark.parametrize("seed", range(4))
def test_tcp_ack_matches_plain(card, seed):
    from chip_smoke import BRANCHES, synthetic_tcp_ack

    args, kw = synthetic_tcp_ack(2048, 8, card, seed=500 + seed)
    want = _tcp_in_place(kernels.TCP_ACK, 9, args, kw)
    for b in BRANCHES["tcp_ack"].values():  # every branch ran
        assert int(((want.flags >> b) & 1).sum()) > 0, b


@pytest.mark.parametrize("seed", range(4))
def test_tcp_reorder_matches_plain(card, seed):
    from chip_smoke import BRANCHES, synthetic_tcp_reorder

    for W in (64, 20):
        args, kw = synthetic_tcp_reorder(2048, 8, W, card, seed=600 + seed)
        want = kernels.tcp_reorder_plain(*args, **kw)
        work = [x.clone() for x in args[5:]]
        got = kernels.tcp_reorder(*args[:5], *work, **kw)
        for b in BRANCHES["tcp_reorder"].values():
            assert int(((want.flags >> b) & 1).sum()) > 0, b
        _eq(got, want)
        # rcv_nxt, ooo_map and bytes_received, in that order
        _in_place(got[:3], [work[0], work[1], work[2]],
                  [args[5], args[6], args[7]], want[:3])


def test_tcp_reorder_unaligned_board_matches_plain(card):
    """A board whose rows are not 16-byte aligned takes the byte path."""
    from chip_smoke import synthetic_tcp_reorder

    args, kw = synthetic_tcp_reorder(1024, 8, 64, card, seed=650)
    want = kernels.tcp_reorder_plain(*args, **kw)
    buf = torch.zeros(args[6].numel() + 1, dtype=torch.bool, device=card)
    board = buf[1:].view(args[6].shape)
    board.copy_(args[6])
    got = kernels.tcp_reorder(*args[:5], args[5].clone(), board,
                              args[7].clone(), **kw)
    assert got.ooo_map is board
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
    want = _tcp_in_place(kernels.TCP_OUT, 3, per + fields, {"mss": MSS})
    for b in range(5):
        assert int(((want.flags >> b) & 1).sum()) > 0, b


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
                 "nic_refill", "send_dequeue", "link_send", "nic_tx",
                 "nic_rx"):
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


@pytest.mark.parametrize("variant", ["table", "own_vertex", "single", "now",
                                     "dst", "control"])
def test_nic_tx_matches_plain(card, variant):
    """The direct send: debt, NEVER lanes, bootstrap, queued NICs,
    loopback, unreachable and lossy paths; one ``now`` or ``dst`` for
    every host; every packet a control packet."""
    from chip_smoke import synthetic_nic_tx

    H = 4099
    args, kw = synthetic_nic_tx(H, card, seed=len(variant))
    args = list(args)
    if variant == "own_vertex":
        args[13] = None  # the hosts' own vertex column
    if variant == "single":
        args[14] = args[14][:1, :1].contiguous()
        args[15] = torch.full((1, 1), 0.5, device=card)
    if variant == "now":
        args[1] = torch.tensor(kw["bootstrap_end"] + 5, device=card)
    if variant == "dst":
        args[2] = torch.tensor(7, dtype=torch.int32, device=card).expand(H)
    if variant == "control":
        args[11] = args[11].clone()
        args[11][:, 3] = 0
    n = kernels.NIC_TX.launches
    got = kernels.nic_tx(*args, **kw)
    assert kernels.NIC_TX.launches == n + 1
    want = kernels.nic_tx_plain(*args, **kw)
    _same(got, want)
    assert got.direct.any() and not got.direct.all()
    assert got.deliver.any() and got.loopback.any()
    assert bool(got.drop.any()) == (variant != "control")
    unreachable = got.counters[2] > args[18][2]
    assert bool(unreachable) == (variant in ("table", "own_vertex", "now",
                                             "control"))


def test_nic_tx_any_block_count_matches_plain(card):
    """nic_tx's blocks take their tickets from a word of their own, so
    no count of blocks is refused: at 4,095, 4,096 and 4,097 blocks of
    128 hosts (past the 12-bit count the sums once carried) the outputs
    and the four counters equal the plain version's, one launch a call,
    and a second call finds the sums back at zero."""
    from chip_smoke import synthetic_nic_tx

    n = kernels.NIC_TX.launches
    for blocks in (4095, 4096, 4097):
        H = blocks * 128
        args, kw = synthetic_nic_tx(H, card, seed=blocks)
        got = kernels.nic_tx(*args, **kw)
        _same(got, kernels.nic_tx_plain(*args, **kw))
        assert bool((got.counters > torch.stack(args[18])).all())
        _same(kernels.nic_tx(*args, **kw), got)
    assert kernels.NIC_TX.launches == n + 6


@pytest.mark.parametrize("variant", ["rings", "now", "seed"])
def test_nic_rx_matches_plain(card, variant):
    """The arrivals' admission: loopback, NEVER lanes, bootstrap, debt,
    router rings empty, full and wrapped; one ``now`` for every host."""
    from chip_smoke import synthetic_nic_rx

    args, kw = synthetic_nic_rx(3001, card, seed=7 if variant == "seed"
                                else 43)
    args = list(args)
    if variant == "now":
        args[3] = torch.tensor(kw["bootstrap_end"] + 5, device=card)
    n = kernels.NIC_RX.launches
    got = kernels.nic_rx(*args, **kw)
    assert kernels.NIC_RX.launches == n + 1
    _same(got, kernels.nic_rx_plain(*args, **kw))
    assert got.local.any() and got.queued.any() and got.no_room.any()


@pytest.mark.parametrize("free,G", [(False, 8), (True, 8), (False, 2)])
def test_nic_gate_matches_plain(card, free, G):
    """The bulk gate: debt, full buckets, queues and armed pumps; a
    window wholly inside bootstrap."""
    from chip_smoke import synthetic_nic_gate

    args, kw = synthetic_nic_gate(5003, card, free=free, G=G)
    n = kernels.NIC_GATE.launches
    got = kernels.nic_gate(*args, **kw)
    assert kernels.NIC_GATE.launches == n + 1
    _same(got, kernels.nic_gate_plain(*args, **kw))
    assert (got == G - 1).any() and (got == 0).any()


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


def test_rolled_back_attempt_with_appends_keeps_its_base(card):
    """An optimistic attempt of the mixed flood at 200 Kbit appends to
    the NIC's and the router's ring through the in-place kernel and rolls
    back: its base keeps every tensor, object, version and value (the
    attempt steps a snapshot of it, which owns the rings)."""
    import chip_smoke

    sim = build_simulation(chip_smoke.mixed_flood(
        chip_smoke.SNAPSHOT_FLOOD_BW), device=card)
    counts = {}
    sim.ops = chip_smoke.counting_appends(kernels.KERNEL_OPS, counts)
    n = kernels.RING_APPEND.launches
    _, _, viol, _, appends = chip_smoke.rolled_back_attempt(
        sim, counts, ("nic", "router"))
    assert viol < NEVER and appends["nic"] > 0 and appends["router"] > 0
    assert kernels.RING_APPEND.launches > n


def test_rolled_back_tcp_attempt_keeps_its_base(card):
    """An optimistic attempt of config 3's shape at 32 hosts runs the
    in-place tcp_ack and tcp_out on masked hosts and rolls back: its base
    keeps every tensor, object, version and value (the attempt steps a
    snapshot of it, which owns the TCP table's written fields)."""
    import chip_smoke

    sim = build_simulation(chip_smoke.config3(chip_smoke.SNAPSHOT_TCP_HOSTS),
                           device=card)
    counts = {}
    sim.ops = chip_smoke.counting_tcp(kernels.KERNEL_OPS, counts)
    n = kernels.TCP_ACK.launches, kernels.TCP_OUT.launches
    _, _, viol, _, seen = chip_smoke.rolled_back_attempt(
        sim, counts, ("tcp_ack", "tcp_out"))
    assert viol < NEVER and seen["tcp_ack"] > 0 and seen["tcp_out"] > 0
    assert kernels.TCP_ACK.launches > n[0] and kernels.TCP_OUT.launches > n[1]


# ---------------------------------------------------------------------------
# the device-queue disciplines' kernels
# ---------------------------------------------------------------------------

def qdisc_steps(rs, d, plane: dict, now: int, steps: int, check):
    """Enqueues and dequeues (two of three steps enqueue) from ``plane``
    through ``d``'s plain versions; ``check(kind, fields, args, want)``
    sees each call's inputs (``fields`` as they were before it) and the
    plain version's result. Returns the branches the steps took."""
    dev = d.spec.inv_w.device
    fields = [torch.as_tensor(plane[n], device=dev) for n in d.spec.names]
    seen = set()
    for step in range(steps):
        now += int(rs.integers(0, 30_000_000))
        if step % 3 != 2:
            args = [torch.as_tensor(x, device=dev)
                    for x in chip_smoke.synthetic_qdisc_packets(
                        rs, now, d.num_hosts)]
            want = kernels.qdisc_enqueue_plain(fields, *args, spec=d.spec)
            check("enqueue", fields, args, want)
            seen.add("enqueued" if bool(want.ok.any()) else "refused")
        else:
            w = rs.random(d.num_hosts) < 0.8
            args = [torch.as_tensor(np.where(w, now, NEVER), device=dev),
                    torch.as_tensor(w, device=dev)]
            want = kernels.qdisc_dequeue_plain(fields, *args, spec=d.spec)
            check("dequeue", fields, args, want)
            seen.add("dequeued" if bool(want.have.any()) else "idle")
        fields = list(want.fields)
    return seen


def check_qdisc_kernel(kind, fields, args, want, spec):
    """The kernel on clones of ``fields``: one launch, the clones
    returned, written as the plain version writes them and every other
    cell left as it was, and its other outputs equal."""
    k = kernels.QDISC_ENQUEUE if kind == "enqueue" else kernels.QDISC_DEQUEUE
    fn = kernels.qdisc_enqueue if kind == "enqueue" else kernels.qdisc_dequeue
    work = [f.clone() for f in fields]
    n = k.launches
    got = fn(work, *args, spec=spec)
    assert k.launches == n + 1
    _in_place(list(got.fields), work, fields, list(want.fields))
    _eq(list(got.fields), list(want.fields))
    _eq(got[1:], want[1:])


@pytest.mark.parametrize("Q", [1, 8, 64, 65])
@pytest.mark.parametrize("case", chip_smoke.QDISC_CASES)
def test_qdisc_kernels_match_plain(card, case, Q):
    """Both kernels on seeded planes of 1,000 hosts, step by step, and
    on planes whose ranks and virtual times lie near the int64 limits."""
    for extreme in (False, True):
        rs = np.random.default_rng(Q * 31 + chip_smoke.QDISC_CASES.index(case)
                                   + 7 * extreme)
        d = chip_smoke.qdisc_discipline(*case, 1000, Q, card)
        plane = chip_smoke.synthetic_qdisc_plane(
            rs, case[0], 2_000_000_000, 1000, Q, extreme=extreme)
        seen = qdisc_steps(
            rs, d, plane, 2_000_000_000, 6,
            lambda *a: check_qdisc_kernel(*a, spec=d.spec))
        assert {"enqueued", "dequeued"} <= seen


def test_qdisc_runs_match_plain_runs(card):
    """The incast scenario (pifo, wfq, RED) and the overload flood under
    eiffel with wfq and codel through the kernels equal the plain
    versions' runs on the card, state array by state array."""
    import pathlib

    import yaml

    from shadow_tpu_torch import interop

    doc = yaml.safe_load((pathlib.Path(__file__).parent.parent / "configs"
                          / "incast.yaml").read_text())
    doc.pop("sweep")
    overload = {**CONGESTED_FLOOD, "qdisc": {
        "discipline": "eiffel", "rank": "wfq", "drop": "codel",
        "bucket_width": 4096}}
    overload["hosts"] = {**CONGESTED_FLOOD["hosts"], "client": {
        **CONGESTED_FLOOD["hosts"]["client"], "bandwidth_up": "100 Kbit"}}
    for cfg in (doc, overload):
        a = build_simulation(cfg, device=card)
        b = build_simulation(cfg, device=card)
        b.ops = kernels.PLAIN_OPS
        kernels.reset_launches()
        wa = a.run()
        assert kernels.QDISC_ENQUEUE.launches > 0
        assert kernels.QDISC_DEQUEUE.launches > 0
        assert kernels.SEND_DEQUEUE.launches == 0
        assert b.run() == wa
        assert a.counters() == b.counters()
        assert a.audit_chain() == b.audit_chain()
        na = interop.state_to_numpy(a.state)
        nb = interop.state_to_numpy(b.state)
        for path in na:
            assert np.array_equal(na[path], nb[path]), path


def test_rolled_back_qdisc_attempt_keeps_its_base(card):
    """An optimistic attempt of the mixed flood at 200 Kbit under pifo
    runs the in-place qdisc kernels and rolls back: its base keeps every
    tensor, object, version and value (the attempt steps a snapshot of
    it, which owns the qdisc plane)."""
    sim = build_simulation(chip_smoke.mixed_flood_qdisc(), device=card)
    counts = {}
    sim.ops = chip_smoke.counting_qdisc(kernels.KERNEL_OPS, counts)
    _, _, viol, _, seen = chip_smoke.rolled_back_attempt(
        sim, counts, ("qdisc_enqueue", "qdisc_dequeue"))
    assert viol < NEVER and seen["qdisc_enqueue"] > 0


# -- the islands engine (K24 island_route, K19 and K3 with the shard dim) --

ISLANDS_PHOLD = {  # tests/test_islands.py's _phold_cfg(num_shards=4)
    "general": {"stop_time": 3, "seed": 42},
    "network": {"graph": {"type": "gml", "inline": SELF_LOOP_50MS_GML}},
    "experimental": {"event_capacity": 1024,
                     "events_per_host_per_window": 8, "outbox_slots": 8,
                     "inbox_slots": 4, "num_shards": 4,
                     "exchange_slots": 32},
    "hosts": {"peer": {"quantity": 64, "app_model": "phold",
                       "app_options": {"msgload": 2, "runtime": 2}}},
}


def _islands_sim(device, X=32, S=4):
    exp = dict(ISLANDS_PHOLD["experimental"], exchange_slots=X,
               num_shards=S)
    return build_simulation({**ISLANDS_PHOLD, "experimental": exp},
                            device=device)


def _island_windows(sim, n):
    """The first n windows of an islands run: (state, ws, we) before
    each."""
    out = []
    for _ in range(n):
        mn, _, clamp = sim._island_frontier()
        if mn >= sim.stop_time:
            break
        we = max(mn, min(mn + sim.runahead, sim.stop_time, clamp))
        out.append((sim.state, mn, we))
        sim.state = _clone_state(sim.state)
        sim.step(mn, we)
    return out


@pytest.mark.parametrize("S", [1, 8])
def test_window_sort_and_extract_with_shards_match_plain(card, S):
    """window_sort and extract_slots over S shards equal their plain
    versions: an islands run's real windows (S = 8: 64 hosts, X = 1, so
    rows deferred to other shards sit in every shard's pool), seeded
    [S, C] pools with rows of every shard's hosts (foreign, past the
    window, free) at the bench shape's widths and at C not a multiple of
    the tile; S = 1 is the global engine's call, as before."""
    if S > 1:
        sim = _islands_sim(card, X=1, S=S)
        for st, ws, we in _island_windows(sim, 6)[2:]:
            args = (st.pool.time, st.pool.dst, st.pool.src, st.pool.seq,
                    ws, we, sim.num_hosts, sim.K, S)
            _sort_eq(args)
            s_k1, perm = kernels.window_sort(*args)
            p = st.pool
            _extract_eq((s_k1, perm, p.time, p.dst, p.src, p.seq, p.kind,
                         p.payload, sim.num_hosts, sim.K, S))
    rs = np.random.default_rng(41 + S)
    ws, we = 5_000_000_000, 5_010_000_000
    for C, H, Kc in ((S * 40_960, 16_384, 24), (S * 4097, S * 37, 5),
                     (S, S, 1)):
        pool = _random_pool(rs, C, H, ws, we, 2, card)
        shaped = type(pool)(**{k: v.reshape((S, C // S) + v.shape[1:])
                               for k, v in vars(pool).items()})
        s_k1, perm = engine.window_keys(shaped, ws, we, H, Kc,
                                        shards=S)
        _sort_eq((shaped.time, shaped.dst, shaped.src, shaped.seq, ws, we,
                  H, Kc, S))
        _extract_eq((s_k1, perm, shaped.time, shaped.dst, shaped.src,
                     shaped.seq, shaped.kind, shaped.payload, H, Kc, S))


@pytest.mark.parametrize("S", [2, 8, 16])
@pytest.mark.parametrize("X", [1, 64, 2048])
def test_island_route_matches_plain(card, S, X):
    """island_route equals its plain version on every cell of every
    shard's next pool and its four counts: chip_smoke.synthetic_route's
    candidates (a shard with every row foreign, one whose foreign groups
    are all but empty, dt ties, dt at DT_MAX, NEVER rows interleaved),
    at pools whose remainder passes C_keep."""
    Hl, K = 32, 8
    C = S * X + max(512, S * X // 2)
    (tail, em), kw = chip_smoke.synthetic_route(
        S, X, Hl, C, C + Hl * K, card, seed=S * 7 + X)
    n = kernels.ISLAND_ROUTE.launches
    got = kernels.island_route(tail, em, **kw)
    assert kernels.ISLAND_ROUTE.launches == n + 1
    want = kernels.island_route_plain(tail, em, **kw)
    _eq(got, want)
    assert int(want.stats[:, 0].sum()) > 0  # rows dropped
    assert int(want.stats[:, 1].sum()) > 0


@pytest.mark.parametrize("X", [32, 1])
def test_islands_run_matches_plain(card, X):
    """tests/test_islands.py's PHOLD over 4 shards (X = 32, and X = 1,
    where rows defer every window) to its end through the kernels and
    through the plain versions on the card: windows, counters, chain and
    every state array equal; island_route launched once a window,
    spec_check and pool_merge never."""
    from shadow_tpu_torch import interop

    runs = []
    for ops in (kernels.KERNEL_OPS, kernels.PLAIN_OPS):
        sim = _islands_sim(card, X=X)
        sim.ops = ops
        kernels.reset_launches()
        w = sim.run_stepwise()
        runs.append((w, sim.counters(), sim.audit_chain(),
                     interop.state_to_numpy(sim.state)))
        if ops is kernels.KERNEL_OPS:
            assert kernels.ISLAND_ROUTE.launches == w
            assert kernels.SPEC_CHECK.launches == 0
            assert kernels.POOL_MERGE.launches == 0
    (w1, c1, ch1, s1), (w2, c2, ch2, s2) = runs
    assert (w1, c1, ch1) == (w2, c2, ch2)
    assert sorted(s1) == sorted(s2)
    for p in s1:
        assert np.array_equal(s1[p], s2[p]), p
    assert c1["exchange_deferred"] > 0 or X == 32
