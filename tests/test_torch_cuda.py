"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Each kernel (``shadow_tpu_torch/csrc``) runs on CUDA tensors and its plain
version runs on the same tensors; the outputs must be equal bit for bit.
The whole path is integer arithmetic or float32 with a defined rounding,
so there is no tolerance. Inputs come from real windows of small PHOLD
runs, plus seeded numpy variations (draw counters about to wrap, random
seq numbers, lossy and multi-vertex topologies).

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
    the card, and each kernel launched once a window."""
    a = build_phold_flagship(128, msgload=4, stop_s=4, device=card)
    b = build_phold_flagship(128, msgload=4, stop_s=4, device=card)
    b.ops = kernels.PLAIN_OPS
    kernels.reset_launches()
    wa = a.run()
    assert [k.launches for k in kernels.KERNELS] == [wa] * 3
    wb = b.run()
    assert [k.launches for k in kernels.KERNELS] == [wa] * 3
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
