"""The plain PyTorch version of each window-step kernel against its JAX
counterpart, on the same seeded numpy inputs.

* extraction: ``engine.dense_extract`` (with ``extract_slots``) against
  ``shadow_tpu.core.engine._dense_extract``: the dense window and the tail,
  every column and every row;
* PHOLD forward: ``PholdApp.handle_msg_matrix`` (``phold_forward``) against
  the JAX handler plus ``run_matrix``'s seq numbering and row flattening;
* commit: ``audit_commit`` against ``shadow_tpu.obs.audit.fold`` over the
  columns and ``run_matrix``'s per-host count and frontier updates.

Tolerance: exact equality everywhere. The path is integer arithmetic and
float32 with a defined rounding, so a value that is only close is a fault.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_tpu.core import engine as jengine
from shadow_tpu.core import rng as jrng
from shadow_tpu.core import soa as jsoa
from shadow_tpu.core import state as jstate
from shadow_tpu.net.apps import PholdApp as JPhold
from shadow_tpu.obs import audit as jaudit
from shadow_tpu.routing.topology import Topology as JTopology
from shadow_tpu_torch import kernels
from shadow_tpu_torch.core import engine as tengine
from shadow_tpu_torch.core import rng as trng
from shadow_tpu_torch.core import state as tstate
from shadow_tpu_torch.net.apps import PholdApp as TPhold
from shadow_tpu_torch.routing.topology import Topology as TTopology

NEVER = np.iinfo(np.int64).max
MS = 1_000_000


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# extraction
# ---------------------------------------------------------------------------


def _random_pool(rs, C, H, ws, we, PP):
    """A pool with ties in (time, src), hosts holding more than Kc window
    events, rows past the window and free rows."""
    u = rs.random(C)
    ticks = ws + rs.integers(0, 6, C) * ((we - ws) // 6)
    time = np.where(u < 0.45, ticks,
                    np.where(u < 0.75, we + rs.integers(0, 3 * (we - ws), C),
                             NEVER)).astype(np.int64)
    dst = rs.integers(0, H, C).astype(np.int32)
    dst[rs.random(C) < 0.2] = 1  # a hot host, past Kc
    return dict(
        time=time, dst=dst,
        src=rs.integers(0, 4, C).astype(np.int32),
        seq=rs.integers(0, 2**31 - 1, C).astype(np.int32),
        kind=rs.integers(0, 4, C).astype(np.int32),
        payload=rs.integers(-2**63, 2**63 - 1, (C, PP), dtype=np.int64),
    )


@pytest.mark.parametrize("seed,C,H,Kc,PP", [
    (0, 300, 8, 4, 1), (1, 1000, 20, 7, 1), (2, 64, 40, 3, 2),
])
def test_dense_extract_matches_jax(seed, C, H, Kc, PP):
    rs = np.random.default_rng(seed)
    ws, we = 1_000 * MS, 1_050 * MS
    cols = _random_pool(rs, C, H, ws, we, PP)
    jd, jt = jengine._dense_extract(
        jstate.EventPool(**{k: jnp.asarray(v) for k, v in cols.items()}),
        ws, we, H, Kc, PP,
    )
    td, tt = tengine.dense_extract(
        tstate.EventPool(**{k: _t(v) for k, v in cols.items()}),
        ws, we, H, Kc, kernels.PLAIN_OPS,
    )
    for f in ("time", "src", "seq", "kind", "payload"):
        want = np.asarray(getattr(jd, f))
        got = getattr(td, f).numpy()
        assert got.dtype == want.dtype and np.array_equal(got, want), f
    for f in ("time", "dst", "src", "seq", "kind"):
        want = np.asarray(getattr(jt, f))
        got = getattr(tt, f).numpy()
        assert got.dtype == want.dtype and np.array_equal(got, want), f
    want_p = np.stack([np.asarray(p) for p in jt.payload], axis=-1)
    assert np.array_equal(tt.payload.numpy(), want_p)
    # the window really had hosts past Kc, ties and free rows
    assert (np.asarray(jd.time) != NEVER).sum(axis=1).max() == Kc


def test_extract_slots_plain_equals_search_form():
    """The cummax form of the plain version equals the kernel's search
    form: rank = i - (first index of the row's host key)."""
    rs = np.random.default_rng(3)
    H, Kc = 30, 5
    keys = np.sort(rs.integers(0, H + 1, 500))
    k1 = (keys << kernels.DT_BITS) | rs.integers(0, 1000, 500)
    k1 = np.sort(k1)
    first = np.searchsorted(k1, (k1 >> kernels.DT_BITS) << kernels.DT_BITS)
    rank = np.arange(500) - first
    key = k1 >> kernels.DT_BITS
    want = np.where((key < H) & (rank < Kc), key * Kc + rank, 500)
    got = kernels.extract_slots_plain(_t(k1), H, Kc).numpy()
    assert np.array_equal(got, want.astype(np.int32))


# ---------------------------------------------------------------------------
# PHOLD forward
# ---------------------------------------------------------------------------

SELF_LOOP = """graph [
  node [ id 0 bandwidth_down "1 Gbit" bandwidth_up "1 Gbit" ]
  edge [ source 0 target 0 latency "50 ms" packet_loss {loss} ]
]"""
THREE_VERTEX = """graph [
  node [ id 0 ] node [ id 1 ] node [ id 2 ]
  edge [ source 0 target 0 latency "20 ms" packet_loss 0.05 ]
  edge [ source 1 target 1 latency "25 ms" packet_loss 0.0 ]
  edge [ source 2 target 2 latency "30 ms" packet_loss 0.1 ]
  edge [ source 0 target 1 latency "40 ms" packet_loss 0.2 ]
  edge [ source 1 target 2 latency "45 ms" packet_loss 0.0 ]
  edge [ source 0 target 2 latency "50 ms" packet_loss 0.3 ]
]"""

TOPOLOGIES = {
    "lossless": (SELF_LOOP.format(loss=0.0), 1, 0),
    "lossy": (SELF_LOOP.format(loss=0.1), 1, 1_004 * MS),
    "three_vertex": (THREE_VERTEX, 3, 1_003 * MS),
}


def _baked(cls, gml, H, nv):
    topo = cls.from_gml(gml)
    for i in range(H):
        topo.attach_host(i, network_node_id=i % nv)
    return topo.bake()


@pytest.mark.parametrize("topo", sorted(TOPOLOGIES))
def test_phold_forward_matches_jax(topo):
    gml, nv, boot = TOPOLOGIES[topo]
    H, K, seed = 48, 6, 11
    jb, tb = _baked(JTopology, gml, H, nv), _baked(TTopology, gml, H, nv)
    assert np.array_equal(jb.latency_vv, tb.latency_vv)
    assert np.array_equal(jb.reliability_vv, tb.reliability_vv)
    assert np.array_equal(jb.host_vertex, tb.host_vertex)
    multi = jb.latency_vv.shape[0] > 1

    rs = np.random.default_rng(len(topo))
    ws, we = 1_000 * MS, 1_020 * MS
    n = rs.integers(0, K + 1, H)
    d_t = np.full((H, K), NEVER, np.int64)
    for h in range(H):
        d_t[h, :n[h]] = np.sort(rs.integers(ws, we, n[h]))
    d_p = rs.integers(-2**63, 2**63 - 1, (H, K, 1), dtype=np.int64)
    ctr = rs.integers(0, 2**32, H, dtype=np.int64)
    ctr[:4] = [0, 1, 2**31, 2**32 - 1]
    seq = rs.integers(0, 2**31 - 64, H).astype(np.int32)
    # sends stop inside the window, after the lossy bootstrap ends
    start, runtime = 500 * MS, 512 * MS

    japp = JPhold(H, msgload=2, size_bytes=77, start_time=start,
                  runtime=runtime)
    jparams = jstate.NetParams(
        latency_vv=jnp.asarray(jb.latency_vv),
        reliability_vv=jnp.asarray(jb.reliability_vv),
        bootstrap_end=jnp.int64(boot),
        vertex_g=jnp.asarray(jb.host_vertex) if multi else None,
    )
    host = jstate.make_host_state(H, jb.host_vertex).replace(
        rng_counter=jnp.asarray(ctr.astype(np.uint32)),
        seq_next=jnp.asarray(seq),
    )
    js = jstate.SimState(
        now=jnp.int64(ws), pool=jstate.EventPool.empty(8, 2), host=host,
        counters=jstate.Counters.zeros(), rng_keys=jrng.host_keys(seed, H),
        subs={"phold": japp.init_sub()},
    )
    valid = d_t != NEVER
    mv = jengine.MatrixEventView(
        mask=jnp.asarray(valid), time=jnp.asarray(d_t),
        src=jnp.zeros((H, K), jnp.int32), seq=jnp.zeros((H, K), jnp.int32),
        payload=jsoa.unpack_words(jnp.asarray(d_p), 2),
    )
    memit = jengine.MatrixEmitter()
    js = japp.handle_msg_matrix(js, mv, memit, jparams)
    (rec,) = memit.records
    mask = np.asarray(rec.mask)
    r_time = np.asarray(rec.time)
    # run_matrix's seq numbering and flattening of the one record
    mi = mask.astype(np.int32)
    want_rows = dict(
        time=np.where(mask, r_time, NEVER).reshape(-1),
        dst=np.asarray(rec.dst).reshape(-1),
        src=np.broadcast_to(np.arange(H, dtype=np.int32)[:, None],
                            (H, K)).reshape(-1),
        seq=(seq[:, None] + np.cumsum(mi, axis=1, dtype=np.int32)
             - mi).reshape(-1),
        kind=np.asarray(rec.kind).reshape(-1),
        payload=np.asarray(jsoa.pack_words(rec.payload)).reshape(H * K, -1),
    )

    tapp = TPhold(H, msgload=2, size_bytes=77, start_time=start,
                  runtime=runtime)
    tparams = tstate.NetParams(
        latency_vv=_t(tb.latency_vv), reliability_vv=_t(tb.reliability_vv),
        bootstrap_end=boot,
        vertex_g=_t(tb.host_vertex.astype(np.int32)) if multi else None,
    )
    th = tstate.make_host_state(H, tb.host_vertex)
    th.rng_counter, th.seq_next = _t(ctr), _t(seq)
    ts = tstate.SimState(
        now=ws, pool=tstate.EventPool.empty(8, 2), host=th,
        counters=tstate.Counters.zeros(), rng_keys=trng.host_keys(seed, H),
        subs={"phold": tapp.init_sub()},
    )
    dense = tengine.DenseWindow(
        time=_t(d_t), src=torch.zeros((H, K), dtype=torch.int32),
        seq=torch.zeros((H, K), dtype=torch.int32),
        kind=torch.zeros((H, K), dtype=torch.int32), payload=_t(d_p),
    )
    fw = tapp.handle_msg_matrix(ts, dense, tparams, we, kernels.PLAIN_OPS)

    for f, want in want_rows.items():
        got = getattr(fw, f).numpy()
        assert got.dtype == want.dtype and np.array_equal(got, want), f
    assert np.array_equal(ts.host.rng_counter.numpy(),
                          np.asarray(js.host.rng_counter).astype(np.int64))
    want_next = seq + mi.sum(axis=1, dtype=np.int32)
    assert fw.seq_next.numpy().dtype == want_next.dtype
    assert np.array_equal(fw.seq_next.numpy(), want_next)
    for k in ("received", "forwarded"):
        assert np.array_equal(ts.subs["phold"][k].numpy(),
                              np.asarray(js.subs["phold"][k])), k
    for k in ("packets_sent", "packets_dropped_loss", "bytes_sent"):
        assert int(getattr(ts.counters, k)) == int(getattr(js.counters, k))
    tot = fw.stats.sum(dim=0)
    assert int(tot[2]) == mi.sum()  # events_emitted
    viol = mask & (np.asarray(rec.dst) == np.arange(H)[:, None]) & (
        r_time < we)
    assert int(tot[3]) == viol.sum()
    # the inputs exercised sends, stops, losses and unsent cells
    assert int(js.counters.packets_sent) > 0
    assert (valid & (d_t >= japp.stop_sending)).any()
    if topo != "lossless":
        assert int(js.counters.packets_dropped_loss) > 0


# ---------------------------------------------------------------------------
# commit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_audit_commit_matches_jax(seed):
    rs = np.random.default_rng(seed)
    H, K = 37, 9
    d_t = rs.integers(-2**40, 2**62, (H, K), dtype=np.int64)
    d_t[rs.random((H, K)) < 0.4] = NEVER
    d_t[0] = NEVER  # a host that commits nothing
    d_s = rs.integers(0, H, (H, K)).astype(np.int32)
    d_k = rs.integers(0, 7, (H, K)).astype(np.int32)
    gid = np.arange(H, dtype=np.int32)
    dg = rs.integers(-2**63, 2**63 - 1, H, dtype=np.int64)
    ev = rs.integers(0, 1000, H, dtype=np.int64)
    last = rs.integers(-1, 2**40, H, dtype=np.int64)
    done = rs.integers(-1, 2**40, H, dtype=np.int64)

    valid = d_t != NEVER
    hd = jnp.asarray(dg)
    for j in range(K):
        hd = jaudit.fold(hd, valid[:, j], d_t[:, j], d_s[:, j], gid,
                         d_k[:, j])
    n = valid.sum(axis=1)
    last_t = np.where(valid, d_t, -1).max(axis=1)
    got = kernels.audit_commit_plain(*map(_t, (d_t, d_s, d_k, gid, dg, ev,
                                               last, done)))
    assert np.array_equal(got.host_digest.numpy(), np.asarray(hd))
    assert np.array_equal(got.host_events.numpy(), ev + n)
    assert np.array_equal(got.host_last_t.numpy(),
                          np.where(n > 0, last_t, last))
    assert np.array_equal(got.done_t.numpy(), np.where(n > 0, last_t, done))
    assert np.array_equal(got.n_valid.numpy(), n)
