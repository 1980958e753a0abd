"""The port's TCP stack (``shadow_tpu_torch/net/tcp.py``) against the JAX
package.

* Live JAX, cheap: the bit helpers, ``seq_lt`` / ``seq_leq`` across the
  int32 wrap, ``demux`` with ties between sockets, ``_rtt_update`` with
  negative RTT differences and ``make_segment``, on seeded numpy inputs.
* The four kernels' plain versions against JAX: micro-steps of the port's
  own seeded lossy run (5 % loss, 3 clients, ``tests/test_tcp.py``'s
  ``_bulk_cfg`` shape) that reach the duplicate-ACK, fast, partial and
  SACK retransmit, out-of-order, drop and absorb branches are handed to
  the JAX package's handlers, each jitted alone at that shape (a cold
  compile of the whole JAX window step takes minutes; a handler, seconds,
  which beats running them eagerly): every state array and every emitted
  record equal.
* Whole runs against goldens from the JAX package (``GOLDEN`` below):
  lossless with 1 client, 3 clients, 5 % loss, SYN loss, and the lossy run
  handed over at a mid-run state; the audit chain, counters and a digest
  of every state array. The same runs with JAX live are marked ``slow``.
  The goldens come from
  ``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_tcp.py``.
* The end-state checks of ``tests/test_tcp.py``'s ``test_bulk_lossless``,
  ``test_bulk_multiple_clients`` and ``test_handshake_syn_loss_retries``
  on the port (the first two at smaller totals).

Tolerance: exact equality everywhere (integer arithmetic only).
"""

import dataclasses
import functools
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_tpu.core.engine import Emitter as JEmitter
from shadow_tpu.core.engine import EventView as JEventView
from shadow_tpu.net import tcp as jtcp
from shadow_tpu.sim import build_simulation as jax_build
from shadow_tpu_torch import interop, kernels
from shadow_tpu_torch.core.engine import Emitter
from shadow_tpu_torch.net import tcp
from shadow_tpu_torch.sim import build_simulation
from test_tcp import _bulk_cfg
from test_torch_cuda import random_tcp_demux
from test_torch_phold import assert_states_equal, jax_state_to_numpy

SEC = 1_000_000_000
M32 = 0xFFFFFFFF

SCENARIOS = {
    "lossless": _bulk_cfg(total="64 KiB", stop=10),
    "clients3": _bulk_cfg(total="20 KiB", clients=3, stop=10),
    "lossy": _bulk_cfg(total="30 KiB", loss=0.05, stop=30, clients=3,
                       seed=2, bootstrap=0),
    "synloss": _bulk_cfg(total="10 KiB", loss=0.30, stop=60, seed=3,
                         bootstrap=0),
}
# the lossy run is handed over at this time
HANDOVER_AT = 1_400_000_000

# JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_tcp.py (the JAX
# package's build_simulation, then run(); the lossy run also stops at
# HANDOVER_AT on its way)
GOLDEN = {
    "lossless": {"final": {
        "chain": 0x05FB85052FD3A6E0, "events_committed": 169,
        "micro_steps": 198, "packets_sent": 97, "packets_dropped_loss": 0,
        "retransmits": 0, "timeouts": 0, "digest": "2b8ed2f6d75f6366"}},
    "clients3": {"final": {
        "chain": 0x3B0BD7958BC61892, "events_committed": 201,
        "micro_steps": 195, "packets_sent": 111, "packets_dropped_loss": 0,
        "retransmits": 0, "timeouts": 0, "digest": "5850b56c5a669339"}},
    "lossy": {"final": {
        "chain": 0x8CF80602A987429A, "events_committed": 308,
        "micro_steps": 298, "packets_sent": 163, "packets_dropped_loss": 4,
        "retransmits": 8, "timeouts": 1, "digest": "4f5e79716efa2014"},
        "mid_digest": "0055bfb07321ed98"},
    "synloss": {"final": {
        "chain": 0x0E16377E9782E484, "events_committed": 51,
        "micro_steps": 69, "packets_sent": 32, "packets_dropped_loss": 3,
        "retransmits": 8, "timeouts": 2, "digest": "70b84ea729bfb40f"}},
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The runs are many small ops; intra-op threads only add overhead."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def state_digest(arrays: dict) -> str:
    """A digest of every state array: path, dtype, shape and bytes."""
    h = hashlib.sha256()
    for path in sorted(arrays):
        a = np.ascontiguousarray(arrays[path])
        h.update(f"{path}:{a.dtype.str}:{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()[:16]


def summary(counters: dict, chain: int, arrays: dict) -> dict:
    keys = ("events_committed", "micro_steps", "packets_sent",
            "packets_dropped_loss")
    return {"chain": chain, **{k: counters[k] for k in keys},
            "retransmits": int(arrays["subs.tcp.retransmits"]),
            "timeouts": int(arrays["subs.tcp.timeouts"]),
            "digest": state_digest(arrays)}


# ---------------------------------------------------------------------------
# live JAX: the TCP functions on seeded inputs
# ---------------------------------------------------------------------------

_EDGES = np.array([0, 1, 2, 3, 0x7FFFFFFF, 0x80000000, 0x80000001,
                   0xFFFFFFFE, 0xFFFFFFFF, 0x0000FFFF, 0xFFFF0000,
                   0x55555555, 0xAAAAAAAA, 1 << 31 | 1, 0b1011],
                  dtype=np.uint32)


def _u32_inputs(seed: int) -> np.ndarray:
    rs = np.random.default_rng(seed)
    runs = (np.uint32(1) << rs.integers(0, 32, 64).astype(np.uint32)) - 1
    return np.concatenate([_EDGES, runs.astype(np.uint32),
                           rs.integers(0, 2**32, 256).astype(np.uint32)])


@pytest.mark.parametrize("seed", range(2))
def test_bit_helpers_match_jax(seed):
    x = _u32_inputs(seed)
    jx = jnp.asarray(x, jnp.uint32)
    tx = torch.as_tensor(x.astype(np.int64))
    for jf, tf in ((jtcp._popcount, tcp._popcount),
                   (jtcp._bit_length, tcp._bit_length),
                   (jtcp._trailing_ones, tcp._trailing_ones)):
        want = np.asarray(jf(jx)).astype(np.int64)
        assert np.array_equal(tf(tx).numpy().astype(np.int64), want)
    rs = np.random.default_rng(10 + seed)
    for W in (8, 32, 64):
        om = rs.random((64, W)) < rs.random((64, 1))
        want = np.asarray(jtcp._pack_sack(jnp.asarray(om)))
        got = tcp._pack_sack(torch.as_tensor(om))
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want)


def test_seq_arith_matches_jax():
    rs = np.random.default_rng(3)
    a = np.concatenate([_EDGES.view(np.int32),
                        rs.integers(-2**31, 2**31, 512).astype(np.int32)])
    # b across the wrap from a, equal to a, and anywhere
    b = np.concatenate([
        (a.astype(np.int64) + rs.integers(-5000, 5000, a.size)),
        a.astype(np.int64), rs.integers(-2**31, 2**31, a.size)])
    b = (b & M32).astype(np.uint32).view(np.int32)
    a = np.tile(a, 3)
    for jf, tf in ((jtcp.seq_lt, tcp.seq_lt), (jtcp.seq_leq, tcp.seq_leq)):
        want = np.asarray(jf(jnp.asarray(a), jnp.asarray(b)))
        got = tf(torch.as_tensor(a), torch.as_tensor(b)).numpy()
        assert np.array_equal(got, want)


def _jax_table(arrays: dict, H: int, S: int, W: int = jtcp.OOO_CHUNKS):
    t = jtcp.init(H, S, W)
    return t.replace(**{k: jnp.asarray(v) for k, v in arrays.items()})


def _port_table(arrays: dict, H: int, S: int, W: int = tcp.OOO_CHUNKS):
    t = tcp.init(H, S, W)
    return t.replace(**{k: torch.as_tensor(v) for k, v in arrays.items()})


@pytest.mark.parametrize("seed", range(3))
def test_demux_matches_jax(seed):
    r = random_tcp_demux(np.random.default_rng(800 + seed), H=256, S=8)
    fields = {k: r[k] for k in ("used", "local_port", "peer_host",
                                "peer_port", "state")}
    payload = np.zeros((256, 12), np.int32)
    payload[:, 1], payload[:, 2] = r["sport"], r["dport"]
    want = jtcp.demux(_jax_table(fields, 256, 8), jnp.asarray(r["mask"]),
                      jnp.asarray(payload), jnp.asarray(r["src"]))
    got = tcp.demux(_port_table(fields, 256, 8),
                    torch.as_tensor(r["mask"]), torch.as_tensor(payload),
                    torch.as_tensor(r["src"]))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    found = np.asarray(want[1])
    assert found.sum() > np.asarray(want[2]).sum() > 0  # both kinds match
    # ties: several sockets of one host score alike; the lowest wins
    tied = 0
    for h in np.flatnonzero(found):
        s = (fields["used"][h] & (fields["local_port"][h] == r["dport"][h]))
        tied += int(s.sum() > 1)
    assert tied > 0


@pytest.mark.parametrize("seed", range(2))
def test_rtt_update_matches_jax(seed):
    rs = np.random.default_rng(900 + seed)
    H, S = 512, 8
    now = 2 * SEC + rs.integers(0, SEC, H)
    fields = {
        "srtt": np.where(rs.random((H, S)) < 0.3, 0,
                         rs.integers(1, SEC, (H, S))),
        "rttvar": rs.integers(0, SEC, (H, S)),
        # starts after now give negative samples
        "rtt_start": now[:, None] + rs.integers(-SEC, SEC // 2, (H, S)),
        "rtt_armed": rs.random((H, S)) < 0.7,
        "rto": rs.integers(0, 10 * SEC, (H, S)),
    }
    mask = rs.random(H) < 0.8
    slot = rs.integers(0, S, H).astype(np.int32)
    jt = jtcp._rtt_update(_jax_table(fields, H, S), jnp.asarray(mask),
                          jnp.asarray(slot), jnp.asarray(now))
    pt = tcp._rtt_update(_port_table(fields, H, S), torch.as_tensor(mask),
                         torch.as_tensor(slot), torch.as_tensor(now))
    for k in ("srtt", "rttvar", "rto", "rtt_armed"):
        assert np.array_equal(getattr(pt, k).numpy(),
                              np.asarray(getattr(jt, k))), k
    d = now - fields["rtt_start"][np.arange(H), slot]
    assert (d < 0).any() and (d > 0).any()


def test_make_segment_matches_jax():
    rs = np.random.default_rng(5)
    H = 64
    cols = [rs.integers(-2**31, 2**31, H).astype(np.int32) for _ in range(10)]
    want = jtcp.make_segment(*map(jnp.asarray, cols[:9]),
                             sack=jnp.asarray(cols[9]))
    got = tcp.make_segment(*map(torch.as_tensor, cols[:9]),
                           sack=torch.as_tensor(cols[9]))
    assert np.array_equal(got.numpy(), np.asarray(want))
    want = jtcp.make_segment(*map(jnp.asarray, cols[:9]))
    got = tcp.make_segment(*map(torch.as_tensor, cols[:9]))
    assert np.array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# whole runs of the port, with the handler calls of the lossy run kept
# ---------------------------------------------------------------------------

# the branches the handed-over handler calls must reach between them
REQUIRED = ("ack.dup_ack", "ack.fast_rtx", "ack.partial_rtx", "ack.sack_rtx",
            "reorder.in_order", "reorder.absorb", "reorder.ooo_flag",
            "reorder.drop", "out.send_data", "out.send_fin", "out.rtx_walk",
            "timer.fire", "connect", "accept")
_BITS = {"ack": ("tcp_ack", kernels.ACK_DUP, kernels.ACK_TRIGGER_FR,
                 kernels.ACK_PARTIAL, kernels.ACK_SACK_RTX),
         "reorder": ("tcp_reorder", kernels.RO_IN_ORDER, kernels.RO_ABSORB,
                     kernels.RO_OOO, kernels.RO_DROP),
         "out": ("tcp_out", kernels.OUT_SEND_DATA, kernels.OUT_SEND_FIN,
                 kernels.OUT_RTX)}
_NAMES = {"ack": ("dup_ack", "fast_rtx", "partial_rtx", "sack_rtx"),
          "reorder": ("in_order", "absorb", "ooo_flag", "drop"),
          "out": ("send_data", "send_fin", "rtx_walk")}


def _recording_sim(cfg):
    """The port's simulation of cfg, keeping each handler call that takes
    a host: (kind, handler, state before, event, branches taken)."""
    sim = build_simulation(cfg, device="cpu")
    calls, taken = [], set()

    def watch(name, fn, short, bits, names):
        def call(*args, **kw):
            out = fn(*args, **kw)
            for b, n in zip(bits, names):
                if bool(((out.flags >> b) & 1).any()):
                    taken.add(f"{short}.{n}")
            return out
        return call

    sim.ops = sim.ops._replace(**{
        name: watch(name, getattr(kernels.PLAIN_OPS, name), short, bits,
                    _NAMES[short])
        for short, (name, *bits) in _BITS.items()})

    def hook(kind, fn):
        def call(state, ev, emitter, params):
            if not bool(ev.mask.any()):
                return fn(state, ev, emitter, params)
            taken.clear()
            out = fn(state, ev, emitter, params)
            t0, t1 = state.subs["tcp"], out.subs["tcp"]
            if kind == tcp.Tcp.KIND_TIMER and int(t1.timeouts) > int(
                    t0.timeouts):
                taken.add("timer.fire")
            if int(out.subs["tcp_bulk"]["accepted"].sum()) > int(
                    state.subs["tcp_bulk"]["accepted"].sum()):
                taken.add("accept")
            if kind == 2:
                taken.add("connect")
            calls.append((kind, fn, state, ev, frozenset(taken)))
            return out
        return call

    sim.handlers = {k: hook(k, f) for k, f in sim.handlers.items()}
    return sim, calls


def _pick_calls(calls, required):
    """A few calls that between them reach every required branch
    (greedy)."""
    picked, need = [], set(required)
    while need:
        best = max(calls, key=lambda c: len(c[-1] & need))
        if not best[-1] & need:
            break
        picked.append(best)
        need -= best[-1]
    return picked, need


def _port_run(name: str, handover_at: int | None = None):
    cfg = SCENARIOS[name]
    if name == "lossy":
        sim, calls = _recording_sim(cfg)
    else:
        sim, calls = build_simulation(cfg, device="cpu"), []
    mid = None
    if handover_at is not None:
        sim.run(until=handover_at)
        mid = interop.state_to_numpy(sim.state)
    sim.run()
    return sim, calls, mid


@pytest.fixture(scope="module")
def runs():
    """Each scenario run once on the port (the lossy one stopping at the
    handover time on its way)."""
    return {n: _port_run(n, HANDOVER_AT if n == "lossy" else None)
            for n in SCENARIOS}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_run_matches_jax_golden(runs, name):
    sim, _, mid = runs[name]
    arrays = interop.state_to_numpy(sim.state)
    assert summary(sim.counters(), sim.audit_chain(), arrays) == \
        GOLDEN[name]["final"]
    if mid is not None:
        assert state_digest(mid) == GOLDEN[name]["mid_digest"]


def test_handover_midrun_matches_jax_golden(runs):
    """The lossy run's state at HANDOVER_AT (equal to the JAX package's by
    its digest) moved into a new simulation runs to the JAX package's end
    state."""
    _, _, mid = runs["lossy"]
    handed = build_simulation(SCENARIOS["lossy"], device="cpu")
    handed.state = interop.state_from_numpy(mid, "cpu")
    handed.run()
    arrays = interop.state_to_numpy(handed.state)
    assert summary(handed.counters(), handed.audit_chain(), arrays) == \
        GOLDEN["lossy"]["final"]


def _roles(sim):
    ci = [i for i, h in enumerate(sim.config.hosts)
          if h.name.startswith("client")]
    si = [i for i, h in enumerate(sim.config.hosts) if h.name == "server"][0]
    return ci, si


def test_bulk_lossless_end_state(runs):
    """tests/test_tcp.py:test_bulk_lossless's checks, at 64 KiB."""
    sim = runs["lossless"][0]
    t, sub = sim.state.subs["tcp"], sim.state.subs["tcp_bulk"]
    ci, si = _roles(sim)
    c = ci[0]
    assert int(sub["connected"][c]) == 1
    assert int(sub["accepted"][si]) == 1
    assert int(sub["eof_seen"][si]) == 1
    assert int(t.bytes_acked[c, 0]) == 64 * 1024
    assert int(t.bytes_received[si].sum()) == 64 * 1024
    assert int(t.retransmits) == 0 and int(t.timeouts) == 0
    # teardown: the client in TIME_WAIT; the server's child freed, its
    # listener back to LISTEN only
    assert int(t.state[c, 0]) == tcp.TIME_WAIT
    assert int(t.state[si, 0]) == tcp.LISTEN
    assert not bool(t.used[si, 1])


def test_bulk_multiple_clients_end_state(runs):
    """tests/test_tcp.py:test_bulk_multiple_clients's checks, at 20 KiB."""
    sim = runs["clients3"][0]
    t, sub = sim.state.subs["tcp"], sim.state.subs["tcp_bulk"]
    ci, si = _roles(sim)
    assert int(sub["accepted"][si]) == 3
    for c in ci:
        assert int(t.bytes_acked[c, 0]) == 20 * 1024, f"client {c}"
    assert int(t.bytes_received[si].sum()) == 3 * 20 * 1024
    assert int(sub["eof_seen"][si]) == 3


def test_handshake_syn_loss_retries_end_state(runs):
    """tests/test_tcp.py:test_handshake_syn_loss_retries's checks."""
    sim = runs["synloss"][0]
    t = sim.state.subs["tcp"]
    ci, si = _roles(sim)
    assert int(t.bytes_acked[ci[0], 0]) == 10 * 1024
    assert int(t.bytes_received[si].sum()) == 10 * 1024
    assert int(t.timeouts) > 0 or int(t.retransmits) > 0


# ---------------------------------------------------------------------------
# the kernels' plain versions against JAX on the lossy run's micro-steps
# ---------------------------------------------------------------------------


def _to_jax_state(jstate, arrays: dict):
    """The JAX package's state with every path of ``arrays`` put in."""
    def put(obj, prefix):
        names = [f.name for f in dataclasses.fields(obj)]
        return obj.replace(**{n: jnp.asarray(arrays[f"{prefix}.{n}"])
                              for n in names if f"{prefix}.{n}" in arrays})

    subs = {}
    for sub, d in jstate.subs.items():
        if dataclasses.is_dataclass(d):
            subs[sub] = put(d, f"subs.{sub}")
        else:
            subs[sub] = {k: jnp.asarray(arrays.get(f"subs.{sub}.{k}", v))
                         for k, v in d.items()}
    return jstate.replace(
        now=jnp.asarray(arrays["now"]), rng_keys=jnp.asarray(
            arrays["rng_keys"]), subs=subs,
        **{g: put(getattr(jstate, g), g)
           for g in ("pool", "host", "counters", "obs")})


def _jax_handler(jsim, kind, state, ev):
    """The JAX package's handler of ``kind`` and the records it emits."""
    em = JEmitter()
    out = jsim.handlers[kind](state, ev, em, jsim.params)
    return out, [tuple(r) for r in em.records]


def test_handlers_match_jax_on_lossy_microsteps(runs):
    """Handler calls of the lossy run that reach every branch of the four
    kernels: the port's handler (through the plain versions) and the JAX
    package's, jitted alone, on the same state and event, give every state
    array and every emitted record equal."""
    sim, calls, _ = runs["lossy"]
    picked, missing = _pick_calls(calls, REQUIRED)
    assert not missing, missing
    jsim = jax_build(SCENARIOS["lossy"])
    paths = interop.state_paths(sim.state)
    jitted = {}
    for kind, handler, state, ev, _ in picked:
        arrays = interop.state_to_numpy(state)
        em = Emitter(kernels.PLAIN_OPS)
        with torch.inference_mode():
            out = handler(state, ev, em, sim.params)
        jev = JEventView(**{f: jnp.asarray(getattr(ev, f).numpy())
                            for f in ev._fields})
        if kind not in jitted:
            jitted[kind] = jax.jit(functools.partial(_jax_handler, jsim,
                                                     kind))
        jout, jrecords = jitted[kind](_to_jax_state(jsim.state, arrays),
                                      jev)
        assert_states_equal(interop.state_to_numpy(out),
                            jax_state_to_numpy(jout, paths))
        assert len(em.records) == len(jrecords), kind
        for r, jr in zip(em.records, jrecords):
            for f, jf in zip(r, jr):
                assert np.array_equal(f.numpy(), np.asarray(jf)), kind


# ---------------------------------------------------------------------------
# the same whole runs with the JAX package live
# ---------------------------------------------------------------------------


def jax_golden(name: str, paths) -> dict:
    """The JAX package's summary of a scenario (and, for the lossy one,
    the digest of its state at HANDOVER_AT)."""
    jsim = jax_build(SCENARIOS[name])
    out = {}
    if name == "lossy":
        jsim.run(until=HANDOVER_AT)
        out["mid_digest"] = state_digest(jax_state_to_numpy(jsim.state,
                                                            paths))
        out["mid"] = jax_state_to_numpy(jsim.state, paths)
    jsim.run()
    arrays = jax_state_to_numpy(jsim.state, paths)
    out["final"] = summary(jsim.counters(), jsim.audit_chain(), arrays)
    return out


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_run_matches_jax_live(runs, name):
    sim, _, mid = runs[name]
    paths = interop.state_paths(sim.state)
    want = jax_golden(name, paths)
    arrays = interop.state_to_numpy(sim.state)
    assert summary(sim.counters(), sim.audit_chain(), arrays) == \
        want["final"] == GOLDEN[name]["final"]
    if mid is not None:
        assert state_digest(mid) == want["mid_digest"]
        # the JAX package's own mid-run state, handed to the port
        handed = build_simulation(SCENARIOS[name], device="cpu")
        handed.state = interop.state_from_numpy(want["mid"], "cpu")
        handed.run()
        assert summary(handed.counters(), handed.audit_chain(),
                       interop.state_to_numpy(handed.state)) == want["final"]


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    for name in SCENARIOS:
        port = build_simulation(SCENARIOS[name], device="cpu")
        g = jax_golden(name, interop.state_paths(port.state))
        g.pop("mid", None)
        print(f"    {name!r}: {g!r},", flush=True)
