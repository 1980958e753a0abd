"""Who owns the tensors the in-place kernels write.

On the card ``ring_append`` writes the NIC's and the router's ring planes
in place, and ``tcp_ack``, ``tcp_reorder`` and ``tcp_out`` the TCP
table's fields; each sub-state class lists them in its ``IN_PLACE``.
``SimState.snapshot()`` clones exactly those and shares the rest, the
build hands the engine a snapshot of the stack's initial sub-states, and
each optimistic attempt steps a snapshot of its rollback point.

Here on the CPU the wrappers run their plain versions, which work out of
place, so the rollback tests stand the kernels in with ``_in_place``: the
plain version, its result then copied into the tensors it was given, as
the kernel leaves them. The card tests (``tests/test_torch_cuda.py``)
run the same check through the kernels.
"""

import dataclasses

import pytest
import torch

import chip_smoke
from shadow_tpu_torch import kernels
from shadow_tpu_torch.core.simtime import NEVER
from shadow_tpu_torch.net import codel, nic, tcp
from shadow_tpu_torch.sim import build_simulation


def _tcp_sim():
    """Config 3's shape at 16 hosts: both rings and the TCP board."""
    return build_simulation(chip_smoke.config3(16), device="cpu")


def _in_place(plain, written):
    """``plain`` standing in for its kernel: ``written`` (a ``Kernel``'s
    ``writes``) maps argument positions to where the result returns what
    the kernel writes into them."""
    def call(*args, **kw):
        out = plain(*args, **kw)
        fields = {}
        for i, where in written.items():
            if args[i] is not None:
                args[i].copy_(kernels.written_result(out, where))
            if isinstance(where, str):
                fields[where] = args[i]
            else:  # ("fields", k): the k-th of a tuple
                name, k = where
                tup = list(fields.get(name, getattr(out, name)))
                tup[k] = args[i]
                fields[name] = tuple(tup)
        return out._replace(**fields)
    return call


IN_PLACE_KERNELS = (kernels.RING_APPEND, kernels.TCP_ACK,
                    kernels.TCP_REORDER, kernels.TCP_OUT)
IN_PLACE_OPS = kernels.PLAIN_OPS._replace(**{
    k.name: _in_place(getattr(kernels, f"{k.name}_plain"), k.writes)
    for k in IN_PLACE_KERNELS})

CLASSES = {nic.SUB: nic.NicState, codel.SUB: codel.RouterState,
           tcp.SUB: tcp.TcpState}


def test_in_place_fields_name_real_fields():
    """Each sub-state's IN_PLACE names its own fields, and the result
    fields of each kernel's ``writes`` are fields of its result."""
    for key, cls in CLASSES.items():
        names = {f.name for f in dataclasses.fields(cls)}
        assert cls.IN_PLACE and set(cls.IN_PLACE) <= names, key
    results = {"loop_route": kernels.RouteOut,
               "ring_append": kernels.AppendOut, "tcp_ack": kernels.AckOut,
               "tcp_reorder": kernels.ReorderOut, "tcp_out": kernels.OutOut}
    assert {k.name for k in kernels.KERNELS if k.writes} == set(results)
    for name, out in results.items():
        writes = getattr(kernels, name.upper()).writes
        names = {w if isinstance(w, str) else w[0] for w in writes.values()}
        assert names <= set(out._fields), name
    # tcp_ack and tcp_out write the ACK_OUT / OUT_OUT fields into the
    # ACK_IN / OUT_IN arguments of the same names, and each such field
    # is one the TCP state owns
    for k, n_per_host, fields_in, fields_out in (
            (kernels.TCP_ACK, 9, kernels.ACK_IN, kernels.ACK_OUT),
            (kernels.TCP_OUT, 3, kernels.OUT_IN, kernels.OUT_OUT)):
        assert sorted(k.writes.values()) == [
            ("fields", j) for j in range(len(fields_out))]
        for i, (_, j) in k.writes.items():
            assert fields_in[i - n_per_host] == fields_out[j], k.name
            assert fields_out[j] in tcp.TcpState.IN_PLACE, fields_out[j]


def test_snapshot_clones_exactly_the_in_place_fields():
    st = _tcp_sim().state
    snap = st.snapshot()
    owned = {f".subs.{k}.{f}" for k, cls in CLASSES.items()
             for f in cls.IN_PLACE}
    before = chip_smoke.tensors_of(st)
    after = chip_smoke.tensors_of(snap)
    assert sorted(before) == sorted(after)
    assert owned <= set(before)
    for path, t in before.items():
        if path in owned:
            assert after[path] is not t, path
            assert torch.equal(after[path], t), path
        else:
            assert after[path] is t, path
    # every container is the snapshot's own
    for key in st.subs:
        assert snap.subs[key] is not st.subs[key]
    assert snap.host is not st.host and snap.pool is not st.pool


def test_snapshot_of_a_state_without_rings_shares_every_tensor():
    sim = build_simulation(chip_smoke.mixed_phold(64, 2), device="cpu")
    st = sim.state
    before = chip_smoke.tensors_of(st)
    after = chip_smoke.tensors_of(st.snapshot())
    assert all(after[p] is t for p, t in before.items())


def test_build_owns_its_rings_and_boards():
    """The live state's ring and board tensors are not the network
    stack's initial ones, nor those of ``Tcp``."""
    sim = _tcp_sim()
    stack = sim.stack
    inits = {nic.SUB: stack._init_nic, codel.SUB: stack._init_router,
             tcp.SUB: stack.tcp._init}
    for key, cls in CLASSES.items():
        live = sim.state.subs[key]
        assert live is not inits[key]
        for f in cls.IN_PLACE:
            assert getattr(live, f) is not getattr(inits[key], f), (key, f)
            assert torch.equal(getattr(live, f), getattr(inits[key], f))


def _snapshot_flood():
    sim = build_simulation(
        chip_smoke.mixed_flood(chip_smoke.SNAPSHOT_FLOOD_BW), device="cpu")
    counts = {}
    sim.ops = chip_smoke.counting_appends(IN_PLACE_OPS, counts)
    return sim, counts


def test_rolled_back_attempt_with_appends_keeps_its_base():
    """An attempt that appended to both rings in place rolls back, and
    its base keeps every tensor: object, version and value."""
    sim, counts = _snapshot_flood()
    _, _, viol, _, appends = chip_smoke.rolled_back_attempt(
        sim, counts, ("nic", "router"))
    assert viol < NEVER and appends["nic"] > 0 and appends["router"] > 0


def test_attempts_that_share_their_base_fail_the_check(monkeypatch):
    """With a snapshot that shares the rings an attempt's appends land in
    its base's rings, and the check sees it."""
    for cls in CLASSES.values():
        monkeypatch.setattr(cls, "IN_PLACE", ())
    sim, counts = _snapshot_flood()
    with pytest.raises(SystemExit):
        chip_smoke.rolled_back_attempt(sim, counts, ("nic", "router"))


def _tcp_attempts():
    sim = _tcp_sim()
    counts = {}
    sim.ops = chip_smoke.counting_tcp(IN_PLACE_OPS, counts)
    return sim, counts


def test_rolled_back_tcp_attempt_keeps_its_base():
    """An attempt that ran tcp_ack and tcp_out in place on masked hosts
    rolls back, and its base keeps every tensor: object, version and
    value."""
    sim, counts = _tcp_attempts()
    _, _, viol, _, seen = chip_smoke.rolled_back_attempt(
        sim, counts, ("tcp_ack", "tcp_out"))
    assert viol < NEVER and seen["tcp_ack"] > 0 and seen["tcp_out"] > 0


def test_tcp_attempts_that_share_their_base_fail_the_check(monkeypatch):
    """With a snapshot that shares the TCP table, an attempt's in-place
    writes land in its base's table, and the check sees it."""
    monkeypatch.setattr(tcp.TcpState, "IN_PLACE", ())
    sim, counts = _tcp_attempts()
    with pytest.raises(SystemExit):
        chip_smoke.rolled_back_attempt(sim, counts, ("tcp_ack", "tcp_out"))


def _tcp_args(name):
    """A call's arguments of ``tcp_ack`` or ``tcp_out`` on the table of a
    fresh 16-host TCP build."""
    t = _tcp_sim().state.subs[tcp.SUB]
    H = t.gid.shape[0]
    z32 = torch.zeros(H, dtype=torch.int32)
    mask = torch.ones(H, dtype=torch.bool)
    now = torch.zeros(H, dtype=torch.int64)
    if name == "tcp_ack":
        per_host = (mask, z32, z32, z32, z32, z32, z32, z32, now)
        return per_host, [getattr(t, f) for f in kernels.ACK_IN]
    return (mask, z32, now), [getattr(t, f) for f in kernels.OUT_IN]


@pytest.mark.parametrize("name", ["tcp_ack", "tcp_out"])
def test_tcp_kernels_refuse_written_fields_that_share_storage(name):
    """A field the kernel writes in place may share its storage with no
    other argument: a view of it, or another field's storage, raises."""
    fn = getattr(kernels, name)
    per_host, fields = _tcp_args(name)
    fn(*per_host, *fields, mss=tcp.MSS)  # separate tensors: accepted
    k = getattr(kernels, name.upper())
    first = min(k.writes) - len(per_host)
    for other in range(len(fields)):
        if other == first or fields[other].dtype != fields[first].dtype:
            continue
        shared = list(fields)
        shared[other] = shared[first].view_as(shared[other])
        with pytest.raises(ValueError, match="shares its storage"):
            fn(*per_host, *shared, mss=tcp.MSS)
    # a per-host argument that is a column of a written field
    n = len(per_host)
    w = next(i - n for i in k.writes if fields[i - n].dtype == torch.int32)
    per = list(per_host)
    per[1] = fields[w][:, 0]
    with pytest.raises(ValueError, match="shares its storage"):
        fn(*per, *fields, mss=tcp.MSS)
