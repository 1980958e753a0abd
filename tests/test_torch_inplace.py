"""Who owns the tensors the in-place kernels write.

On the card ``ring_append`` writes the NIC's and the router's ring planes
in place and ``tcp_reorder`` the TCP board fields; each sub-state class
lists them in its ``IN_PLACE``. ``SimState.snapshot()`` clones exactly
those and shares the rest, the build hands the engine a snapshot of the
stack's initial sub-states, and each optimistic attempt steps a snapshot
of its rollback point.

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
    """``plain`` standing in for its kernel: ``written`` maps argument
    positions to the result fields the kernel writes into them."""
    def call(*args, **kw):
        out = plain(*args, **kw)
        for i, field in written.items():
            if args[i] is not None:
                args[i].copy_(getattr(out, field))
        return out._replace(**{f: args[i] for i, f in written.items()})
    return call


IN_PLACE_OPS = kernels.PLAIN_OPS._replace(
    ring_append=_in_place(kernels.ring_append_plain,
                          kernels.RING_APPEND.writes),
    tcp_reorder=_in_place(kernels.tcp_reorder_plain,
                          kernels.TCP_REORDER.writes),
)

CLASSES = {nic.SUB: nic.NicState, codel.SUB: codel.RouterState,
           tcp.SUB: tcp.TcpState}


def test_in_place_fields_name_real_fields():
    """Each sub-state's IN_PLACE names its own fields, and the result
    fields of each kernel's ``writes`` are fields of its result."""
    for key, cls in CLASSES.items():
        names = {f.name for f in dataclasses.fields(cls)}
        assert cls.IN_PLACE and set(cls.IN_PLACE) <= names, key
    for k in (kernels.LOOP_ROUTE, kernels.RING_APPEND, kernels.TCP_REORDER):
        out = {"loop_route": kernels.RouteOut, "ring_append":
               kernels.AppendOut, "tcp_reorder": kernels.ReorderOut}[k.name]
        assert set(k.writes.values()) <= set(out._fields), k.name


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
