"""The port stands alone: no module of ``shadow_tpu_torch``, nor
``chip_smoke.py`` or ``chip_ab.py`` (with the code it runs in its child
processes), imports jax or the JAX package, and the entry points run on
the card unless asked for the CPU."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

from shadow_tpu_torch import kernels
from shadow_tpu_torch.core import engine
from shadow_tpu_torch.core.state import EventPool
from shadow_tpu_torch.flagship import build_phold_flagship
from shadow_tpu_torch.sim import build_simulation

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "shadow_tpu"}


def _sources():
    files = sorted((ROOT / "shadow_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py", ROOT / "chip_ab.py"]


def _trees(path):
    """The file's syntax tree, and that of each module-level ``CHILD``
    string: code the script runs in a child process."""
    tree = ast.parse(path.read_text(), filename=str(path))
    yield tree
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and any(getattr(t, "id", None) == "CHILD"
                        for t in node.targets)):
            yield ast.parse(node.value.value)


@pytest.mark.parametrize(
    "path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    for node in (n for tree in _trees(path) for n in ast.walk(tree)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in FORBIDDEN, (path.name, n)


def test_importing_the_port_loads_no_jax():
    code = (
        "import pkgutil, sys, shadow_tpu_torch\n"
        "for m in pkgutil.walk_packages(shadow_tpu_torch.__path__,\n"
        "                               'shadow_tpu_torch.'):\n"
        "    __import__(m.name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'shadow_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_entry_points_need_the_card_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_phold_flagship(8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_phold_flagship(8, device="cuda")
    sim = build_phold_flagship(8, stop_s=2, device="cpu")
    assert sim.state.pool.time.device.type == "cpu"
    flood = {
        "general": {"stop_time": 2},
        "network": {"graph": {"type": "1_gbit_switch"}},
        "hosts": {"s": {"app_model": "udp_flood",
                        "app_options": {"role": "server"}},
                  "c": {"quantity": 2, "app_model": "udp_flood"}},
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_simulation(flood)
    sim = build_simulation(flood, device="cpu")
    assert sim.state.subs["nic"].tx_rem.device.type == "cpu"


def test_wrappers_take_no_other_device():
    """On the CPU a wrapper runs its plain version; a tensor on any other
    device than the CPU or the card is refused, never quietly computed."""
    pool = EventPool.empty(4, 2)
    s_k1, perm = engine.window_keys(pool, 0, 10, 2, 2)
    cols = (s_k1, perm, pool.time, pool.dst, pool.src, pool.seq, pool.kind,
            pool.payload)
    with pytest.raises(ValueError):
        kernels.extract_slots(*(c.to("meta") for c in cols), 2, 2)
    out = kernels.extract_slots(*cols, 2, 2)
    assert out.dense.time.device.type == "cpu"
    assert kernels.EXTRACT_SLOTS.launches == 0
    # the merge: one column of one block elsewhere, the cursor included
    block = kernels.MergeBlock(pool.time, pool.dst, pool.src, pool.seq,
                               pool.kind, pool.payload,
                               torch.zeros(2, dtype=torch.int32))
    for f in block._fields:
        other = block._replace(**{f: getattr(block, f).to("meta")})
        with pytest.raises(ValueError):
            kernels.pool_merge([block, other], 4)
    merged = kernels.pool_merge([block, block], 4)
    assert merged.time.device.type == "cpu"
    assert kernels.POOL_MERGE.launches == 0
    # K21 cpu_serialize: each of its three tensors elsewhere is refused
    ser = (torch.tensor([[5, 7], [9, 2**63 - 1]]), torch.tensor([3, 0]),
           torch.tensor([0, 20]))
    for i in range(3):
        moved = tuple(x.to("meta") if j == i else x for j, x in
                      enumerate(ser))
        with pytest.raises(ValueError):
            kernels.cpu_serialize(*moved, True)
    out = kernels.cpu_serialize(*ser, True)
    assert out.exec_t.tolist() == [[5, 8], [20, 2**63 - 1]]
    assert int(out.delay) == 12 and kernels.CPU_SERIALIZE.launches == 0
    # phold_forward's pick on swept draws exists on the card only
    with pytest.raises(ValueError, match="card"):
        kernels.phold_pick(torch.zeros(2), torch.zeros(2, dtype=torch.int32),
                           4)


@pytest.mark.parametrize("disc", ["pifo", "eiffel"])
def test_qdisc_wrappers_take_no_other_device(disc):
    """K22 and K23 decide by every tensor they take, the discipline's
    class tables and every field of its plane among them: one elsewhere
    is refused; on the CPU they run their plain versions and launch
    nothing."""
    import numpy as np

    from chip_smoke import qdisc_discipline, synthetic_qdisc_plane

    rs = np.random.default_rng(3)
    d = qdisc_discipline(disc, "wfq", True, "codel", 4, 2, "cpu")
    plane = synthetic_qdisc_plane(rs, disc, 10**9, 4, 2)
    fields = [torch.as_tensor(plane[n]) for n in d.spec.names]
    mask = torch.ones(4, dtype=torch.bool)
    dst = torch.zeros(4, dtype=torch.int32)
    payload = torch.zeros((4, 12), dtype=torch.int32)
    now = torch.full((4,), 10**9, dtype=torch.int64)
    calls = {
        kernels.qdisc_enqueue: (fields, mask, dst, payload, now),
        kernels.qdisc_dequeue: (fields, now, mask),
    }
    for fn, args in calls.items():
        for i in range(len(fields)):
            moved = [f.to("meta") if j == i else f
                     for j, f in enumerate(fields)]
            with pytest.raises(ValueError):
                fn(moved, *args[1:], spec=d.spec)
        for i in range(1, len(args)):
            moved = [a.to("meta") if j == i else a
                     for j, a in enumerate(args)]
            with pytest.raises(ValueError):
                fn(*moved, spec=d.spec)
        out = fn(*args, spec=d.spec)
        assert all(t.device.type == "cpu" for t in out.fields)
    for table in ("inv_w", "ns_per_byte"):
        spec = kernels.QdiscSpec(**{
            **vars(d.spec), table: getattr(d.spec, table).to("meta")})
        with pytest.raises(ValueError):
            kernels.qdisc_enqueue(fields, mask, dst, payload, now, spec=spec)
    assert kernels.QDISC_ENQUEUE.launches == 0
    assert kernels.QDISC_DEQUEUE.launches == 0
