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
    k1 = torch.zeros(8, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        kernels.extract_slots(k1, 2, 2)
    cpu = torch.arange(8, dtype=torch.int64)
    assert kernels.extract_slots(cpu, 2, 2).device.type == "cpu"
    assert kernels.EXTRACT_SLOTS.launches == 0
