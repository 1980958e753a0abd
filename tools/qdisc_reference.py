"""Print the JAX package's values for ``chip_smoke.py``'s qdisc paths.

    JAX_PLATFORMS=cpu python tools/qdisc_reference.py [name ...]

Builds each configuration whose values ``chip_smoke.REF_QDISC`` pins
(``CONFIGS``: the two qdisc paths and the shaped pifo cut; all of them,
or the names given) with ``shadow_tpu.sim.build_simulation``, runs it to its
stop with ``sim.run(windows_per_dispatch=32)`` on the CPU and prints one
line ``name {windows, audit_chain, counters, qdisc_digest}`` per
configuration, the entries of ``chip_smoke.REF_QDISC``, with the seconds
the run took. The qdisc digest is ``chip_smoke.qdisc_digest`` of the
final ``subs["qdisc"]`` arrays.
"""

from __future__ import annotations

import os
import sys
import time

import jax
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
from shadow_tpu.sim import build_simulation  # noqa: E402


CONFIGS = {**chip_smoke.QDISC_PATHS,
           "config2_pifo_shaped": chip_smoke.CONFIG2_PIFO_SHAPED}


def reference(cfg: dict) -> dict:
    sim = build_simulation(cfg)
    sim.run(windows_per_dispatch=32)
    qd = jax.device_get(sim.state.subs["qdisc"])
    arrays = {f"subs.qdisc.{k}": np.asarray(v) for k, v in qd.items()}
    return {
        "windows": int(sim.obs_snapshot()["win"]["windows_run"]),
        "audit_chain": int(sim.audit_chain()),
        "counters": {k: int(v) for k, v in sim.counters().items()},
        "qdisc_digest": chip_smoke.qdisc_digest(arrays),
    }


def main(names) -> None:
    jax.config.update("jax_platforms", "cpu")
    for name in names or CONFIGS:
        t0 = time.perf_counter()
        ref = reference(CONFIGS[name])
        ref["audit_chain"] = hex(ref["audit_chain"])
        print(f"{name} {ref} seconds={time.perf_counter() - t0:.1f}",
              flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
