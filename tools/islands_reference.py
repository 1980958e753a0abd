"""Print the JAX package's values for ``chip_smoke.py``'s islands paths.

    JAX_PLATFORMS=cpu python tools/islands_reference.py [name ...]

Builds each configuration whose values ``chip_smoke.REF_ISLANDS`` pins,
with the JAX package's island_mode ``vmap``, and runs it on the CPU:

* ``phold_islands``: ``chip_smoke.PHOLD_ISLANDS`` (the PHOLD bench shape
  over 8 shards, X = 2,048, the barrier driver) through
  ``shadow_tpu.sim.build_simulation`` and ``sim.run()``;
* ``phold_islands_r04``: ``chip_smoke.R04`` (MULTICHIP_r04's shape:
  8,192 hosts, msgload 2, 8 shards, X = 256) through
  ``shadow_tpu.flagship.build_phold_flagship`` and
  ``sim.run_stepwise(until=3 s)`` with the defaults.

It prints one line ``name {windows, audit_chain, counters, pool_digest}``
per configuration, the entries of ``chip_smoke.REF_ISLANDS``, with the
seconds the run took. ``windows`` is the window plane's count (the
stepwise run's return value is the same number); the pool digest is
``chip_smoke.pool_digest`` of the final ``[S, C_shard]`` pool.
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
from shadow_tpu.flagship import build_phold_flagship  # noqa: E402
from shadow_tpu.sim import build_simulation  # noqa: E402


def _bench() -> object:
    sim = build_simulation(chip_smoke.PHOLD_ISLANDS)
    sim.run()
    return sim


def _r04() -> object:
    r = chip_smoke.R04
    sim = build_phold_flagship(
        r["num_hosts"], msgload=r["msgload"], stop_s=r["stop_s"],
        runtime_s=r["runtime_s"], event_capacity=r["event_capacity"],
        K=r["K"], num_shards=r["num_shards"], island_mode="vmap")
    sim.run_stepwise(until=r["until"])
    return sim


RUNS = {"phold_islands": _bench, "phold_islands_r04": _r04}


def reference(name: str) -> dict:
    sim = RUNS[name]()
    pool = jax.device_get(sim.state.pool)
    arrays = {f"pool.{k}": np.asarray(getattr(pool, k))
              for k in ("time", "dst", "src", "seq", "kind", "payload")}
    return {
        "windows": int(sim.obs_snapshot()["win"]["windows_run"]),
        "audit_chain": int(sim.audit_chain()),
        "counters": {k: int(v) for k, v in sim.counters().items()},
        "pool_digest": chip_smoke.pool_digest(arrays),
    }


def main(names) -> None:
    jax.config.update("jax_platforms", "cpu")
    for name in names or RUNS:
        t0 = time.perf_counter()
        ref = reference(name)
        ref["audit_chain"] = hex(ref["audit_chain"])
        print(f"{name} {ref} seconds={time.perf_counter() - t0:.1f}",
              flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
