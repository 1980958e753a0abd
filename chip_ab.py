"""Time the runs of two checkouts of the port on one card.

    python3 chip_ab.py PARENT_DIR [CHANGE_DIR] [--reps N]
        [--shapes phold,config2,config3,config4] [--kernel-rounds N]

The shapes are ``chip_smoke.py``'s main runs through the kernels:
``phold`` its phase 4 (``build_phold_flagship`` at the bench shape, 16384
hosts, msgload 8, stop and runtime 10 s, seed 42, the conservative
``run()``); ``config2`` its phase 7 (``chip_smoke.CONFIG2``, 10,240 hosts,
``run()``); ``config3`` its phase 10 (``chip_smoke.CONFIG3``, 10,240
hosts, ``run()``); ``config4`` its phase 13 (``chip_smoke.CONFIG4``,
50,176 hosts, ``run_optimistic()``), each taken from the checkout's own
``chip_smoke.py``. Each checkout runs in a process of its own, in the
order PARENT, CHANGE, CHANGE, PARENT, so that a drift of the card or the
host over the call falls on both alike. Each process builds its
checkout's kernels, then for each shape runs it once to warm up and N
times (default 5), and prints one JSON line a run. On the PHOLD shape, a
checkout whose ops have ``spec_check`` also runs with it replaced by a
constant NEVER (what a conservative window's check costs), alternating
which goes first. The last lines give the median, least and most ms per
window (PHOLD) or seconds a run (the others) of each checkout, shape and
variant, and the card's name and power limit.

With ``--kernel-rounds N`` each process also times its own window sort
(``window_sort``) and extraction (``extract_slots``) on one call each:
the calls of the PHOLD bench run's first window from 5 s on, captured
through the checkout's ops (the same inputs in both checkouts, which
end on the same chain), each timed N times in turn as ``chip_smoke``'s
``graph_ms`` (200 calls replayed from a CUDA graph: device time). The
last lines then also give each checkout's median, least and most ms a
call of each.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

CHILD = r"""
import json, sys, time
import torch
from shadow_tpu_torch import kernels
from shadow_tpu_torch.core.simtime import NEVER
from shadow_tpu_torch.flagship import build_phold_flagship
from shadow_tpu_torch.sim import build_simulation

tag, reps, stub_first = sys.argv[1], int(sys.argv[2]), sys.argv[3] == "1"
shapes, kernel_rounds = sys.argv[4].split(","), int(sys.argv[5])
kernels.build(force=True)


def phold():
    return build_phold_flagship(num_hosts=16384, msgload=8, stop_s=10,
                                runtime_s=10, seed=42), "run"


def flood(name, how):
    import chip_smoke
    return lambda: (build_simulation(getattr(chip_smoke, name)), how)


builders = {"phold": phold, "config2": flood("CONFIG2", "run"),
            "config3": flood("CONFIG3", "run"),
            "config4": flood("CONFIG4", "run_optimistic")}
for shape in shapes:
    variants = {"kernels": kernels.KERNEL_OPS}
    if shape == "phold" and hasattr(kernels.KERNEL_OPS, "spec_check"):
        never = torch.full((), NEVER, dtype=torch.int64, device="cuda")
        variants["spec_check stubbed"] = kernels.KERNEL_OPS._replace(
            spec_check=lambda *a: never)
    for variant in sorted(variants, reverse=stub_first):
        for rep in range(reps + 1):
            sim, how = builders[shape]()
            sim.ops = variants[variant]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = getattr(sim, how)()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            windows = res[0] if isinstance(res, tuple) else res
            c = sim.counters()
            print(json.dumps({
                "tree": tag, "shape": shape, "variant": variant, "rep": rep,
                "wall_s": wall, "windows": windows,
                "micro_steps": c["micro_steps"],
                "ms_per_window": wall / windows * 1e3,
                "events_committed": c["events_committed"],
                "chain": f"{sim.audit_chain():#018x}"}), flush=True)
            del sim

if kernel_rounds:
    import chip_smoke
    sim, _ = phold()
    sim.run(until=5_000_000_000)
    base, calls = sim.ops, {}
    keep = lambda x: x.clone() if isinstance(x, torch.Tensor) else x


    def capture(name):
        fn = getattr(base, name)

        def call(*a, **k):
            calls.setdefault(name, (fn, [keep(x) for x in a],
                                    {n: keep(x) for n, x in k.items()}))
            return fn(*a, **k)
        return call


    sim.ops = base._replace(**{n: capture(n) for n in
                               ("window_sort", "extract_slots")})
    sim.run(until=int(sim.state.pool.time.min()) + sim.runahead)
    for rnd in range(kernel_rounds):
        for name, (fn, a, k) in sorted(calls.items()):
            ms = chip_smoke.graph_ms(lambda: fn(*a, **k), 200)
            print(json.dumps({"tree": tag, "shape": "phold", "kernel": name,
                              "rep": rnd, "ms": ms}), flush=True)
"""


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent")
    ap.add_argument("change", nargs="?", default=os.path.dirname(
        os.path.abspath(__file__)))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--shapes", default="phold")
    ap.add_argument("--kernel-rounds", type=int, default=0)
    args = ap.parse_args()
    card = card_line()
    runs = []
    for i, (tag, tree) in enumerate((("parent", args.parent),
                                     ("change", args.change),
                                     ("change", args.change),
                                     ("parent", args.parent))):
        env = dict(os.environ, PYTHONPATH=os.path.abspath(tree))
        out = subprocess.run(
            [sys.executable, "-c", CHILD, tag, str(args.reps),
             "1" if i == 2 else "0", args.shapes,
             str(args.kernel_rounds)],
            cwd=tree, env=env, capture_output=True, text=True, timeout=1800)
        sys.stderr.write(out.stderr)
        if out.returncode != 0:
            sys.exit(f"chip_ab: the {tag} process failed "
                     f"(rc {out.returncode})")
        for ln in out.stdout.splitlines():
            print(f"[{card}] {ln}", flush=True)
            runs.append(json.loads(ln))
    medians, kernel_ms = {}, {}
    for r in runs:
        if "kernel" in r:
            kernel_ms.setdefault(f"{r['kernel']} {r['tree']}",
                                 []).append(r["ms"])
    runs = [r for r in runs if "kernel" not in r]
    for shape in args.shapes.split(","):
        of = [r for r in runs if r["shape"] == shape]
        chains = {(r["chain"], r["events_committed"], r["windows"])
                  for r in of}
        if len(chains) != 1:
            sys.exit(f"chip_ab: the {shape} runs disagree: {sorted(chains)}")
        for r in of:
            if r["rep"]:
                key = f"{shape} {r['tree']}: {r['variant']}"
                medians.setdefault(key, {"ms_per_window": [], "wall_s": []})
                medians[key]["ms_per_window"].append(r["ms_per_window"])
                medians[key]["wall_s"].append(r["wall_s"])
    print(json.dumps({k: {"median_ms_per_window":
                          statistics.median(v["ms_per_window"]),
                          "median_wall_s": statistics.median(v["wall_s"]),
                          "min_wall_s": min(v["wall_s"]),
                          "max_wall_s": max(v["wall_s"]),
                          "runs": len(v["wall_s"])}
                      for k, v in medians.items()}
                     | {k: {"median_ms": statistics.median(v),
                            "min_ms": min(v), "max_ms": max(v),
                            "rounds": len(v)}
                        for k, v in kernel_ms.items()}))
    print(card)


if __name__ == "__main__":
    main()
