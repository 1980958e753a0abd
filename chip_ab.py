"""Time the PHOLD bench run of two checkouts of the port on one card.

    python3 chip_ab.py PARENT_DIR [CHANGE_DIR] [--reps N]

The run is ``chip_smoke.py``'s phase 4: ``build_phold_flagship`` at the
bench shape (16384 hosts, msgload 8, stop and runtime 10 s, seed 42),
then the conservative ``run()`` through the kernels. Each checkout runs
in a process of its own, in the order PARENT, CHANGE, CHANGE, PARENT, so
that a drift of the card or the host over the call falls on both alike.
Each process builds its checkout's kernels, runs the shape once to warm
up, then N times (default 5), and prints one JSON line a run. A checkout
whose ops have ``spec_check`` also runs the shape with it replaced by a
constant NEVER (what a conservative window's check costs), alternating
which goes first. The last lines give the median ms per window of each
checkout and variant, and the card's name and power limit.
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

tag, reps, stub_first = sys.argv[1], int(sys.argv[2]), sys.argv[3] == "1"
kernels.build(force=True)
variants = {"kernels": kernels.KERNEL_OPS}
if hasattr(kernels.KERNEL_OPS, "spec_check"):
    never = torch.full((), NEVER, dtype=torch.int64, device="cuda")
    variants["spec_check stubbed"] = kernels.KERNEL_OPS._replace(
        spec_check=lambda *a: never)
order = sorted(variants, reverse=stub_first)
for variant in order:
    for rep in range(reps + 1):
        sim = build_phold_flagship(num_hosts=16384, msgload=8, stop_s=10,
                                   runtime_s=10, seed=42)
        sim.ops = variants[variant]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        windows = sim.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        print(json.dumps({
            "tree": tag, "variant": variant, "rep": rep, "wall_s": wall,
            "windows": windows, "ms_per_window": wall / windows * 1e3,
            "events_committed": sim.counters()["events_committed"],
            "chain": f"{sim.audit_chain():#018x}"}), flush=True)
        del sim
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
             "1" if i == 2 else "0"],
            cwd=tree, env=env, capture_output=True, text=True, timeout=900)
        sys.stderr.write(out.stderr)
        if out.returncode != 0:
            sys.exit(f"chip_ab: the {tag} process failed "
                     f"(rc {out.returncode})")
        for ln in out.stdout.splitlines():
            print(f"[{card}] {ln}", flush=True)
            runs.append(json.loads(ln))
    chains = {(r["chain"], r["events_committed"], r["windows"])
              for r in runs}
    if len(chains) != 1:
        sys.exit(f"chip_ab: the runs disagree: {sorted(chains)}")
    medians = {}
    for r in runs:
        if r["rep"]:
            medians.setdefault(f"{r['tree']}: {r['variant']}", []).append(
                r["ms_per_window"])
    print(json.dumps({k: {"median_ms_per_window": statistics.median(v),
                          "runs": len(v)} for k, v in medians.items()}))
    print(card)


if __name__ == "__main__":
    main()
