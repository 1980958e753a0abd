"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

The main path is the PHOLD flagship at the bench shape (16384 hosts,
msgload 8, stop 10 s, runtime 10 s, seed 42) through the port's entry
points: ``build_phold_flagship`` → ``Simulation.run`` → ``counters()`` /
``audit_chain()``. Phases, each printing its numbers beside the card's
name and power limit:

1. the card: name, power limit, count, torch and CUDA versions;
2. build the three CUDA kernels from ``shadow_tpu_torch/csrc`` with nvcc
   (one process per source, all at once) and print ptxas's register and
   shared-memory report;
3. each kernel at the bench shape's widths, on inputs taken from a real
   window of the run: equal bit for bit to its plain PyTorch version on
   the card; kernel time and plain time (CUDA events, warmed, mean over
   many launches) beside the bound; and the window step's parts, timed;
4. the full bench-shape run through the kernels, launch counts set to 0
   just before it and read just after: the committed events, overflow,
   bulk-contract count and audit chain must equal the JAX package's
   reference values below, and each kernel must launch once a window;
5. the same run with the plain versions on the card: counters, chain and
   the whole final state equal to phase 4's.

It prints the kernels' JSON line, the card line and, last, the ok line.
Any failure raises, exits non-zero and prints no ok line; with no card,
or without the rest of the repository beside it, it fails at once.

The reference values come from the JAX package on a CPU:
``build_phold_flagship(16384, msgload=8, stop_s=10, runtime_s=10)`` then
``sim.run()`` (README.md, "The PyTorch/CUDA port", gives the command).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

from shadow_tpu_torch import interop, kernels
from shadow_tpu_torch.core import engine
from shadow_tpu_torch.core.simtime import NEVER
from shadow_tpu_torch.flagship import build_phold_flagship

BENCH = dict(num_hosts=16384, msgload=8, stop_s=10, runtime_s=10, seed=42)
REF_EVENTS_COMMITTED = 23_592_960
REF_EVENTS_EMITTED = 23_592_960
REF_PACKETS_SENT = 23_592_960
REF_POOL_OVERFLOW_DROPPED = 0
REF_AUDIT_CHAIN = 0x2A4DA5031C0CA606
REF_WINDOWS = 181

# H100 SXM published peaks: HBM bytes/s, and
# float32 outside the tensor cores, the nearest published rate for the
# kernels' 32-bit integer work
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
# integer operations of one threefry2x32 block (20 rounds of add, rotate,
# xor plus 5 key injections) and of one float32 uniform (two blocks)
THREEFRY_OPS = 20 * 5 + 5 * 3 + 2
UNIFORM_OPS = 2 * THREEFRY_OPS + 3

REPLACES = {
    "extract_slots": "shadow_tpu/core/engine.py:388",
    "phold_forward": "shadow_tpu/net/apps.py:207",
    "audit_commit": "shadow_tpu/obs/audit.py:76",
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over reps launches, CUDA events, warmed."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def max_abs_err(got, want) -> float:
    err = 0.0
    for g, w in zip(got, want):
        if g.dtype != w.dtype or g.shape != w.shape:
            fail(f"output dtype/shape {g.dtype}{tuple(g.shape)} vs "
                 f"{w.dtype}{tuple(w.shape)}")
        if not torch.equal(g, w):
            d = float((g.double() - w.double()).abs().max())
            err = max(err, d, 1.0)
    return err


def bound(bytes_moved: int, ops: int):
    t_b = bytes_moved / PEAK_BYTES_S * 1e3
    t_o = ops / PEAK_OPS_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def window_inputs(card: str):
    """Run the bench shape up to mid-run and return (sim, ws, we) of the
    next window, its state untouched."""
    sim = build_phold_flagship(**BENCH)
    sim.run(until=5_000_000_000)
    ws = int(sim.state.pool.time.min())
    we = min(ws + sim.runahead, sim.stop_time)
    print(f"[{card}] phase 3 inputs: window [{ws}, {we}) of the bench run, "
          f"H={sim.num_hosts} K={sim.K} C={sim.state.pool.capacity}",
          flush=True)
    return sim, ws, we


def phase_kernels(card: str) -> dict:
    sim, ws, we = window_inputs(card)
    st, p = sim.state, sim.params
    H, K = sim.num_hosts, sim.K
    results = {}

    # K3: extract_slots on the first sort's keys
    s_k1, _ = engine.window_keys(st.pool, ws, we, H, K)
    N = s_k1.shape[0]
    err = max_abs_err([kernels.extract_slots(s_k1, H, K)],
                      [kernels.extract_slots_plain(s_k1, H, K)])
    b = bound(nbytes(s_k1) + N * 4, N * 3 * max(1, N.bit_length()))
    results["extract_slots"] = dict(
        err=err, bound=b, shape=f"N={N}",
        ms=time_ms(lambda: kernels.extract_slots(s_k1, H, K), 200),
        plain_ms=time_ms(lambda: kernels.extract_slots_plain(s_k1, H, K), 20),
    )

    # K1 / K2 on the window's dense matrix
    dense, _ = engine.dense_extract(st.pool, ws, we, H, K, kernels.PLAIN_OPS)
    h = st.host
    fargs = (dense.time, dense.payload, st.rng_keys, h.rng_counter,
             h.seq_next, h.gid, h.vertex, p.latency_vv, p.reliability_vv,
             p.vertex_g)
    fkw = dict(num_hosts=H, stop_sending=sim.app.stop_sending,
               bootstrap_end=p.bootstrap_end, win_end=we, kind=1)
    got = kernels.phold_forward(*fargs, **fkw)
    want = kernels.phold_forward_plain(*fargs, **fkw)
    err = max_abs_err(got, want)
    n_send = int(want.stats[:, 1].sum())
    b = bound(nbytes(*fargs) + nbytes(*want),
              UNIFORM_OPS * (H * K + n_send))
    results["phold_forward"] = dict(
        err=err, bound=b, shape=f"H={H} K={K} sends={n_send}",
        ms=time_ms(lambda: kernels.phold_forward(*fargs, **fkw), 200),
        plain_ms=time_ms(lambda: kernels.phold_forward_plain(*fargs, **fkw),
                         20),
    )

    ob = st.obs
    cargs = (dense.time, dense.src, dense.kind, h.gid, ob.host_digest,
             ob.host_events, ob.host_last_t, h.done_t)
    got = kernels.audit_commit(*cargs)
    want = kernels.audit_commit_plain(*cargs)
    err = max_abs_err(got, want)
    n_valid = int(want.n_valid.sum())
    b = bound(nbytes(*cargs) + nbytes(*want), 16 * n_valid)
    results["audit_commit"] = dict(
        err=err, bound=b, shape=f"H={H} K={K} events={n_valid}",
        ms=time_ms(lambda: kernels.audit_commit(*cargs), 200),
        plain_ms=time_ms(lambda: kernels.audit_commit_plain(*cargs), 20),
    )
    for name, r in results.items():
        print(f"[{card}] phase 3 {name}: {r['shape']} max_abs_err="
              f"{r['err']} kernel_ms={r['ms']:.6f} plain_ms="
              f"{r['plain_ms']:.6f} bound_ms={r['bound'][0]:.6f} "
              f"({r['bound'][1]})", flush=True)
        if r["err"] != 0:
            fail(f"{name} disagrees with its plain version on the card")

    # the window step's parts, on the same window (no kernel count kept)
    tail_dense = engine.dense_extract(st.pool, ws, we, H, K)
    fw = kernels.phold_forward(*fargs, **fkw)
    parts = {
        "window_keys (2 sorts + gathers)": lambda: engine.window_keys(
            st.pool, ws, we, H, K),
        "dense_extract (all of extract)": lambda: engine.dense_extract(
            st.pool, ws, we, H, K),
        "phold_forward": lambda: kernels.phold_forward(*fargs, **fkw),
        "audit_commit": lambda: kernels.audit_commit(*cargs),
        "merge (1 sort + gathers)": lambda: engine.merge(
            tail_dense[1], fw, st.pool.capacity),
        f"torch.sort stable int64 N={N}": lambda: torch.sort(
            s_k1, stable=True),
    }
    parts_ms = {k: time_ms(f, 20) for k, f in parts.items()}
    print(f"[{card}] phase 3 window breakdown (ms): "
          + json.dumps({k: round(v, 6) for k, v in parts_ms.items()}),
          flush=True)
    kernels.reset_launches()
    return results


def bench_run(card: str, ops, label: str):
    t0 = time.perf_counter()
    sim = build_phold_flagship(**BENCH)
    sim.ops = ops
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    kernels.reset_launches()
    windows = sim.run()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = {k.name: k.launches for k in kernels.KERNELS}
    c = sim.counters()
    chain = sim.audit_chain()
    wall = t2 - t1
    print(f"[{card}] {label}: build_s={t1 - t0:.3f} wall_s={wall:.3f} "
          f"windows={windows} ms_per_window={wall / windows * 1e3:.4f} "
          f"events_committed={c['events_committed']} "
          f"events_per_s={c['events_committed'] / wall:.1f} "
          f"pool_overflow_dropped={c['pool_overflow_dropped']} "
          f"bulk_contract_violations={c['bulk_contract_violations']} "
          f"audit_chain={chain:#018x} launches={launches} "
          f"peak_mem_gib={torch.cuda.max_memory_allocated() / 2**30:.3f}",
          flush=True)
    return sim, windows, c, chain, launches


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs the card")
    card = card_line()
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"[{card}] phase 1 device: {name} count={count} torch="
          f"{torch.__version__} cuda={torch.version.cuda} python="
          f"{sys.version.split()[0]}", flush=True)

    t0 = time.perf_counter()
    reports = kernels.build(force=True)
    build_s = time.perf_counter() - t0
    print(f"[{card}] phase 2 build: {len(reports)} kernels with nvcc "
          f"{' '.join(kernels.NVCC_FLAGS)} in {build_s:.3f} s", flush=True)
    for k in kernels.KERNELS:
        usage = [ln.strip() for ln in reports[k.name].splitlines()
                 if "registers" in ln or "spill" in ln or "smem" in ln]
        print(f"[{card}] phase 2 ptxas {k.name}: {' | '.join(usage)}",
              flush=True)

    results = phase_kernels(card)

    sim, windows, c, chain, launches = bench_run(
        card, kernels.KERNEL_OPS, "phase 4 bench run through the kernels")
    checks = {
        "events_committed": (c["events_committed"], REF_EVENTS_COMMITTED),
        "events_emitted": (c["events_emitted"], REF_EVENTS_EMITTED),
        "packets_sent": (c["packets_sent"], REF_PACKETS_SENT),
        "pool_overflow_dropped": (c["pool_overflow_dropped"],
                                  REF_POOL_OVERFLOW_DROPPED),
        "bulk_contract_violations": (c["bulk_contract_violations"], 0),
        "audit_chain": (chain, REF_AUDIT_CHAIN),
        "windows": (windows, REF_WINDOWS),
    }
    for k in kernels.KERNELS:
        checks[f"{k.name} launches"] = (launches[k.name], windows)
    for what, (got, want) in checks.items():
        if got != want:
            fail(f"phase 4: {what} = {got}, want {want}")
    snap = interop.state_to_numpy(sim.state)
    d_t = sim.state.pool.time
    if int((d_t < 0).sum()) or int((d_t == NEVER).sum()) != (
            d_t.numel() - BENCH["num_hosts"] * BENCH["msgload"]):
        fail("phase 4: the final pool's times are not the expected "
             "population")
    del sim

    psim, pwindows, pc, pchain, plaunches = bench_run(
        card, kernels.PLAIN_OPS, "phase 5 bench run, plain versions")
    if any(plaunches.values()):
        fail(f"phase 5: a kernel launched in the plain run: {plaunches}")
    if (pwindows, pc, pchain) != (windows, c, chain):
        fail("phase 5: the plain run's windows, counters or chain differ")
    psnap = interop.state_to_numpy(psim.state)
    diff = [k for k in snap if not (snap[k].dtype == psnap[k].dtype
                                    and (snap[k] == psnap[k]).all())]
    if diff:
        fail(f"phase 5: final state differs from phase 4 in {diff}")
    print(f"[{card}] phase 5 plain run equal to phase 4: counters, chain, "
          f"{len(snap)} state arrays", flush=True)

    line = {"kernels": [
        {
            "name": k.name,
            "route": "cuda",
            "source": f"shadow_tpu_torch/csrc/{k.name}.cu",
            "replaces": REPLACES[k.name],
            "launches": launches[k.name],
            "max_abs_err": results[k.name]["err"],
            "ms": results[k.name]["ms"],
            "plain_ms": results[k.name]["plain_ms"],
            "bound_ms": results[k.name]["bound"][0],
            "bound_by": results[k.name]["bound"][1],
            "library_ms": None,
        }
        for k in kernels.KERNELS
    ]}
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))


if __name__ == "__main__":
    main()
