"""Drive the PyTorch/CUDA port's main paths on one NVIDIA card and check them.

    python3 chip_smoke.py

Two main paths run through the port's entry points (``build_simulation``
or ``build_phold_flagship`` → ``Simulation.run`` → ``counters()`` /
``audit_chain()``): the PHOLD flagship at the bench shape (16384 hosts,
msgload 8, stop 10 s, runtime 10 s, seed 42) on the matrix path, and
BASELINE config 2 (``bench.py:stage_udp_flood``: 10,240 hosts flooding
1,280 servers over the UDP stack, stop 4 s, seed 7) on the micro-step
loop path. Phases, each printing its numbers beside the card's name and
power limit:

1. the card: name, power limit, count, torch and CUDA versions;
2. build the seven CUDA kernels from ``shadow_tpu_torch/csrc`` with nvcc
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
   the whole final state equal to phase 4's;
6. every kernel of the loop path (extract_slots at Kc = 13, audit_commit
   on the micro-steps' taken events, loop_select, loop_route,
   codel_dequeue, ring_append) at config 2's widths, on inputs captured
   from a real window of the flood run (each kernel's busiest call), plus
   codel_dequeue on a synthetic full-width router state in drop mode with
   stale packets: each equal bit for bit to its plain version, timed
   beside its bound; and a few flood windows run twice from one state,
   alone and under the profiler (device time by kernel and the device's
   busy share of the same windows);
7. config 2 from t = 0 to the stop in one ``run()`` through the kernels,
   launch counts set to 0 just before it and read just after: counters
   and audit chain equal to the JAX package's reference values below, and
   every kernel of the path launched;
8. the same run with the plain versions on the card: counters, chain and
   every state array equal to phase 7's.

It prints the kernels' JSON line, the card line and, last, the ok line.
The line has one entry for each kernel on each main path (``path``
"phold" or "config2"): its ``launches`` in that path's run (phase 4 or
7), and its times and bound on that path's inputs (phase 3 or 6). Any
failure raises, exits non-zero and prints no ok line; with no card, or
without the rest of the repository beside it, it fails at once.

The reference values come from the JAX package on a CPU (README.md, "The
PyTorch/CUDA port", gives the commands):
``build_phold_flagship(16384, msgload=8, stop_s=10, runtime_s=10)`` then
``sim.run()``, and config 2 (``CONFIG2`` below) through
``shadow_tpu.sim.build_simulation`` then ``sim.run()``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

import numpy as np

from shadow_tpu_torch import interop, kernels
from shadow_tpu_torch.core import engine
from shadow_tpu_torch.core.simtime import NEVER
from shadow_tpu_torch.flagship import build_phold_flagship
from shadow_tpu_torch.sim import build_simulation

BENCH = dict(num_hosts=16384, msgload=8, stop_s=10, runtime_s=10, seed=42)
REF_EVENTS_COMMITTED = 23_592_960
REF_EVENTS_EMITTED = 23_592_960
REF_PACKETS_SENT = 23_592_960
REF_POOL_OVERFLOW_DROPPED = 0
REF_AUDIT_CHAIN = 0x2A4DA5031C0CA606
REF_WINDOWS = 181

# BASELINE config 2, as bench.py:stage_udp_flood builds it
CONFIG2 = {
    "general": {"stop_time": 4, "seed": 7},
    "network": {"graph": {"type": "gml", "inline": (
        'graph [\n'
        '  node [ id 0 bandwidth_down "1 Gbit" bandwidth_up "1 Gbit" ]\n'
        '  edge [ source 0 target 0 latency "10 ms" packet_loss 0.001 ]\n'
        ']\n')}},
    "experimental": {"event_capacity": 32768,
                     "events_per_host_per_window": 12, "outbox_slots": 8,
                     "router_queue_slots": 16, "inbox_slots": 4},
    "hosts": {
        "server": {"quantity": 1280, "app_model": "udp_flood",
                   "app_options": {"role": "server"}},
        "client": {"quantity": 8960, "app_model": "udp_flood",
                   "app_options": {"interval": "20 ms", "size": 1024,
                                   "runtime": 3}},
    },
}
REF2_AUDIT_CHAIN = 0x254F6C3715914CB4
REF2_COUNTERS = {
    "events_committed": 2_686_663,
    "events_emitted": 2_686_663,
    "packets_sent": 1_344_000,
    "packets_delivered": 1_342_663,
    "packets_dropped_loss": 1_337,
    "bytes_sent": 1_413_888_000,
    "bytes_delivered": 1_374_886_912,
    "micro_steps": 900,
    "outbox_stall_deferred": 455_827,
    "pool_overflow_dropped": 0,
    "outbox_overflow_dropped": 0,
    "inbox_overflow_deferred": 0,
    "bulk_contract_violations": 0,
}
# the kernels of each main path
PHOLD_PATH = ("extract_slots", "phold_forward", "audit_commit")
LOOP_PATH = ("extract_slots", "audit_commit", "loop_select", "loop_route",
             "codel_dequeue", "ring_append")

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
    "loop_select": "shadow_tpu/core/engine.py:804",
    "loop_route": "shadow_tpu/core/engine.py:1041",
    "codel_dequeue": "shadow_tpu/net/codel.py:176",
    "ring_append": "shadow_tpu/net/codel.py:88",
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
        if g is None and w is None:
            continue
        if g is None or w is None:
            fail("one output is missing")
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


def kernel_bound(name: str, args, kw, out):
    """(ms, "bytes" or "operations"): the least time the card could take
    for this call's function on this call's data. Bytes: every input the
    function needs read once, every output written once; a ring or box
    slot the call leaves as it was is neither, so the out-of-place copies
    the engine's functional state makes are not counted. Operations: the
    32-bit integer work at the float32 peak."""
    if name == "extract_slots":
        s_k1 = args[0]
        N = s_k1.shape[0]
        # read each sorted key, write its slot; a compare with the row
        # before, the run start, the rank and the slot
        return bound(nbytes(s_k1, out), 4 * N)
    if name == "phold_forward":
        n_send = int(out.stats[:, 1].sum())
        H, K = args[0].shape
        return bound(nbytes(*args) + nbytes(*out),
                     UNIFORM_OPS * (H * K + n_send))
    if name == "audit_commit":
        d_t, gid = args[0], args[3]
        n_valid = int(out.n_valid.sum())
        # every cell's time; the src and kind of the committed ones
        return bound(nbytes(d_t, gid, *args[4:]) + 8 * n_valid
                     + nbytes(*out), 16 * n_valid)
    if name == "loop_select":
        d_p, i_t, gate = args[4], args[6], args[12]
        H, B, PP = d_p.shape[0], i_t.shape[1], d_p.shape[-1]
        valid = int(out.valid.sum())
        bulk = int((out.take_t[:, 1:] != NEVER).sum())
        cleared = int((out.inbox_time != i_t).any(dim=1).sum())
        per_host = (20  # the head cell's time, src, seq, kind
                    + 12 + (0 if gate is None else 4)  # ptr, count, gid
                    + B * 16)  # the inbox keys
        reads = (H * per_host + valid * 8 * PP  # the taken event's payload
                 + bulk * (20 + 8 * PP) + nbytes(args[14]))
        writes = nbytes(*out[:8]) + cleared * 8
        return bound(reads + writes, 0)
    if name == "loop_route":
        m, p, boxes = args[0], args[4], args[10]
        B, PP = boxes.i_t.shape[1], p.shape[-1]
        n_rec = int(m.sum())
        active = int(m.any(dim=0).sum())
        placed = n_rec - int(out.stats[:, 2].sum())
        # each record's time, dst, kind and payload; each active host's
        # seq counter, gid, deferred key, inbox times and outbox count
        reads = (nbytes(m) + n_rec * (16 + 8 * PP)
                 + active * (4 + 4 + 16 + 8 * B + 4))
        writes = (placed * (20 + 8 * PP)  # one box cell a placed record
                  + nbytes(out.seq_next, out.stats, out.boxes.o_count))
        return bound(reads + writes, 0)
    if name == "codel_dequeue":
        H, Q, P = args[0].shape
        pops = int((out.q_head - args[3]).sum())
        popped = int((out.q_head != args[3]).sum())
        reads = (nbytes(*args[3:])  # per-host CoDel state, now, mask
                 + H * (4 * P + 4)  # the head slot handed up
                 + pops * 8  # each popped slot's enqueue time
                 + (pops - popped) * (4 * P + 4))  # the slots re-popped
        return bound(reads + nbytes(*out), 0)
    if name == "ring_append":
        q_payload, _, q_ts, q_head, q_tail, mask = args[:6]
        total = args[9]
        P = q_payload.shape[2]
        n = int(out.ok.sum())
        slot = 4 * P + 4 + (0 if q_ts is None else 8)
        reads = nbytes(mask, q_head, q_tail, total) + n * slot
        writes = n * slot + nbytes(out.tail, out.ok, out.total_size)
        return bound(reads + writes, 0)
    raise ValueError(name)


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
    want = kernels.extract_slots_plain(s_k1, H, K)
    err = max_abs_err([kernels.extract_slots(s_k1, H, K)], [want])
    results["extract_slots"] = dict(
        err=err, bound=kernel_bound("extract_slots", (s_k1, H, K), {}, want),
        shape=f"N={N}",
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
    results["phold_forward"] = dict(
        err=err, bound=kernel_bound("phold_forward", fargs, fkw, want),
        shape=f"H={H} K={K} sends={n_send}",
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
    results["audit_commit"] = dict(
        err=err, bound=kernel_bound("audit_commit", cargs, {}, want),
        shape=f"H={H} K={K} events={n_valid}",
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


# ---------------------------------------------------------------------------
# the loop path: config 2
# ---------------------------------------------------------------------------

def activity(name: str, args, out) -> int:
    """How much work a captured call did: the call phase 6 keeps is the
    busiest of the window."""
    if name == "extract_slots":
        return int((out != args[0].shape[0]).sum())  # rows extracted
    if name == "audit_commit":
        return int(out.n_valid.sum())  # events committed
    if name == "loop_select":
        return int(out.valid.sum())
    if name == "loop_route":
        return int(args[0].sum())
    if name == "codel_dequeue":
        return int(args[12].sum())
    return int(args[5].sum())


def capture_ops(best: dict) -> kernels.WindowOps:
    """The kernel wrappers, keeping for each kernel of the loop path the
    arguments of its busiest call (``best[name] = (score, args, kw)``)."""
    def wrap(name, fn):
        def call(*args, **kw):
            out = fn(*args, **kw)
            score = activity(name, args, out)
            if name not in best or score > best[name][0]:
                best[name] = (score, args, kw)
            return out
        return call
    return kernels.KERNEL_OPS._replace(**{
        n: wrap(n, getattr(kernels.KERNEL_OPS, n)) for n in LOOP_PATH})


def synthetic_router(H: int, Q: int, P: int, device, seed: int = 11):
    """A full-width router state in drop mode with stale packets (the
    drop branches the 1 Gbit flood never takes): rings 0 to Q deep,
    sojourns across the 10 ms target, drops due and not yet due."""
    rs = np.random.default_rng(seed)
    now = 2_000_000_000 + rs.integers(0, 50_000_000, H)
    head = rs.integers(0, 1000, H)
    n = rs.integers(0, Q + 1, H)
    age = np.where(rs.random((H, Q)) < 0.3, rs.integers(0, 9_000_000, (H, Q)),
                   rs.integers(10_000_000, 400_000_000, (H, Q)))
    pl = np.zeros((H, Q, P), np.int32)
    pl[..., 0] = 17
    pl[..., 3] = rs.integers(0, 1473, (H, Q))
    cols = [
        pl, rs.integers(0, H, (H, Q)).astype(np.int32),
        (now[:, None] - age).astype(np.int64), head.astype(np.int32),
        (head + n).astype(np.int32), rs.random(H) < 0.7,
        np.where(rs.random(H) < 0.3, 0, now - rs.integers(
            0, 200_000_000, H)).astype(np.int64),
        (now + rs.integers(-100_000_000, 50_000_000, H)).astype(np.int64),
        rs.integers(0, 40, H).astype(np.int32),
        rs.integers(0, 40, H).astype(np.int32),
        ((pl[..., 3] + 28).sum(axis=1)).astype(np.int64),
        now.astype(np.int64), rs.random(H) < 0.9,
    ]
    return [torch.as_tensor(c, device=device) for c in cols]


def phase_loop_kernels(card: str) -> dict:
    """Phase 6: every kernel of the loop path on a real config-2 window,
    and the flood's device time by kernel over a few windows."""
    sim = build_simulation(CONFIG2)
    sim.run(until=2_000_000_000)
    best: dict = {}
    sim.ops = capture_ops(best)
    mn, occ, _ = sim._frontier(sim.stop_time)
    we = min(mn + sim.runahead, sim.stop_time)
    sim.step_loop(mn, we, occ)
    print(f"[{card}] phase 6 inputs: the busiest call of each kernel in "
          f"the config-2 window [{mn}, {we}), H={sim.num_hosts} "
          f"K={sim.K} (Kc={sim.K + 1}) B={sim.B} O={sim.O}: "
          + json.dumps({k: v[0] for k, v in best.items()}), flush=True)
    missing = [k for k in LOOP_PATH if k not in best]
    if missing:
        fail(f"phase 6: the window did not call {missing}")
    H, Q, P = sim.num_hosts, 16, 12
    best["codel_dequeue (drop mode)"] = (
        0, synthetic_router(H, Q, P, sim.device), {"aqm": True})
    results = {}
    for label, (_, args, kw) in best.items():
        name = label.split()[0]
        kern = getattr(kernels, name)
        plain = getattr(kernels, f"{name}_plain")
        got, want = kern(*args, **kw), plain(*args, **kw)
        torch.cuda.synchronize()
        if name == "loop_route":
            err = max(max_abs_err(got.boxes, want.boxes),
                      max_abs_err(got[1:], want[1:]))
        elif name == "extract_slots":
            err = max_abs_err([got], [want])
        else:
            err = max_abs_err(got, want)
        extra = ""
        if name == "codel_dequeue":
            n = int(want.dropped.sum())
            extra = f" codel_drops={n}"
            if "drop mode" in label and n == 0:
                fail("phase 6: the synthetic drop-mode state dropped none")
        if name == "extract_slots":
            extra = f" N={args[0].shape[0]} Kc={args[2]}"
        b = kernel_bound(name, args, kw, want)
        results[label] = dict(
            err=err, bound=b,
            ms=time_ms(lambda: kern(*args, **kw), 200),
            plain_ms=time_ms(lambda: plain(*args, **kw), 20),
        )
        r = results[label]
        print(f"[{card}] phase 6 {label}: max_abs_err={err}{extra} "
              f"kernel_ms={r['ms']:.6f} plain_ms={r['plain_ms']:.6f} "
              f"bound_ms={b[0]:.6f} ({b[1]})", flush=True)
        if err != 0:
            fail(f"{label} disagrees with its plain version on the card")

    # where a flood window's time goes: the same 10 windows run twice from
    # one saved state (the state is never written into, so a copy of its
    # containers restores it), first timed alone, then under the
    # profiler; the device's busy time is the profiled run's kernels and
    # copies, set against both runs' wall
    sim.ops = kernels.KERNEL_OPS
    from torch.profiler import ProfilerActivity, profile

    saved = sim.state.detached_copy()
    first = sim._frontier(sim.stop_time)[0]
    until = first + 10 * sim.runahead
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.run(until=until)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    chain = sim.audit_chain()
    sim.state = saved
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.run(until=until)
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t0
    if sim.audit_chain() != chain:
        fail("phase 6: the rerun of the profiled windows differs")
    rows = []  # kernels only: an operator's device time is its kernels'
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
        if dev_us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((dev_us, e.key, e.count))
    rows.sort(reverse=True)
    busy_s = sum(r[0] for r in rows) / 1e6
    print(f"[{card}] phase 6 the flood windows [{first}, {until}): wall_s="
          f"{wall:.4f} alone, {wall_prof:.4f} under the profiler; device "
          f"busy (kernels and copies) {busy_s:.4f} s: busy_share="
          f"{busy_s / wall:.4f} of the wall alone, "
          f"{busy_s / wall_prof:.4f} of the profiled wall; top device "
          f"time (us, launches): " + json.dumps(
              [[k[:60], round(us, 1), n] for us, k, n in rows[:12]]),
          flush=True)
    kernels.reset_launches()
    return results


def flood_run(card: str, ops, label: str):
    t0 = time.perf_counter()
    sim = build_simulation(CONFIG2)
    sim.ops = ops
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
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
          f"windows={windows} micro_steps={c['micro_steps']} "
          f"ms_per_window={wall / windows * 1e3:.4f} "
          f"events_committed={c['events_committed']} "
          f"events_per_s={c['events_committed'] / wall:.1f} "
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
        checks[f"{k.name} launches"] = (
            launches[k.name], windows if k.name in PHOLD_PATH else 0)
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
    del psim, snap, psnap

    loop_results = phase_loop_kernels(card)

    sim, windows2, c2, chain2, launches2 = flood_run(
        card, kernels.KERNEL_OPS, "phase 7 config 2 through the kernels")
    checks = {k: (c2[k], v) for k, v in REF2_COUNTERS.items()}
    checks["audit_chain"] = (chain2, REF2_AUDIT_CHAIN)
    for k in LOOP_PATH:
        if launches2[k] == 0:
            fail(f"phase 7: kernel {k} never launched")
    if launches2["phold_forward"]:
        fail("phase 7: phold_forward launched on the loop path")
    for what, (got, want) in checks.items():
        if got != want:
            fail(f"phase 7: {what} = {got}, want {want}")
    win = sim.obs_snapshot()["win"]
    if win["loop_dispatches"] != windows2 or win["matrix_dispatches"]:
        fail(f"phase 7: not every window took the loop path: {win}")
    snap = interop.state_to_numpy(sim.state)
    del sim

    psim, pwindows, pc, pchain, plaunches = flood_run(
        card, kernels.PLAIN_OPS, "phase 8 config 2, plain versions")
    if any(plaunches.values()):
        fail(f"phase 8: a kernel launched in the plain run: {plaunches}")
    if (pwindows, pc, pchain) != (windows2, c2, chain2):
        fail("phase 8: the plain run's windows, counters or chain differ")
    psnap = interop.state_to_numpy(psim.state)
    diff = [k for k in snap if not (snap[k].dtype == psnap[k].dtype
                                    and snap[k].shape == psnap[k].shape
                                    and (snap[k] == psnap[k]).all())]
    if diff or sorted(snap) != sorted(psnap):
        fail(f"phase 8: final state differs from phase 7 in {diff}")
    print(f"[{card}] phase 8 plain run equal to phase 7: counters, chain, "
          f"{len(snap)} state arrays (pool, host, obs, subs)", flush=True)

    # one entry for each kernel on each main path: its launches in that
    # path's run, and its times and bound on that path's inputs
    paths = (("phold", PHOLD_PATH, launches, results),
             ("config2", LOOP_PATH, launches2, loop_results))
    line = {"kernels": [
        {
            "name": k.name,
            "path": path,
            "route": "cuda",
            "source": f"shadow_tpu_torch/csrc/{k.name}.cu",
            "replaces": REPLACES[k.name],
            "launches": counts[k.name],
            "max_abs_err": res[k.name]["err"],
            "ms": res[k.name]["ms"],
            "plain_ms": res[k.name]["plain_ms"],
            "bound_ms": res[k.name]["bound"][0],
            "bound_by": res[k.name]["bound"][1],
            "library_ms": None,
        }
        for k in kernels.KERNELS
        for path, on_path, counts, res in paths if k.name in on_path
    ]}
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))


if __name__ == "__main__":
    main()
