"""Drive the PyTorch/CUDA port's main paths on one NVIDIA card and check them.

    python3 chip_smoke.py

The main paths run through the port's entry points (``build_simulation``
or ``build_phold_flagship`` → ``Simulation.run`` or
``Simulation.run_optimistic`` → ``counters()`` / ``audit_chain()``): the
PHOLD flagship at the bench shape (16384 hosts, msgload 8, stop 10 s,
runtime 10 s, seed 42) on the matrix path; BASELINE config 2
(``bench.py:stage_udp_flood``: 10,240 hosts flooding 1,280 servers over
the UDP stack, stop 4 s, seed 7) on the micro-step loop path; BASELINE
config 3 (``bench.py:stage_tcp_bulk``: 8,960 clients each pushing 64 KiB
over TCP to 1,280 servers, stop 4 s, seed 7) on the loop path through the
TCP stack; BASELINE config 4's staged shape
(``bench.py:stage_udp_flood_50k(sync="optimistic")``: 50,176 hosts
flooding 6,272 servers, stop 3 s, seed 7) under the optimistic driver;
and two test shapes for code paths that config 4 does not take: the
PHOLD bench shape over a two-vertex graph whose speculative windows roll
back ("the mixed run"), and config 3 at 100 Mbit, whose senders queue at
their NICs. Phases, each printing its numbers beside the card's name and
power limit:

1. the card: name, power limit, count, torch and CUDA versions;
2. build the fifteen CUDA kernels from ``shadow_tpu_torch/csrc`` with nvcc
   (one process per source, all at once) and print ptxas's register and
   shared-memory report;
3. each kernel at the bench shape's widths, on inputs taken from a real
   window of the run: equal bit for bit to its plain PyTorch version on
   the card; the kernel's device time (200 calls replayed from one CUDA
   graph), its issue time (the same calls back to back from Python) and
   the plain version's time (CUDA events, warmed) beside the bound; and
   the window step's parts, timed;
4. the full bench-shape run through the kernels, launch counts set to 0
   just before it and read just after: the committed events, overflow,
   bulk-contract count and audit chain must equal the JAX package's
   reference values below, and each kernel must launch once a window;
5. the bench shape to 5 s (of 10), through the kernels and through the
   plain versions on the card: counters, chain and the whole final state
   equal;
6. every kernel of config 2's path (extract_slots at Kc = 13,
   audit_commit on the micro-steps' taken events, loop_select,
   loop_route, ring_append) at its widths, on inputs captured from a real
   window of the flood run (each kernel's busiest call), plus
   codel_dequeue on a synthetic full-width router state in drop mode with
   stale packets (the flood never queues at a router, so its run never
   calls it): each equal bit for bit to its plain version, timed beside
   its bound; and a few flood windows run twice from one state, alone and
   under the profiler (device time by kernel and the device's busy share
   of the same windows);
7. config 2 from t = 0 to the stop in one ``run()`` through the kernels,
   launch counts set to 0 just before it and read just after: counters
   and audit chain equal to the JAX package's reference values below, and
   every kernel of the path launched;
8. config 2 to 2 s (of 4), through the kernels and through the plain
   versions on the card: counters, chain and every state array equal;
9. every kernel of config 3's path (the loop path's six at Kc = 17,
   B = 8, O = 32 and no bulk batch, and the four TCP kernels tcp_demux,
   tcp_ack, tcp_reorder and tcp_out) on its busiest call over 300
   micro-steps of the transfers, with the number of calls that took each
   TCP branch, plus tcp_ack and tcp_reorder on synthetic full-width lossy
   tables that take every branch: each equal bit for bit to its plain
   version, timed beside its bound; and a few transfer windows run alone
   and under the profiler;
10. config 3 at 10,240 hosts from t = 0 to the stop in one ``run()``
    through the kernels, launch counts set to 0 just before it and read
    just after: every client's 64 KiB acked, the servers' bytes received
    summing to 8,960 × 64 KiB, every kernel of the path launched; the
    counters, TCP counters and audit chain equal to the JAX package's
    reference values below;
11. config 3 with the plain versions on the card: counters, chain and
    every state array equal to phase 10's;
12. the kernels of config 4's path (K12 ``spec_check``, K13
    ``nic_refill``, K15 ``link_send`` and the loop path's) on their
    busiest call in an optimistic window of config 4, those of the mixed
    run likewise, and every kernel of the NIC-bound transfer (with K14
    ``send_dequeue``) on its busiest call to 1.06 s, its launches counted
    from t = 0; plus full-width synthetic tables for the branches the
    runs miss (K12 with violations and filler destinations, K13 with
    NEVER lanes and long idle gaps, K14 with wrapped rings, K15 with
    loss 0.5, unreachable pairs and control packets): each equal bit for
    bit to its plain version, timed beside its bound;
13. config 4 at 50,176 hosts from t = 0 in one ``run_optimistic()``
    through the kernels, launch counts set to 0 just before it and read
    just after: windows, rollbacks, counters and chain equal to the JAX
    package's (``REF4``), every kernel of its path launched; the same
    config under the conservative ``run()``: the same chain and counters
    but for the schedule's own; then the kernels and the plain versions
    to 1.5 s under ``run_optimistic``, compared state by state;
14. the mixed run through the kernels (rollbacks > 0; equal to
    ``REF_MIXED``) and through the plain versions, state by state; the
    16-host mixed flood, whose rollbacks take the loop path, likewise
    and against the JAX package's chain; and a rolled-back attempt that
    leaves every tensor of its base state as it was (same object,
    version and values).

It prints the kernels' JSON line, the card line and, last, the ok line.
The line has one entry for each kernel on each main path (``path``
"phold", "config2", "config3", "config4", "mixed" or
"config3_100mbit"): its ``launches`` in that path's run (phase 4, 7, 10,
13, 14 or 12), and its times and bound on that path's inputs (phase 3,
6, 9 or 12); ``ms`` is the device time, ``issue_ms`` the issue time.
Any failure raises, exits non-zero and prints no ok line;
with no card, or without the rest of the repository beside it, it fails
at once.

The reference values come from the JAX package on a CPU (README.md, "The
PyTorch/CUDA port", gives the commands):
``build_phold_flagship(16384, msgload=8, stop_s=10, runtime_s=10)`` then
``sim.run()``, configs 2 and 3 (``CONFIG2`` and ``CONFIG3`` below)
through ``shadow_tpu.sim.build_simulation`` then ``sim.run()``, and
config 4 and the mixed run (``CONFIG4``, ``MIXED``) through
``build_simulation`` then ``sim.run_optimistic()``.
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


def config3(num_hosts: int = 10240) -> dict:
    """BASELINE config 3, as bench.py:stage_tcp_bulk builds it: one host in
    eight a server, every client pushing 64 KiB over TCP."""
    n_servers = num_hosts // 8
    return {
        "general": {"stop_time": 4, "seed": 7},
        "network": {"graph": {"type": "gml", "inline": (
            'graph [\n'
            '  node [ id 0 bandwidth_down "1 Gbit" bandwidth_up "1 Gbit" ]\n'
            '  edge [ source 0 target 0 latency "10 ms" packet_loss 0.0005 ]\n'
            ']\n')}},
        "experimental": {"event_capacity": 1 << 18,
                         "events_per_host_per_window": 16,
                         "outbox_slots": 32, "router_queue_slots": 16,
                         "inbox_slots": 8},
        "hosts": {
            "server": {"quantity": n_servers, "app_model": "tcp_bulk",
                       "app_options": {"role": "server"}},
            "client": {"quantity": num_hosts - n_servers,
                       "app_model": "tcp_bulk",
                       "app_options": {"total": "64 KiB"}},
        },
    }


CONFIG3 = config3()
TCP_TOTAL = 64 * 1024
# the TCP table's counters, and the sums the run is checked by
TCP_COUNTERS = ("retransmits", "timeouts", "rtx_fast", "rtx_sack",
                "rtx_walk", "drop_no_socket", "drop_ooo", "accept_overflow")

# The JAX package's config-3 values at full width (PERF.md section 2):
# build_simulation(config3()) then sim.run() on a CPU
REF3 = {
    "counters": {
        "events_committed": 1_568_970, "events_emitted": 1_568_970,
        "packets_sent": 1_002_456, "packets_delivered": 951_538,
        "packets_dropped_loss": 230, "bytes_sent": 702_354_596,
        "bytes_delivered": 587_944_172, "micro_steps": 1_970,
        "outbox_stall_deferred": 907_826, "pool_overflow_dropped": 0,
        "outbox_overflow_dropped": 0, "inbox_overflow_deferred": 0,
        "bulk_contract_violations": 0,
    },
    "tcp": {
        "retransmits": 54_062, "timeouts": 2_565, "rtx_fast": 700,
        "rtx_sack": 163, "rtx_walk": 50_634, "drop_no_socket": 0,
        "drop_ooo": 790, "accept_overflow": 0,
        "sum_bytes_acked": 587_202_560, "sum_bytes_received": 587_202_560,
    },
    "audit_chain": 0xEDFDB671D3631E58,
}


def config4(num_hosts: int = 50176, graph: str | None = None,
            event_capacity: int = 1 << 17) -> dict:
    """BASELINE config 4 as ``bench.py:stage_udp_flood_50k`` builds it
    through ``_run_stage`` (one host in eight a server, stop 3 s, a pool of
    2^17 rows), over its one-vertex graph or ``graph``'s GML; the bench
    runs it under ``run_optimistic``."""
    n_servers = num_hosts // 8
    gml = graph or (
        'graph [\n'
        '  node [ id 0 bandwidth_down "1 Gbit" bandwidth_up "1 Gbit" ]\n'
        '  edge [ source 0 target 0 latency "10 ms" packet_loss 0.001 ]\n'
        ']\n')
    return {
        "general": {"stop_time": 3, "seed": 7},
        "network": {"graph": {"type": "gml", "inline": gml}},
        "experimental": {"event_capacity": event_capacity,
                         "events_per_host_per_window": 12, "outbox_slots": 8,
                         "router_queue_slots": 16, "inbox_slots": 4},
        "hosts": {
            "server": {"quantity": n_servers, "app_model": "udp_flood",
                       "app_options": {"role": "server"}},
            "client": {"quantity": num_hosts - n_servers,
                       "app_model": "udp_flood",
                       "app_options": {"interval": "40 ms", "size": 1024,
                                       "runtime": 2}},
        },
    }


# The staged pool of 2^17 rows holds config 4's conservative windows, not
# its speculative ones: in an 80 ms window every client takes two timers,
# so the window's inflow is about three rows a client (131,712 at 50,176
# hosts) on top of the 43,904 pending timers. The pool-headroom gate then
# stalls every host: the JAX package's attempt loop spins there, the port
# raises PoolExhausted (tests/test_torch_optimistic.py). Config 4 runs with
# the pool doubled; nothing else changes.
CONFIG4 = config4(event_capacity=1 << 18)
# The JAX package's values for it at full width (PERF.md section 2):
# build_simulation(CONFIG4) then one sim.run_optimistic() on a CPU
REF4 = {
    "windows": 25, "rollbacks": 0,
    "counters": {
        "events_committed": 4_388_209,
        "events_emitted": 4_388_209,
        "packets_sent": 2_195_200,
        "packets_delivered": 2_193_009,
        "packets_dropped_loss": 2_191,
        "bytes_sent": 2_309_350_400,
        "bytes_delivered": 2_245_641_216,
        "micro_steps": 225,
        "outbox_stall_deferred": 282_135,
        "pool_overflow_dropped": 0,
        "outbox_overflow_dropped": 0,
        "inbox_overflow_deferred": 0,
        "bulk_contract_violations": 0,
    },
    "audit_chain": 0x19A95CA33CC9CDD8,
}

# tests/test_optimistic.py's two-vertex graph: 10 ms within a vertex,
# 50 ms across, so speculative windows take rollbacks
MIXED_GML = (
    'graph [\n'
    '  node [ id 0 bandwidth_down "100 Mbit" bandwidth_up "100 Mbit" ]\n'
    '  node [ id 1 bandwidth_down "100 Mbit" bandwidth_up "100 Mbit" ]\n'
    '  edge [ source 0 target 0 latency "10 ms" packet_loss 0.0 ]\n'
    '  edge [ source 0 target 1 latency "50 ms" packet_loss 0.0 ]\n'
    '  edge [ source 1 target 1 latency "10 ms" packet_loss 0.0 ]\n'
    ']\n')


def mixed_phold(num_hosts: int = 16384, msgload: int = 8) -> dict:
    """The PHOLD bench shape (the flagship's pool and K, seed 42) over
    MIXED_GML, a quarter of the hosts on vertex 1, stop and runtime 2 s:
    a test shape for the rollback path, not a user configuration."""
    far = num_hosts // 4
    opts = {"msgload": msgload, "runtime": 2}
    return {
        "general": {"stop_time": 2, "seed": 42},
        "network": {"graph": {"type": "gml", "inline": MIXED_GML}},
        "experimental": {
            "event_capacity": max(3 * num_hosts * msgload // 2, 4096),
            "events_per_host_per_window": msgload + 16,
            "outbox_slots": msgload + 16, "inbox_slots": 4},
        "hosts": {
            "near": {"quantity": num_hosts - far, "network_node_id": 0,
                     "app_model": "phold", "app_options": opts},
            "far": {"quantity": far, "network_node_id": 1,
                    "app_model": "phold", "app_options": opts},
        },
    }


MIXED = mixed_phold()
# the JAX package's values: build_simulation(mixed_phold()) then one
# sim.run_optimistic() (factor 8, adaptive) on a CPU
REF_MIXED = {
    "windows": 98, "rollbacks": 21,
    "counters": {
        "events_committed": 5_337_256,
        "events_emitted": 5_337_256,
        "packets_sent": 5_337_256,
        "packets_delivered": 0,
        "packets_dropped_loss": 0,
        "bytes_sent": 341_584_384,
        "micro_steps": 100,
        "outbox_stall_deferred": 0,
        "pool_overflow_dropped": 0,
        "outbox_overflow_dropped": 0,
        "inbox_overflow_deferred": 0,
        "bulk_contract_violations": 0,
    },
    "audit_chain": 0xC5F77C948FA84DD8,
}


def mixed_flood() -> dict:
    """Config 4's shape at 16 hosts over MIXED_GML, 2 s: the servers and
    six clients on vertex 1, eight clients on vertex 0. A server takes a
    far packet ahead of a near one sent later, so speculation rolls back
    on the loop path (``tests/test_torch_optimistic.py`` pins the JAX
    package's values)."""
    cfg = config4(16, MIXED_GML)
    cfg["general"]["stop_time"] = 2
    cfg["experimental"]["event_capacity"] = 4096
    hosts = cfg["hosts"]
    client = hosts.pop("client")
    hosts["server"]["network_node_id"] = 1
    client["app_options"]["runtime"] = 1
    hosts["near"] = {**client, "quantity": 6, "network_node_id": 1}
    hosts["far"] = {**client, "quantity": 8, "network_node_id": 0}
    return cfg


MIXED_FLOOD_CHAIN = 0x297D13156060D542


def nic_bound() -> dict:
    """Config 3's shape at 100 Mbit: a TCP sender's first flights outrun
    its NIC's tokens, so packets queue in the send ring and the pump
    dequeues them (at 1 Gbit, configs 2 to 4 never queue there)."""
    cfg = config3()
    g = cfg["network"]["graph"]
    g["inline"] = g["inline"].replace('"1 Gbit"', '"100 Mbit"')
    return cfg


# phase 12 runs the NIC-bound transfer this far (the clients open at 1 s)
NIC_BOUND_UNTIL = 1_060_000_000
# phase 12 captures config 4's and the mixed run's kernels over the
# optimistic window that starts at the first event at or past this time
PHASE12_FROM = 1_200_000_000
# phase 13 holds the plain versions to the kernels over config 4's run to
# this time (of 3 s)
PHASE13_STOP = 1_500_000_000

# phase 9 captures windows where the transfers run (the clients open at
# 1 s; the first losses show within a few 20 ms round trips)
PHASE9_FROM = 1_040_000_000
PHASE9_STEPS = 300
# phase 9 profiles this much simulated time (a config-3 micro-step
# launches thousands of kernels)
PHASE9_PROFILE_NS = 2_000_000
# phases 5 and 8 hold the plain versions to the kernels over the first
# part of the PHOLD and config-2 runs (config 3's two full runs take most
# of the script's time)
PHASE5_STOP_S = 5
PHASE8_STOP_S = 2

# the kernels of each main path
PHOLD_PATH = ("extract_slots", "phold_forward", "audit_commit", "spec_check")
LOOP_PATH = ("extract_slots", "audit_commit", "loop_select", "loop_route",
             "codel_dequeue", "ring_append", "spec_check", "nic_refill",
             "link_send")
# config 2 never queues at a router (1 Gbit, 7 clients a server), so no
# host takes a receive-pump event and codel_dequeue's handler never runs
CONFIG2_PATH = tuple(k for k in LOOP_PATH if k != "codel_dequeue")
TCP_PATH = ("tcp_demux", "tcp_ack", "tcp_reorder", "tcp_out")
CONFIG3_PATH = LOOP_PATH + TCP_PATH
# config 4 is config 2's flood at 50,176 hosts under the optimistic driver
CONFIG4_PATH = CONFIG2_PATH
MIXED_PATH = PHOLD_PATH
# no NIC send ring queues at 1 Gbit (configs 2 to 4), so only the
# NIC-bound transfer takes the send pump's dequeue
NIC_PATH = CONFIG3_PATH + ("send_dequeue",)

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
    "tcp_demux": "shadow_tpu/net/tcp.py:242",
    "tcp_ack": "shadow_tpu/net/tcp.py:779",
    "tcp_reorder": "shadow_tpu/net/tcp.py:1001",
    "tcp_out": "shadow_tpu/net/tcp.py:1132",
    "spec_check": "shadow_tpu/core/engine.py:1137",
    "nic_refill": "shadow_tpu/net/nic.py:127",
    "send_dequeue": "shadow_tpu/net/qdisc/__init__.py:93",
    "link_send": "shadow_tpu/net/link.py:23",
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


def graph_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() on the card alone: reps calls captured
    in one CUDA graph and replayed, timed with CUDA events, L2 warm. The
    replay does no host work (no Python, no checks, no allocation), so
    this is a call's device time: its kernels and the gaps between the
    graph's nodes."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    g.replay()
    b.record()
    b.synchronize()
    del g
    return a.elapsed_time(b) / reps


def kernel_times(kern, plain) -> dict:
    """``ms``: a kernel call's device time (``graph_ms``, 200 calls);
    ``issue_ms``: the same calls back to back from Python (CUDA events,
    200), which at small sizes measures the wrapper's host cost;
    ``plain_ms``: the plain version's calls back to back (20)."""
    return dict(ms=graph_ms(kern, 200), issue_ms=time_ms(kern, 200),
                plain_ms=time_ms(plain, 20))


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def per_host_bytes(t: torch.Tensor, H: int) -> int:
    """Bytes of a per-host input that may be one value for every host."""
    if t.dim() == 0 or t.stride(0) == 0:
        return t.element_size()
    return t.element_size() * H


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


def merge_bound(sim) -> float:
    """Milliseconds: the least time of one window's merge (B2, a stable
    sort by time and gathers) on this simulation's shapes: every candidate
    row read once (the tail's C rows, and the H·K emission rows of the
    matrix path or the H·(Kc + O + B) dense cells and box slots of the
    loop path) and the next pool's C rows written once; a row is its
    time, four int32 columns and its packed payload."""
    H, C = sim.num_hosts, sim.state.pool.capacity
    row = 8 + 4 * 4 + 8 * sim.state.pool.payload.shape[1]
    if sim.matrix_handler is not None:
        cand = H * sim.K
    else:
        cand = H * (sim.K + 1 + sim.O + sim.B)
    return bound((C + cand + C) * row, 0)[0]


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
    if name == "tcp_demux":
        # every socket's row decides the slot of every host
        return bound(nbytes(*args) + nbytes(*out), 0)
    if name in ("tcp_ack", "tcp_out"):
        n_in = 9 if name == "tcp_ack" else 3
        mask, fields = args[0], args[n_in:]
        names_out = kernels.ACK_OUT if name == "tcp_ack" else kernels.OUT_OUT
        H = mask.shape[0]
        n = int(mask.sum())
        # per host: its inputs and the slot's value of each field read;
        # the slot of each field written for the masked hosts
        reads = nbytes(*args[:n_in]) + H * sum(f.element_size()
                                               for f in fields)
        cell = sum(kernels.TCP_DTYPES[f].itemsize for f in names_out)
        per_host = out[1:]
        return bound(reads + n * cell + nbytes(*per_host), 0)
    if name == "tcp_reorder":
        mask, ooo_map = args[0], args[6]
        H, S, W = ooo_map.shape
        flags = out.flags
        n_in_order = int(((flags >> kernels.RO_IN_ORDER) & 1).sum())
        n_board = n_in_order + int(((flags >> kernels.RO_OOO) & 1).sum())
        # per host: its inputs and the slot's state, rcv_nxt,
        # bytes_received and board row; the slot's rcv_nxt and
        # bytes_received where in order, its row where the board changed
        reads = nbytes(*args[:4]) + H * (4 + 4 + 8 + W)
        writes = (n_in_order * 12 + n_board * W
                  + nbytes(out.flags, out.adv, out.sack))
        return bound(reads + writes, 0)
    if name == "spec_check":
        t, dst, src, done_t = args
        timed = t != NEVER
        live = timed & (dst != src)
        # each row's time; the dst and src of each row that has one; the
        # clock of each cross-host row's destination; the result
        return bound(nbytes(t) + 8 * int(timed.sum()) + 8 * int(live.sum())
                     + 8, 4 * t.shape[0])
    if name == "nic_refill":
        rem, now, mask = args[0], args[4], (*args[5:], None)[0]
        return bound(nbytes(*args[:4], mask)
                     + per_host_bytes(now, rem.shape[0]) + nbytes(*out), 0)
    if name == "send_dequeue":
        q_payload = args[0]
        H, _, P = q_payload.shape
        # each host's head, tail and want; its head slot's row and dst
        return bound(nbytes(*args[2:]) + H * (4 * P + 4) + nbytes(*out), 0)
    if name == "link_send":
        mask, now, control = args[0], args[2], args[3]
        H = mask.shape[0]
        rolled = out.deliver | out.drop
        n_draw = int((rolled & ~(now < kw["bootstrap_end"]) & ~control).sum())
        multi = args[6].shape[0] > 1
        # every host's mask and counter (now and control may be one value
        # for all); with several vertices each host's dst, vertex, its
        # destination's vertex and its path's latency and reliability,
        # with one the one path's; the key pair of each host that draws
        reads = (nbytes(mask, args[9])
                 + per_host_bytes(now, H) + per_host_bytes(control, H)
                 + (H * (4 + 4 + 4 + 8 + 4) if multi else 12)
                 + 16 * n_draw)
        return bound(reads + nbytes(*out), UNIFORM_OPS * n_draw)
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
        **kernel_times(lambda: kernels.extract_slots(s_k1, H, K),
                       lambda: kernels.extract_slots_plain(s_k1, H, K)),
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
        **kernel_times(lambda: kernels.phold_forward(*fargs, **fkw),
                       lambda: kernels.phold_forward_plain(*fargs, **fkw)),
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
        **kernel_times(lambda: kernels.audit_commit(*cargs),
                       lambda: kernels.audit_commit_plain(*cargs)),
    )

    # K12 on the window's emissions against the clocks after its commit
    fw = kernels.phold_forward_plain(*fargs, **fkw)
    sargs = (fw.time, fw.dst, fw.src, want.done_t)
    want = kernels.spec_check_plain(*sargs)
    err = max_abs_err([kernels.spec_check(*sargs)], [want])
    results["spec_check"] = dict(
        err=err, bound=kernel_bound("spec_check", sargs, {}, want),
        shape=f"N={fw.time.shape[0]} xmit_min={int(want)}",
        **kernel_times(lambda: kernels.spec_check(*sargs),
                       lambda: kernels.spec_check_plain(*sargs)),
    )
    for name, r in results.items():
        print(f"[{card}] phase 3 {name}: {r['shape']} max_abs_err="
              f"{r['err']} kernel_ms={r['ms']:.6f} issue_ms="
              f"{r['issue_ms']:.6f} plain_ms={r['plain_ms']:.6f} "
              f"bound_ms={r['bound'][0]:.6f} "
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


def bench_run(card: str, ops, label: str, shape: dict = BENCH):
    t0 = time.perf_counter()
    sim = build_phold_flagship(**shape)
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
    if name == "tcp_reorder":
        return int((out.flags != 0).sum())  # hosts whose segment had data
    if name in ("tcp_ack", "tcp_out"):
        return int(args[0].sum())  # hosts handled
    if name == "spec_check":
        return int((args[0] != NEVER).sum())  # rows checked
    if name == "nic_refill":  # the mask, where given
        mask = args[5] if len(args) > 5 else None
        return args[0].shape[0] if mask is None else int(mask.sum())
    if name == "send_dequeue":
        return int(out.sent.sum())  # packets dequeued
    if name == "link_send":
        return int(args[0].sum())  # packets sent
    return int(args[5].sum())  # ring_append, tcp_demux: the mask


# the decision bits of the TCP kernels that phase 9 counts calls by
K = kernels
BRANCHES = {
    "tcp_ack": {"dup_ack": K.ACK_DUP, "fast_rtx": K.ACK_TRIGGER_FR,
                "partial_rtx": K.ACK_PARTIAL, "sack_rtx": K.ACK_SACK_RTX,
                "new_ack": K.ACK_NEW_ACKED, "data_rtx": K.ACK_DATA_RTX,
                "fin_rtx": K.ACK_FIN_RTX, "fin_acked_free": K.ACK_FREE,
                "time_wait": K.ACK_TW_ENTER},
    "tcp_reorder": {"in_order": K.RO_IN_ORDER, "absorb": K.RO_ABSORB,
                    "ooo_flag": K.RO_OOO, "drop": K.RO_DROP},
    "tcp_out": {"send_data": K.OUT_SEND_DATA, "send_fin": K.OUT_SEND_FIN,
                "sack_skip": K.OUT_SKIP, "rtx_walk": K.OUT_RTX},
}


def branch_calls(name: str, flags: torch.Tensor) -> dict:
    """{branch: 1 if any host of this call took it}."""
    any_bit = torch.stack([((flags >> b) & 1).any()
                           for b in BRANCHES[name].values()]).tolist()
    return dict(zip(BRANCHES[name], map(int, any_bit)))


def capture_ops(best: dict, names=LOOP_PATH,
                branches: dict | None = None) -> kernels.WindowOps:
    """The kernel wrappers, keeping for each kernel of ``names`` the
    arguments of its busiest call (``best[name] = (score, args, kw)``),
    and counting in ``branches`` the calls that took each TCP branch."""
    def wrap(name, fn):
        def call(*args, **kw):
            out = fn(*args, **kw)
            score = activity(name, args, out)
            if name not in best or score > best[name][0]:
                best[name] = (score, args, kw)
            if branches is not None and name in BRANCHES:
                for b, n in branch_calls(name, out.flags).items():
                    key = f"{name}.{b}"
                    branches[key] = branches.get(key, 0) + n
            return out
        return call
    return kernels.KERNEL_OPS._replace(**{
        n: wrap(n, getattr(kernels.KERNEL_OPS, n)) for n in names})


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


MSS = 1460


def _wrap32(a) -> np.ndarray:
    """int64 values as int32 with two's-complement wraparound."""
    return (np.asarray(a, np.int64) & 0xFFFFFFFF).astype(np.uint32).view(
        np.int32)


def synthetic_tcp_ack(H: int, S: int, device, seed: int = 13):
    """Arguments of tcp_ack on a full-width lossy table (the branches a
    0.0005-loss run takes rarely or never): sequence numbers across the
    int32 wrap, duplicate, partial, full and out-of-window ACKs, SACK
    bitmaps with holes, fast recovery, FINs acked in every closing state,
    RTT samples with negative differences, and masked-off hosts with
    slots outside [0, S)."""
    rs = np.random.default_rng(seed)
    hs = (H, S)
    una = rs.integers(-2**31, 2**31, hs)
    nxt = una + rs.integers(0, 40, hs) * MSS
    smax = nxt + rs.integers(0, 4, hs) * MSS * (rs.random(hs) < 0.3)
    fin_sent = rs.random(hs) < 0.25
    buf = np.where(fin_sent, smax - 1,
                   smax + rs.integers(0, 30, hs) * MSS
                   + rs.integers(0, MSS, hs))
    now = 2_000_000_000 + rs.integers(0, 100_000_000, H)
    sack = rs.integers(0, 2**32, hs) & np.where(
        rs.random(hs) < 0.5, 0, rs.integers(0, 2**32, hs))
    fields = {
        "state": rs.choice([3, 4, 5, 6, 7, 9, 10], size=hs,
                           p=[.05, .55, .1, .05, .1, .05, .1]),
        "snd_una": una, "snd_nxt": nxt, "snd_max": smax,
        "snd_wnd": rs.integers(0, 1 << 20, hs), "snd_buf_end": buf,
        "fin_seq": np.where(fin_sent, buf, rs.integers(-2**31, 2**31, hs)),
        "fin_sent": fin_sent,
        "cwnd": rs.integers(MSS, 60 * MSS, hs),
        "ssthresh": np.where(rs.random(hs) < 0.5, 1 << 30,
                             rs.integers(2 * MSS, 40 * MSS, hs)),
        "dup_acks": rs.integers(0, 4, hs),
        "fast_recovery": rs.random(hs) < 0.3,
        "recover": una + rs.integers(0, 45, hs) * MSS,
        "sack_bits": sack, "rtx_high": una + rs.integers(-3, 12, hs) * MSS,
        "srtt": np.where(rs.random(hs) < 0.3, 0,
                         rs.integers(1, 200_000_000, hs)),
        "rttvar": rs.integers(0, 100_000_000, hs),
        "rto": rs.integers(200_000_000, 3_000_000_000, hs),
        "rtt_armed": rs.random(hs) < 0.6,
        "rtt_seq": una + rs.integers(-2, 40, hs) * MSS,
        "rtt_start": now[:, None] - rs.integers(-1_000_000, 300_000_000, hs),
        "rtx_armed": rs.random(hs) < 0.7,
        "rtx_expire": rs.integers(0, 10**10, hs),
        "bytes_acked": rs.integers(0, 10**6, hs),
    }
    mask = rs.random(H) < 0.85
    slot = np.where(~mask & (rs.random(H) < 0.3), rs.integers(-3, S + 3, H),
                    rs.integers(0, S, H))
    rows, col = np.arange(H), np.clip(slot, 0, S - 1)
    u, smx = una[rows, col], smax[rows, col]
    pick = rs.integers(0, 6, H)
    seg_ack = np.select(
        [pick == 0, pick == 1, pick == 2, pick == 3, pick == 4],
        [u, u + np.minimum(rs.integers(1, 45, H) * MSS, smx - u), smx,
         smx + rs.integers(1, 5, H) * MSS, u - rs.integers(1, 5, H) * MSS],
        rs.integers(-2**31, 2**31, H))
    flags = rs.choice([0x10, 0x11, 0x12, 0x00], size=H, p=[.85, .05, .05, .05])
    seg_len = np.where(rs.random(H) < 0.75, 0,
                       np.where(rs.random(H) < 0.8, MSS,
                                rs.integers(1, MSS, H)))
    st = np.where(rs.random(H) < 0.1, 3, fields["state"][rows, col])
    i32 = torch.int32

    def t(a, dt=i32):
        if dt == i32:
            a = _wrap32(a)
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

    per_host = (t(mask, torch.bool), t(slot), t(flags), t(seg_ack),
                t(seg_len), t(rs.integers(0, 1 << 20, H)),
                t(rs.integers(0, 2**32, H)), t(st), t(now, torch.int64))
    return per_host + tuple(t(fields[n], kernels.TCP_DTYPES[n])
                            for n in kernels.ACK_IN), {"mss": MSS}


def synthetic_tcp_reorder(H: int, S: int, W: int, device, seed: int = 17):
    """Arguments of tcp_reorder on a full-width table with boards half
    full: in-order segments that absorb runs of held chunks, short final
    segments, aligned and unaligned out-of-order segments inside and
    beyond the board, old segments, and sockets that cannot receive."""
    rs = np.random.default_rng(seed)
    hs = (H, S)
    rcv_nxt = rs.integers(-2**31, 2**31, hs)
    dens = rs.choice([0.0, 0.3, 0.8], size=hs)
    board = rs.random((H, S, W)) < dens[..., None]
    run = rs.integers(0, 6, hs)
    board[..., 1:] |= np.arange(1, W)[None, None, :] <= run[..., None]
    board[..., 0] = False
    mask = rs.random(H) < 0.85
    slot = np.where(~mask & (rs.random(H) < 0.3), rs.integers(-3, S + 3, H),
                    rs.integers(0, S, H))
    rn = rcv_nxt[np.arange(H), np.clip(slot, 0, S - 1)]
    pick = rs.integers(0, 5, H)
    seg_seq = np.select(
        [pick <= 1, pick == 2, pick == 3],
        [rn, rn + rs.integers(1, W + 8, H) * MSS,
         rn + rs.integers(1, W * MSS, H)],
        rn - rs.integers(1, 10, H) * MSS)
    seg_len = np.where(rs.random(H) < 0.75, MSS,
                       np.where(rs.random(H) < 0.6, rs.integers(1, MSS, H),
                                0))
    state = rs.choice([4, 5, 6, 9, 10], size=hs, p=[.6, .1, .1, .1, .1])
    i32 = torch.int32

    def t(a, dt=i32):
        if dt == i32:
            a = _wrap32(a)
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

    return (t(mask, torch.bool), t(slot), t(seg_seq), t(seg_len), t(state),
            t(rcv_nxt), torch.as_tensor(board, device=device),
            t(rs.integers(0, 10**7, hs), torch.int64)), {"mss": MSS}


def profile_windows(card: str, sim, label: str, span: int,
                    optimistic: bool = False) -> None:
    """Where a window's time goes: the windows of the next ``span`` ns run
    twice from one saved state (the state is never written into, so a
    copy of its containers restores it), first timed alone, then under
    the profiler; the device's busy time is the profiled run's kernels
    and copies, set against both runs' wall. The profiler's summary
    costs time in proportion to the launches traced, so the span stays
    short. ``optimistic`` runs the windows through ``run_optimistic``."""
    from torch.profiler import ProfilerActivity, profile

    run = sim.run_optimistic if optimistic else sim.run
    saved = sim.state.snapshot()
    first = sim._frontier(sim.stop_time).mn
    until = first + span
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(until=until)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    chain = sim.audit_chain()
    steps = sim.counters()["micro_steps"] - int(saved.counters.micro_steps)
    sim.state = saved
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(until=until)
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t0
    if sim.audit_chain() != chain:
        fail(f"{label}: the rerun of the profiled windows differs")
    rows = []  # kernels only: an operator's device time is its kernels'
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
        if dev_us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((dev_us, e.key, e.count))
    rows.sort(reverse=True)
    busy_s = sum(r[0] for r in rows) / 1e6
    print(f"[{card}] {label} [{first}, {until}): micro_steps={steps} "
          f"wall_s={wall:.4f} alone, {wall_prof:.4f} under the profiler; "
          f"device busy (kernels and copies) {busy_s:.4f} s: busy_share="
          f"{busy_s / wall:.4f} of the wall alone, "
          f"{busy_s / wall_prof:.4f} of the profiled wall; top device "
          f"time (us, launches): " + json.dumps(
              [[k[:60], round(us, 1), n] for us, k, n in rows[:12]]),
          flush=True)


def compare_calls(card: str, phase: str, calls: dict) -> dict:
    """Each captured call ({label: (score, args, kw)}, the kernel's name
    first in the label) through its kernel and its plain version on the
    same inputs: equal bit for bit, timed with CUDA events, with its
    bound."""
    results = {}
    for label, (_, args, kw) in calls.items():
        name = label.split()[0]
        kern = getattr(kernels, name)
        plain = getattr(kernels, f"{name}_plain")
        got, want = kern(*args, **kw), plain(*args, **kw)
        torch.cuda.synchronize()
        if name == "loop_route":
            err = max(max_abs_err(got.boxes, want.boxes),
                      max_abs_err(got[1:], want[1:]))
        elif name in ("extract_slots", "spec_check"):
            err = max_abs_err([got], [want])
        elif name in ("tcp_ack", "tcp_out"):
            err = max(max_abs_err(got.fields, want.fields),
                      max_abs_err(got[1:], want[1:]))
        else:
            err = max_abs_err(got, want)
        extra = ""
        if name == "codel_dequeue":
            n = int(want.dropped.sum())
            extra = f" codel_drops={n}"
            if "drop mode" in label and n == 0:
                fail(f"{phase}: the synthetic drop-mode state dropped none")
        if name == "extract_slots":
            extra = f" N={args[0].shape[0]} Kc={args[2]}"
        if name in BRANCHES:
            hosts = {b: int(((want.flags >> bit) & 1).sum())
                     for b, bit in BRANCHES[name].items()}
            extra = f" hosts_by_branch={json.dumps(hosts)}"
            if "synthetic" in label and not all(hosts.values()):
                fail(f"{phase}: {label} misses a branch: {hosts}")
        b = kernel_bound(name, args, kw, want)
        results[label] = dict(
            err=err, bound=b,
            **kernel_times(lambda: kern(*args, **kw),
                           lambda: plain(*args, **kw)),
        )
        r = results[label]
        print(f"[{card}] {phase} {label}: max_abs_err={err}{extra} "
              f"kernel_ms={r['ms']:.6f} issue_ms={r['issue_ms']:.6f} "
              f"plain_ms={r['plain_ms']:.6f} bound_ms={b[0]:.6f} ({b[1]})",
              flush=True)
        if err != 0:
            fail(f"{label} disagrees with its plain version on the card")
    return results


def phase_loop_kernels(card: str) -> dict:
    """Phase 6: every kernel of the loop path on a real config-2 window,
    and the flood's device time by kernel over a few windows."""
    sim = build_simulation(CONFIG2)
    sim.run(until=2_000_000_000)
    best: dict = {}
    sim.ops = capture_ops(best)
    mn, occ, _, _ = sim._frontier(sim.stop_time)
    we = min(mn + sim.runahead, sim.stop_time)
    sim.step_loop(mn, we, occ)
    print(f"[{card}] phase 6 inputs: the busiest call of each kernel in "
          f"the config-2 window [{mn}, {we}), H={sim.num_hosts} "
          f"K={sim.K} (Kc={sim.K + 1}) B={sim.B} O={sim.O}: "
          + json.dumps({k: v[0] for k, v in best.items()}), flush=True)
    missing = [k for k in CONFIG2_PATH if k not in best]
    if missing:
        fail(f"phase 6: the window did not call {missing}")
    H, Q, P = sim.num_hosts, 16, 12
    best["codel_dequeue (drop mode)"] = (
        0, synthetic_router(H, Q, P, sim.device), {"aqm": True})
    results = compare_calls(card, "phase 6", best)

    # where a flood window's time goes
    sim.ops = kernels.KERNEL_OPS
    profile_windows(card, sim, "phase 6 the flood windows",
                    10 * sim.runahead)
    kernels.reset_launches()
    return results


def flood_run(card: str, ops, label: str, cfg: dict = CONFIG2):
    t0 = time.perf_counter()
    sim = build_simulation(cfg)
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


# ---------------------------------------------------------------------------
# the TCP stack: config 3
# ---------------------------------------------------------------------------

def phase_tcp_kernels(card: str) -> dict:
    """Phase 9: every kernel of config 3's path on its busiest call over
    the first PHASE9_STEPS micro-steps from PHASE9_FROM, the calls that
    took each TCP branch, synthetic lossy tables for the branches of
    tcp_ack and tcp_reorder, and the device time by kernel over a few
    windows."""
    t0 = time.perf_counter()
    sim = build_simulation(CONFIG3)
    sim.run(until=PHASE9_FROM)
    best: dict = {}
    branches: dict = {}
    sim.ops = capture_ops(best, CONFIG3_PATH, branches)
    first = sim._frontier(sim.stop_time).mn
    steps = windows = 0
    t1 = time.perf_counter()
    while steps < PHASE9_STEPS:
        mn, occ, _, _ = sim._frontier(sim.stop_time)
        m0 = sim.counters()["micro_steps"]
        sim.step_loop(mn, min(mn + sim.runahead, sim.stop_time), occ)
        steps += sim.counters()["micro_steps"] - m0
        windows += 1
    t2 = time.perf_counter()
    print(f"[{card}] phase 9 inputs: the busiest call of each kernel in "
          f"{windows} config-3 windows from t={first} ({steps} micro-steps; "
          f"run-up {t1 - t0:.3f} s, capture {t2 - t1:.3f} s), "
          f"H={sim.num_hosts} K={sim.K} (Kc={sim.K + 1}) B={sim.B} "
          f"O={sim.O} G={sim._plan_loop()[2]}: "
          + json.dumps({k: v[0] for k, v in best.items()})
          + " calls_by_branch=" + json.dumps(branches), flush=True)
    missing = [k for k in CONFIG3_PATH if k not in best]
    if missing:
        fail(f"phase 9: the windows did not call {missing}")
    H, S = sim.num_hosts, sim.stack.sockets_per_host
    W = sim.state.subs["tcp"].ooo_map.shape[2]
    best["tcp_ack (synthetic lossy)"] = (
        0, *synthetic_tcp_ack(H, S, sim.device))
    best["tcp_reorder (synthetic lossy)"] = (
        0, *synthetic_tcp_reorder(H, S, W, sim.device))
    results = compare_calls(card, "phase 9", best)
    t3 = time.perf_counter()
    sim.ops = kernels.KERNEL_OPS
    profile_windows(card, sim, "phase 9 the transfer windows",
                    PHASE9_PROFILE_NS)
    print(f"[{card}] phase 9 wall_s: capture run {t2 - t0:.3f}, "
          f"comparisons {t3 - t2:.3f}, profile "
          f"{time.perf_counter() - t3:.3f}", flush=True)
    kernels.reset_launches()
    return results


def tcp_run(card: str, cfg: dict, ops, label: str):
    """Config 3 from t = 0 to the stop in one ``run()``, launch counts set
    to 0 just before it and read just after."""
    t0 = time.perf_counter()
    sim = build_simulation(cfg)
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
    t = sim.state.subs["tcp"]
    tc = {k: int(getattr(t, k)) for k in TCP_COUNTERS}
    tc["sum_bytes_acked"] = int(t.bytes_acked.sum())
    tc["sum_bytes_received"] = int(t.bytes_received.sum())
    wall = t2 - t1
    steps = c["micro_steps"]
    print(f"[{card}] {label}: hosts={sim.num_hosts} build_s={t1 - t0:.3f} "
          f"wall_s={wall:.3f} windows={windows} micro_steps={steps} "
          f"ms_per_micro_step={wall / max(steps, 1) * 1e3:.4f} "
          f"events_committed={c['events_committed']} "
          f"events_per_s={c['events_committed'] / wall:.1f} "
          f"counters={json.dumps(c)} tcp={json.dumps(tc)} "
          f"audit_chain={chain:#018x} launches={launches} "
          f"peak_mem_gib={torch.cuda.max_memory_allocated() / 2**30:.3f}",
          flush=True)
    return sim, windows, c, tc, chain, launches


def check_transfers(sim, phase: str) -> None:
    """Every client's stream acked in full; the servers received all."""
    t = sim.state.subs["tcp"]
    role = sim.state.subs["tcp_bulk"]["role"]
    clients = role == 1
    acked = t.bytes_acked[clients, 0]
    if not bool((acked == TCP_TOTAL).all()):
        fail(f"{phase}: {int((acked != TCP_TOTAL).sum())} clients did not "
             f"get their {TCP_TOTAL} bytes acked")
    got = int(t.bytes_received[~clients].sum())
    want = int(clients.sum()) * TCP_TOTAL
    if got != want:
        fail(f"{phase}: the servers received {got} bytes, want {want}")


def check_reference(phase: str, c, tc, chain, ref) -> None:
    """Counters, TCP counters and chain against the JAX package's."""
    checks = {k: (c[k], v) for k, v in ref["counters"].items()}
    checks.update({k: (tc[k], v) for k, v in ref["tcp"].items()})
    checks["audit_chain"] = (chain, ref["audit_chain"])
    for what, (got, want) in checks.items():
        if got != want:
            fail(f"{phase}: {what} = {got}, want {want}")


# ---------------------------------------------------------------------------
# the optimistic driver: config 4, the mixed run
# ---------------------------------------------------------------------------

def capture_window(sim, names, until: int) -> dict:
    """Run ``sim`` optimistically to ``until``, then one optimistic window
    with the kernel wrappers capturing each kernel's busiest call."""
    sim.run_optimistic(until=until)
    best: dict = {}
    sim.ops = capture_ops(best, names)
    first = sim._frontier(sim.stop_time).mn
    sim.run_optimistic(until=first + 8 * sim.runahead)
    sim.ops = kernels.KERNEL_OPS
    return best


def synthetic_spec_check(H: int, N: int, device, seed: int = 19):
    """Emission rows with violations and filler destinations outside
    [0, H), against clocks half of them -1."""
    rs = np.random.default_rng(seed)
    done_t = np.where(rs.random(H) < 0.5, -1,
                      rs.integers(0, 2 * 10**9, H)).astype(np.int64)
    t = rs.integers(10**9, 3 * 10**9, N).astype(np.int64)
    t[rs.random(N) < 0.3] = NEVER
    dst = rs.integers(0, H, N).astype(np.int32)
    dst[rs.random(N) < 0.05] = H  # filler rows
    src = np.where(rs.random(N) < 0.1, dst, rs.integers(0, H, N))
    return tuple(torch.as_tensor(a, device=device) for a in (
        t, dst, src.astype(np.int32), done_t)), {}


def synthetic_nic_refill(H: int, device, seed: int = 23):
    """Buckets in debt and full, long idle gaps whose refill product
    wraps, NEVER lanes, and a mask."""
    rs = np.random.default_rng(seed)
    refill = rs.integers(1, 200_000, H)
    tick = rs.integers(0, 3_000, H)
    now = tick * 1_000_000 + rs.integers(0, 10**15, H)
    now[rs.random(H) < 0.3] = NEVER
    cols = (rs.integers(-100_000, 200_000, H), tick, refill, refill + 1500,
            now)
    return tuple(torch.as_tensor(np.asarray(a, np.int64), device=device)
                 for a in cols) + (
        torch.as_tensor(rs.random(H) < 0.7, device=device),), {}


def synthetic_send_dequeue(H: int, NQ: int, P: int, device, seed: int = 29):
    """Rings empty, part full and full, heads past many wraps."""
    rs = np.random.default_rng(seed)
    head = rs.integers(0, 2**30, H).astype(np.int32)
    tail = (head + rs.integers(0, NQ + 1, H)).astype(np.int32)
    cols = (rs.integers(-2**31, 2**31, (H, NQ, P)).astype(np.int32),
            rs.integers(0, H, (H, NQ)).astype(np.int32), head, tail,
            rs.random(H) < 0.8)
    return tuple(torch.as_tensor(a, device=device) for a in cols), {}


def synthetic_link_send(H: int, device, seed: int = 31):
    """Three vertices, one pair unreachable, loss up to 0.5, control
    packets, hosts on both sides of the end of bootstrap, and destinations
    outside [0, H) on the hosts that send nothing."""
    rs = np.random.default_rng(seed)
    ms = 1_000_000
    lat = np.array([[10, 40, NEVER], [40, 20, 60], [NEVER, 60, 30]])
    lat = np.where(lat == NEVER, NEVER, lat * ms).astype(np.int64)
    rel = np.array([[0.5, 0.9, 1.0], [0.9, 0.5, 0.75], [1.0, 0.75, 0.5]],
                   np.float32)
    boot = 1_000 * ms
    vertex = (np.arange(H) % 3).astype(np.int32)
    counter = rs.integers(0, 2**32, H, dtype=np.int64)
    keys = np.stack([rs.integers(0, 2**32, H, dtype=np.int64)
                     for _ in range(2)], axis=1)
    mask = rs.random(H) < 0.9
    # hosts that send nothing may carry any destination, negative too
    dst = np.where(mask, rs.integers(0, H, H), rs.integers(-2 * H, 2 * H, H))
    cols = (mask, dst.astype(np.int32),
            rs.integers(boot - 20 * ms, boot + 200 * ms, H),
            rs.random(H) < 0.1, vertex, vertex, lat, rel, keys, counter)
    return tuple(torch.as_tensor(a, device=device) for a in cols), {
        "bootstrap_end": boot}


def phase_optimistic_kernels(card: str):
    """Phase 12: the kernels of config 4's path on its busiest call in an
    optimistic window from PHASE12_FROM, those of the mixed run likewise,
    the NIC-bound transfer's send-ring dequeues (every kernel of its path
    on its busiest call, its launch counts from t = 0), and synthetic
    full-width tables for the branches the runs do not reach. Returns the
    results by path, and the NIC-bound run's launches."""
    t0 = time.perf_counter()
    sim = build_simulation(CONFIG4)
    best4 = capture_window(sim, CONFIG4_PATH, PHASE12_FROM)
    profile_windows(card, sim, "phase 12 a config-4 optimistic window",
                    8 * sim.runahead, optimistic=True)
    H = sim.num_hosts
    NQ = sim.state.subs["nic"].q_dst.shape[1]
    missing = [k for k in CONFIG4_PATH if k not in best4]
    if missing:
        fail(f"phase 12: config 4's window did not call {missing}")
    print(f"[{card}] phase 12 config-4 inputs: the busiest call of each "
          f"kernel in the optimistic window from t={PHASE12_FROM} "
          f"(H={H} K={sim.K} B={sim.B} O={sim.O}): "
          + json.dumps({k: v[0] for k, v in best4.items()}), flush=True)
    best4["spec_check (synthetic violations)"] = (
        0, *synthetic_spec_check(H, H * sim.O, sim.device))
    best4["nic_refill (synthetic idle gaps)"] = (
        0, *synthetic_nic_refill(H, sim.device))
    best4["link_send (synthetic lossy)"] = (
        0, *synthetic_link_send(H, sim.device))
    best4["send_dequeue (synthetic rings)"] = (
        0, *synthetic_send_dequeue(H, NQ, 12, sim.device))
    del sim
    res4 = compare_calls(card, "phase 12 config 4", best4)
    viol = kernels.spec_check_plain(
        *best4["spec_check (synthetic violations)"][1])
    ls = kernels.link_send_plain(*best4["link_send (synthetic lossy)"][1],
                                 **best4["link_send (synthetic lossy)"][2])
    unreach = best4["link_send (synthetic lossy)"][1][0] & ~(
        ls.deliver | ls.drop)
    if int(viol) == NEVER or not (ls.drop.any() and unreach.any()):
        fail("phase 12: a synthetic table missed its branch")

    sim = build_simulation(MIXED)
    bestm = capture_window(sim, MIXED_PATH, PHASE12_FROM)
    print(f"[{card}] phase 12 mixed-run inputs (H={sim.num_hosts} "
          f"K={sim.K}): " + json.dumps({k: v[0] for k, v in bestm.items()}),
          flush=True)
    del sim
    resm = compare_calls(card, "phase 12 mixed run", bestm)

    sim = build_simulation(nic_bound())
    bestn: dict = {}
    sim.ops = capture_ops(bestn, NIC_PATH)
    kernels.reset_launches()
    t1 = time.perf_counter()
    sim.run(until=NIC_BOUND_UNTIL)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels.KERNELS}
    print(f"[{card}] phase 12 NIC-bound transfer (config 3 at 100 Mbit) to "
          f"t={NIC_BOUND_UNTIL}: wall_s={time.perf_counter() - t1:.3f} "
          f"micro_steps={sim.counters()['micro_steps']} "
          f"launches={launches}", flush=True)
    missing = [k for k in NIC_PATH if launches[k] == 0]
    if missing:
        fail(f"phase 12: the NIC-bound transfer never launched {missing}")
    del sim
    resn = compare_calls(card, "phase 12 NIC-bound", bestn)
    print(f"[{card}] phase 12 wall_s={time.perf_counter() - t0:.3f}",
          flush=True)
    kernels.reset_launches()
    return {"config4": res4, "mixed": resm, "config3_100mbit": resn}, \
        launches


def optimistic_run(card: str, cfg: dict, ops, label: str,
                   until: int | None = None):
    """``cfg`` from t = 0 through ``run_optimistic`` (factor 8, adaptive),
    launch counts set to 0 just before it and read just after."""
    t0 = time.perf_counter()
    sim = build_simulation(cfg)
    sim.ops = ops
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    kernels.reset_launches()
    windows, rollbacks = sim.run_optimistic(until=until)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = {k.name: k.launches for k in kernels.KERNELS}
    c = sim.counters()
    chain = sim.audit_chain()
    win = sim.obs_snapshot()["win"]
    wall = t2 - t1
    steps = c["micro_steps"]
    print(f"[{card}] {label}: hosts={sim.num_hosts} build_s={t1 - t0:.3f} "
          f"wall_s={wall:.3f} windows={windows} rollbacks={rollbacks} "
          f"sub_steps={win['windows_run']} micro_steps={steps} "
          f"ms_per_micro_step={wall / max(steps, 1) * 1e3:.4f} "
          f"events_committed={c['events_committed']} "
          f"events_per_s={c['events_committed'] / wall:.1f} "
          f"counters={json.dumps(c)} win={json.dumps(win)} "
          f"audit_chain={chain:#018x} launches={launches} "
          f"peak_mem_gib={torch.cuda.max_memory_allocated() / 2**30:.3f}",
          flush=True)
    return sim, (windows, rollbacks), c, chain, launches


def check_optimistic(phase: str, res, c, chain, ref) -> None:
    """Windows, rollbacks, counters and chain against the reference's."""
    checks = {"windows": (res[0], ref["windows"]),
              "rollbacks": (res[1], ref["rollbacks"]),
              "audit_chain": (chain, ref["audit_chain"])}
    checks.update({k: (c[k], v) for k, v in ref["counters"].items()})
    for what, (got, want) in checks.items():
        if got != want:
            fail(f"{phase}: {what} = {got}, want {want}")


def same_runs(phase: str, a, b) -> None:
    """Two runs of ``optimistic_run`` equal: windows, rollbacks, counters,
    chain and every state array; the second launched no kernel."""
    (ksim, kres, kc, kchain, _), (psim, pres, pc, pchain, plaunches) = a, b
    if any(plaunches.values()):
        fail(f"{phase}: a kernel launched in the plain run: {plaunches}")
    if (pres, pc, pchain) != (kres, kc, kchain):
        fail(f"{phase}: the plain run's windows, rollbacks, counters or "
             f"chain differ")
    diff = same_state(ksim.state, psim.state)
    if diff:
        fail(f"{phase}: final state differs from the kernels' in {diff}")


def tensors_of(obj, path="") -> dict:
    """Every tensor reachable from a state: {path: tensor}."""
    if isinstance(obj, torch.Tensor):
        return {path: obj}
    if isinstance(obj, dict):
        items = obj.items()
    elif hasattr(obj, "__dataclass_fields__"):
        items = vars(obj).items()
    else:
        return {}
    out = {}
    for k, v in items:
        out.update(tensors_of(v, f"{path}.{k}"))
    return out


def check_snapshot(card: str) -> None:
    """A rolled-back attempt of the mixed run leaves its base state as it
    was: the windows are stepped as the driver steps them, outside
    inference mode so every tensor keeps its version counter, until an
    attempt rolls back."""
    sim = build_simulation(MIXED)
    neg1 = torch.full((sim.num_hosts,), -1, dtype=torch.int64,
                      device=sim.device)
    sim.state = sim.state.with_host(done_t=neg1)
    ws = sim._frontier(sim.stop_time).mn
    for n in range(1, 200):
        base = sim.state.snapshot()
        before = {p: (t, t._version, t.clone())
                  for p, t in tensors_of(base).items()}
        st, mn, viol = sim.attempt(base, ws, ws + 8 * sim.runahead)
        if viol < NEVER:
            break
        sim.state = st.with_host(done_t=neg1)
        ws = mn
    else:
        fail("phase 14: no attempt rolled back")
    after = tensors_of(base)
    if sorted(after) != sorted(before):
        fail("phase 14: the rolled-back attempt changed the base's paths")
    for p, (t, version, value) in before.items():
        if after[p] is not t or t._version != version or not torch.equal(
                t, value):
            fail(f"phase 14: the rolled-back attempt changed base {p}")
    print(f"[{card}] phase 14 snapshot: attempt {n} (window from t={ws}) "
          f"rolled back at t={viol}; its base's {len(before)} tensors are "
          f"the same objects, versions and values", flush=True)


def optimistic_phases(card: str):
    """Phases 12-14. Returns the kernels' results by path and the launches
    of config 4's, the mixed run's and the NIC-bound run's runs."""
    opt_results, launches_nic = phase_optimistic_kernels(card)

    sim, res4, c4, chain4, launches4 = optimistic_run(
        card, CONFIG4, kernels.KERNEL_OPS,
        "phase 13 config 4 through the kernels")
    for k in CONFIG4_PATH:
        if launches4[k] == 0:
            fail(f"phase 13: kernel {k} never launched")
    win = sim.obs_snapshot()["win"]
    if win["matrix_dispatches"] or win["rollbacks"] != res4[1]:
        fail(f"phase 13: unexpected window-plane counters {win}")
    check_optimistic("phase 13", res4, c4, chain4, REF4)
    print(f"[{card}] phase 13 config 4 equal to the JAX package's windows, "
          f"rollbacks, counters and chain", flush=True)
    del sim
    # the same config under the conservative driver: the same history,
    # counted in more windows (tests/test_optimistic.py's fingerprint
    # leaves out the schedule's own counters)
    sim, _, cc, cchain, _ = flood_run(
        card, kernels.KERNEL_OPS,
        "phase 13 config 4 under the conservative driver", CONFIG4)
    schedule = ("micro_steps", "outbox_stall_deferred",
                "pool_overflow_dropped")
    if cchain != chain4 or {k: v for k, v in cc.items()
                            if k not in schedule} != {
                                k: v for k, v in c4.items()
                                if k not in schedule}:
        fail("phase 13: the conservative run's chain or counters differ")
    del sim
    cut = [optimistic_run(card, CONFIG4, ops,
                          f"phase 13 config 4 to {PHASE13_STOP} ({label})",
                          until=PHASE13_STOP)
           for ops, label in ((kernels.KERNEL_OPS, "kernels"),
                              (kernels.PLAIN_OPS, "plain versions"))]
    same_runs("phase 13", *cut)
    print(f"[{card}] phase 13 plain run equal to the kernels' run to "
          f"t={PHASE13_STOP}: windows, rollbacks, counters, chain, "
          f"{len(interop.state_paths(cut[1][0].state))} state arrays",
          flush=True)
    del cut

    runs = [optimistic_run(card, MIXED, ops, f"phase 14 mixed run ({label})")
            for ops, label in ((kernels.KERNEL_OPS, "kernels"),
                               (kernels.PLAIN_OPS, "plain versions"))]
    _, resm, cm, chainm, launchesm = runs[0]
    if resm[1] == 0:
        fail("phase 14: the mixed run took no rollback")
    for k in MIXED_PATH:
        if launchesm[k] == 0:
            fail(f"phase 14: kernel {k} never launched")
    check_optimistic("phase 14", resm, cm, chainm, REF_MIXED)
    same_runs("phase 14", *runs)
    del runs
    flood = [optimistic_run(card, mixed_flood(), ops,
                            f"phase 14 mixed flood ({label})")
             for ops, label in ((kernels.KERNEL_OPS, "kernels"),
                                (kernels.PLAIN_OPS, "plain versions"))]
    if flood[0][1][1] == 0 or flood[0][3] != MIXED_FLOOD_CHAIN:
        fail("phase 14: the mixed flood took no rollback or its chain "
             "differs from the JAX package's")
    same_runs("phase 14 mixed flood", *flood)
    del flood
    check_snapshot(card)
    print(f"[{card}] phase 14 the mixed run equal to the JAX package's "
          f"windows, rollbacks, counters and chain, and to the plain "
          f"versions' state; the mixed flood's loop-path rollbacks too",
          flush=True)
    return opt_results, launches4, launchesm, launches_nic


def same_state(a, b) -> list:
    """The paths where two states' arrays differ (or the path sets)."""
    na, nb = interop.state_to_numpy(a), interop.state_to_numpy(b)
    if sorted(na) != sorted(nb):
        return ["<paths>"]
    return [k for k in na if not (na[k].dtype == nb[k].dtype
                                  and na[k].shape == nb[k].shape
                                  and (na[k] == nb[k]).all())]


def main() -> None:
    t_start = time.perf_counter()
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
    d_t = sim.state.pool.time
    if int((d_t < 0).sum()) or int((d_t == NEVER).sum()) != (
            d_t.numel() - BENCH["num_hosts"] * BENCH["msgload"]):
        fail("phase 4: the final pool's times are not the expected "
             "population")
    del sim

    cut = dict(BENCH, stop_s=PHASE5_STOP_S)
    ksim, kwindows, kc, kchain, _ = bench_run(
        card, kernels.KERNEL_OPS,
        f"phase 5 bench shape to {PHASE5_STOP_S} s through the kernels",
        cut)
    psim, pwindows, pc, pchain, plaunches = bench_run(
        card, kernels.PLAIN_OPS,
        f"phase 5 bench shape to {PHASE5_STOP_S} s, plain versions", cut)
    if any(plaunches.values()):
        fail(f"phase 5: a kernel launched in the plain run: {plaunches}")
    if (pwindows, pc, pchain) != (kwindows, kc, kchain):
        fail("phase 5: the plain run's windows, counters or chain differ")
    diff = same_state(ksim.state, psim.state)
    if diff:
        fail(f"phase 5: final state differs from the kernels' in {diff}")
    print(f"[{card}] phase 5 plain run equal to the kernels' run to "
          f"{PHASE5_STOP_S} s: counters, chain, "
          f"{len(interop.state_paths(psim.state))} state arrays", flush=True)
    del ksim, psim

    loop_results = phase_loop_kernels(card)

    sim, windows2, c2, chain2, launches2 = flood_run(
        card, kernels.KERNEL_OPS, "phase 7 config 2 through the kernels")
    checks = {k: (c2[k], v) for k, v in REF2_COUNTERS.items()}
    checks["audit_chain"] = (chain2, REF2_AUDIT_CHAIN)
    for k in CONFIG2_PATH:
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
    del sim

    cut = {**CONFIG2, "general": {**CONFIG2["general"],
                                  "stop_time": PHASE8_STOP_S}}
    ksim, kwindows, kc, kchain, _ = flood_run(
        card, kernels.KERNEL_OPS,
        f"phase 8 config 2 to {PHASE8_STOP_S} s through the kernels", cut)
    psim, pwindows, pc, pchain, plaunches = flood_run(
        card, kernels.PLAIN_OPS,
        f"phase 8 config 2 to {PHASE8_STOP_S} s, plain versions", cut)
    if any(plaunches.values()):
        fail(f"phase 8: a kernel launched in the plain run: {plaunches}")
    if (pwindows, pc, pchain) != (kwindows, kc, kchain):
        fail("phase 8: the plain run's windows, counters or chain differ")
    diff = same_state(ksim.state, psim.state)
    if diff:
        fail(f"phase 8: final state differs from the kernels' in {diff}")
    print(f"[{card}] phase 8 plain run equal to the kernels' run to "
          f"{PHASE8_STOP_S} s: counters, chain, "
          f"{len(interop.state_paths(psim.state))} state arrays (pool, "
          f"host, obs, subs)", flush=True)
    del ksim, psim

    t_tcp = time.perf_counter()
    print(f"[{card}] phases 1-8 wall_s={t_tcp - t_start:.3f}", flush=True)
    tcp_results = phase_tcp_kernels(card)

    sim, windows3, c3, tc3, chain3, launches3 = tcp_run(
        card, CONFIG3, kernels.KERNEL_OPS,
        "phase 10 config 3 through the kernels")
    for k in CONFIG3_PATH:
        if launches3[k] == 0:
            fail(f"phase 10: kernel {k} never launched")
    if launches3["phold_forward"]:
        fail("phase 10: phold_forward launched on the loop path")
    win = sim.obs_snapshot()["win"]
    if win["loop_dispatches"] != windows3 or win["matrix_dispatches"]:
        fail(f"phase 10: not every window took the loop path: {win}")
    check_transfers(sim, "phase 10")
    check_reference("phase 10", c3, tc3, chain3, REF3)
    print(f"[{card}] phase 10 config 3 equal to the JAX package's counters, "
          f"TCP counters and chain; every transfer complete", flush=True)

    psim, pwindows, pc, ptc, pchain, plaunches = tcp_run(
        card, CONFIG3, kernels.PLAIN_OPS, "phase 11 config 3, plain versions")
    if any(plaunches.values()):
        fail(f"phase 11: a kernel launched in the plain run: {plaunches}")
    if (pwindows, pc, ptc, pchain) != (windows3, c3, tc3, chain3):
        fail("phase 11: the plain run's windows, counters or chain differ")
    diff = same_state(sim.state, psim.state)
    if diff:
        fail(f"phase 11: final state differs from the kernels' in {diff}")
    print(f"[{card}] phase 11 plain run equal to the kernels' run: counters, "
          f"chain, {len(interop.state_paths(sim.state))} state arrays",
          flush=True)
    del sim, psim

    t_opt = time.perf_counter()
    opt_results, launches4, launchesm, launches_nic = optimistic_phases(card)

    bounds = {name: merge_bound(build_simulation(cfg))
              for name, cfg in (("config2", CONFIG2), ("config3", CONFIG3),
                                ("config4", CONFIG4))}
    bounds["phold"] = merge_bound(build_phold_flagship(**BENCH))
    print(f"[{card}] merge (B2) bytes bound per window, ms: "
          + json.dumps(bounds), flush=True)

    # one entry for each kernel on each main path: its launches in that
    # path's run, and its times and bound on that path's inputs
    paths = (("phold", PHOLD_PATH, launches, results),
             ("config2", CONFIG2_PATH, launches2, loop_results),
             ("config3", CONFIG3_PATH, launches3, tcp_results),
             ("config4", CONFIG4_PATH, launches4, opt_results["config4"]),
             ("mixed", MIXED_PATH, launchesm, opt_results["mixed"]),
             ("config3_100mbit", NIC_PATH, launches_nic,
              opt_results["config3_100mbit"]))
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
            "issue_ms": res[k.name]["issue_ms"],
            "plain_ms": res[k.name]["plain_ms"],
            "bound_ms": res[k.name]["bound"][0],
            "bound_by": res[k.name]["bound"][1],
            "library_ms": None,
        }
        for k in kernels.KERNELS
        for path, on_path, counts, res in paths if k.name in on_path
    ]}
    t_end = time.perf_counter()
    print(f"[{card}] phases 9-11 wall_s={t_opt - t_tcp:.3f}; phases 12-14 "
          f"wall_s={t_end - t_opt:.3f}; whole script "
          f"wall_s={t_end - t_start:.3f}", flush=True)
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))


if __name__ == "__main__":
    main()
