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
two test shapes for code paths that config 4 does not take: the
PHOLD bench shape over a two-vertex graph whose speculative windows roll
back ("the mixed run"), and config 3 at 100 Mbit, whose senders queue at
their NICs; and four paths of PHOLD's variants and the CPU model: the
bench shape with its hot-spot variant (``PHOLD_HOT``), its local-span
variant (``PHOLD_LOCAL``) and a quarter of its hosts at 10 ms of CPU an
event (``PHOLD_CPU``), and config 2 with its servers at 5 ms an event
(``CONFIG2_CPU``); and the two paths of the device-queue disciplines:
config 2 with its clients' uplinks starved to 300 Kbit under
``configs/incast.yaml``'s pifo section (WFQ, RED; ``CONFIG2_PIFO``) and
under eiffel with WFQ and the CoDel hook (``CONFIG2_EIFFEL``). Phases,
each printing its numbers beside the card's name and power limit:

1. the card: name, power limit, count, torch and CUDA versions;
2. build the twenty-three CUDA kernels from ``shadow_tpu_torch/csrc``
   with nvcc (one process per source, all at once) and print ptxas's
   register and shared-memory report, and for ``loop_select``,
   ``loop_route``, ``ring_append``, ``tcp_ack``, ``tcp_reorder``,
   ``tcp_out``, ``nic_tx``, ``nic_rx``, ``nic_gate``, ``extract_slots``,
   ``phold_forward``, ``window_sort``, ``pool_merge``, ``cpu_serialize``,
   ``qdisc_enqueue`` and ``qdisc_dequeue`` each entry function's
   registers, shared memory and spill bytes;
3. each kernel at the bench shape's widths, on inputs taken from a real
   window of the run: equal bit for bit to its plain PyTorch version on
   the card; the kernel's device time (200 calls replayed from one CUDA
   graph), its issue time (the same calls back to back from Python, the
   median of five rounds) and
   the plain version's time (CUDA events, warmed) beside the bound; the
   two sorts ``window_sort`` and ``pool_merge`` (each of whose plain
   versions is the whole torch sequence it replaces) also beside one
   ``torch.sort(stable=True)`` on their keys (``library_ms``, CUDA events
   over 20 calls back to back); the device launches of one
   ``dense_extract`` and of one merge, through the kernels and through
   the plain versions, counted with ``torch.profiler``, and the kernels'
   device time by entry function; and the window
   step's parts, timed, with the sorts' and ``extract_slots``' issue
   times under ``inference_mode``, as ``Simulation.run`` calls them
   (in phases 6, 9
   and 12 five kernels
   write into their arguments: ``loop_route`` its boxes, ``ring_append``
   the ring planes, ``tcp_ack``, ``tcp_reorder`` and ``tcp_out`` fields
   of the TCP table; each takes clones to compare, must return them, and
   must leave every cell its plain version leaves as it was; each timed
   call of ``loop_route`` and the TCP kernels restores its inputs from a
   pristine copy first, the restores alone timed and subtracted (the
   median of eleven rounds), and ``ring_append``'s calls, which write the
   same cells every time, run back to back);
4. the full bench-shape run through the kernels, launch counts set to 0
   just before it and read just after: the committed events, overflow,
   bulk-contract count and audit chain must equal the JAX package's
   reference values below, and each kernel must launch once a window;
5. the bench shape to 5 s (of 10), through the kernels and through the
   plain versions on the card: counters, chain and the whole final state
   equal;
6. every kernel of config 2's path (extract_slots at Kc = 13,
   audit_commit on the micro-steps' taken events, loop_select,
   loop_route, ring_append, and the NIC's nic_tx, nic_rx and nic_gate)
   at its widths, on inputs captured from two real
   windows of the flood run (each kernel's busiest call), plus
   codel_dequeue on a synthetic full-width router state in drop mode with
   stale packets (the flood never queues at a router, so its run never
   calls it): each equal bit for bit to its plain version, timed beside
   its bound; and a few flood windows run twice from one state, alone and
   under the profiler (device time by kernel, device launches per
   micro-step and the device's busy share of the same windows);
7. config 2 from t = 0 to the stop in one ``run()`` through the kernels,
   launch counts set to 0 just before it and read just after: counters
   and audit chain equal to the JAX package's reference values below, and
   every kernel of the path launched;
8. config 2 to 2 s (of 4), through the kernels and through the plain
   versions on the card: counters, chain and every state array equal;
9. every kernel of config 3's path (the loop path's six at Kc = 17,
   B = 8, O = 32 and no bulk batch, nic_tx, nic_rx, the receive pump's
   nic_refill, and the four TCP kernels tcp_demux,
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
11. config 3 to ``PHASE11_STOP_S`` through the kernels and the plain
    versions on the card: counters, chain and every state array equal;
12. the kernels of config 4's path (K12 ``spec_check``, K16
    ``nic_tx``, K17 ``nic_rx``, K18 ``nic_gate`` and the loop path's) on
    their busiest call in an optimistic window of config 4, those of the
    mixed run likewise, and every kernel of the NIC-bound transfer (with
    its pumps' K13 ``nic_refill``, K14 ``send_dequeue`` and K15
    ``link_send``) on its busiest call to 1.06 s, its launches counted
    from t = 0, and a few of its windows alone and under the profiler;
    plus full-width synthetic tables for the branches the
    runs miss (K12 with violations and filler destinations, K13 with
    NEVER lanes and long idle gaps, K14 with wrapped rings, K15 and K16
    with loss 0.5, unreachable pairs, loopback and control packets, K16
    and K17 with token debt, NEVER lanes and bootstrap, K17 with full
    and wrapped router rings, K18 with debt and a window wholly inside
    bootstrap), and ``loop_select``
    on a seeded synthetic micro-step at 100,352 hosts
    (``bench.py:stage_udp_flood_100k``'s width) at config 4's K, B, O, G
    and PP: each equal bit for bit to its plain version, timed beside its
    bound, with the wide ``loop_select`` call's time over config 4's;
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
    and against the JAX package's chain; and rolled-back attempts, of the
    mixed run, of the mixed flood at 200 Kbit after appending to the
    NIC's and the router's ring in place, and of config 3's shape at 32
    hosts after ``tcp_ack`` and ``tcp_out`` ran on masked hosts, that
    leave every tensor of their base state as it was (same object,
    version and values);
15. every kernel of each of the four new paths (``NEW_PATHS``: K1 with
    the hot and local picks, K2 with exec times apart from the times,
    K21 ``cpu_serialize`` in its matrix and its loop form) on its
    busiest call over a few windows from ``NEW_MID``, equal bit for bit
    to its plain version and timed beside its bound; and K1's
    ``pick_dst`` (``kernels.phold_pick``) on every draw the uniform
    takes and the float32 values around each split, in its three modes,
    against ``pick_dst``; and the next ten windows of ``phold_cpu``,
    ``config2_cpu``, the bench shape and config 2 alone and under the
    profiler;
16. each new path from t = 0 to the stop in one ``run()`` through the
    kernels, launch counts set to 0 just before it and read just after:
    windows, every counter and the chain equal to the JAX package's
    (``REF_NEW``), every kernel of the path launched (K1, K2, K19, K20,
    K3, K12 and on ``phold_cpu`` K21 once a window; K21 on
    ``config2_cpu`` once a micro-step that commits, as K2) and no other;
17. each new path to ``NEW_MID`` through the kernels and the plain
    versions on the card: windows, counters, chain and every state
    array (``cpu_avail`` among them) equal; and ``phold_cpu`` to the
    same cut through ``run_stepwise``: the same windows, counters, chain
    and state as ``run``'s. K21 must launch on none of the six earlier
    paths;
18. each qdisc path (``QDISC_PATHS``) to ``QDISC_CUT_S`` through the
    kernels and the plain versions on the card: windows, counters, chain
    and every state array equal; every kernel of ``QDISC_PATH`` on its
    busiest call over the next windows (``QDISC_CAPTURE_WINDOWS``), K22
    ``qdisc_enqueue`` and K23 ``qdisc_dequeue`` among them, equal bit for
    bit to its plain version (the in-place kernels on clones, every cell
    they leave as it was checked) and timed beside its bound; one window
    alone and under the profiler; and K22 and K23 on synthetic
    full-width planes of every discipline, ranker, drop policy and
    shaping (``synthetic_qdisc_plane``: PIFO's mid-row insert and
    Eiffel's wrapped scan, which the flood's tail inserts never take,
    and ranks near the int64 limits), against their plain versions;
19. each qdisc path from t = 0 to the stop in one ``run()`` through the
    kernels, launch counts set to 0 just before it and read just after:
    windows, every counter, the chain and a digest of the final qdisc
    plane (``qdisc_digest``) equal to the JAX package's (``REF_QDISC``),
    every kernel of ``QDISC_PATH`` launched and no other (no
    ``send_dequeue``: the discipline replaces the NIC's ring);
20. the pifo path with the clients' class shaped to 200 Kbit
    (``CONFIG2_PIFO_SHAPED``, cut to ``QDISC_CUT_S``) through the
    kernels, equal to the JAX package's values, and through the plain
    versions, state by state; and a rolled-back attempt of the mixed
    flood at 200 Kbit under pifo, after the qdisc kernels wrote its
    snapshot's plane in place, that leaves its base as it was. K22 and
    K23 must launch on none of the ten earlier paths.

It prints the kernels' JSON line, the card line and, last, the ok line.
The line has one entry for each kernel on each main path (``path``
"phold", "config2", "config3", "config4", "mixed", "config3_100mbit",
"phold_hot", "phold_local", "phold_cpu", "config2_cpu", "config2_pifo"
or "config2_eiffel"): its ``launches`` in that path's run (phase 4, 7,
10, 13, 14, 12, 16 or 19), and its times and bound on that path's inputs
(phase 3, 6, 9, 12, 15 or 18);
``ms`` is the device time, ``issue_ms`` the issue time,
``library_ms`` the ``torch.sort`` yardstick of the two sorts (null for
the other kernels).
Any failure raises, exits non-zero and prints no ok line;
with no card, or without the rest of the repository beside it, it fails
at once.

The reference values come from the JAX package on a CPU (README.md, "The
PyTorch/CUDA port", gives the commands):
``build_phold_flagship(16384, msgload=8, stop_s=10, runtime_s=10)`` then
``sim.run()``, configs 2 and 3 (``CONFIG2`` and ``CONFIG3`` below)
through ``shadow_tpu.sim.build_simulation`` then ``sim.run()``, and
config 4 and the mixed run (``CONFIG4``, ``MIXED``) through
``build_simulation`` then ``sim.run_optimistic()``, the four new
paths through ``build_simulation`` then ``sim.run()``, and the qdisc
paths with ``python tools/qdisc_reference.py``.
"""

from __future__ import annotations

import hashlib
import json
import re
import subprocess
import sys
import time

import torch

import numpy as np

from shadow_tpu_torch import interop, kernels
from shadow_tpu_torch.core import engine
from shadow_tpu_torch.core.simtime import NEVER
from shadow_tpu_torch.flagship import SELF_LOOP_50MS_GML, build_phold_flagship
from shadow_tpu_torch.net.apps import PholdApp
from shadow_tpu_torch.sim import build_simulation

BENCH = dict(num_hosts=16384, msgload=8, stop_s=10, runtime_s=10, seed=42)
REF_EVENTS_COMMITTED = 23_592_960
REF_EVENTS_EMITTED = 23_592_960
REF_PACKETS_SENT = 23_592_960
REF_POOL_OVERFLOW_DROPPED = 0
REF_AUDIT_CHAIN = 0x2A4DA5031C0CA606
REF_WINDOWS = 181


def phold_config(loaded: int = 0, cpu_ns: int = 0, **app) -> dict:
    """The bench shape as ``build_phold_flagship`` builds it (16,384 hosts,
    msgload 8, stop and runtime 10 s, seed 42, its pool and K), with PHOLD
    options ``app`` (``hot_frac``/``hot_share``, ``local_span``) and the
    last ``loaded`` hosts at ``cpu_ns`` of CPU time an event."""
    H, m = BENCH["num_hosts"], BENCH["msgload"]
    opts = {"msgload": m, "runtime": BENCH["runtime_s"], **app}
    hosts = {"peer": {"quantity": H - loaded, "app_model": "phold",
                      "app_options": opts}}
    if loaded:
        hosts["loaded"] = {"quantity": loaded, "app_model": "phold",
                           "app_options": dict(opts),
                           "cpu_ns_per_event": cpu_ns}
    return {
        "general": {"stop_time": BENCH["stop_s"], "seed": BENCH["seed"]},
        "network": {"graph": {"type": "gml",
                              "inline": SELF_LOOP_50MS_GML}},
        "experimental": {"event_capacity": max(3 * H * m // 2, 4096),
                         "events_per_host_per_window": m + 16,
                         "outbox_slots": m + 16, "inbox_slots": 4},
        "hosts": hosts,
    }


def pick_sweep(num_hosts: int, hot_n: int = 0, hot_share: float = 0.0,
               local_span: int = 0, seed: int = 53):
    """(u, my_id) float32 and int32 numpy arrays for ``pick_dst``: every
    draw the float32 uniform takes (k·2^-23), then the float32 values
    within two steps of each split of the mode (the hot share, and each
    bucket edge j / c_hot and hs + j / c_cold; j / 2·span; j / (H - 1)),
    each with a seeded sender."""
    edges = []
    if local_span:
        edges = [j / (2 * local_span) for j in range(2 * local_span + 1)]
    elif hot_n:
        hs, c_hot, c_cold = kernels.hot_split(num_hosts, hot_n, hot_share)
        edges = ([hs] + [j / c_hot for j in range(hot_n + 1)]
                 + [hs + j / c_cold for j in range(num_hosts - hot_n + 1)])
    elif num_hosts > 1:
        edges = [j / (num_hosts - 1) for j in range(num_hosts)]
    near = np.float32(np.array(edges, dtype=np.float64))
    for _ in range(2):
        near = np.concatenate([near] + [
            np.nextafter(near, np.float32(d * np.inf)) for d in (-1, 1)])
    near = near[(near >= 0) & (near < 1)]
    u = np.concatenate([np.arange(1 << 23, dtype=np.float32)
                        * np.float32(2.0 ** -23), np.unique(near)])
    me = np.random.default_rng(seed).integers(0, num_hosts, u.shape[0])
    return u, me.astype(np.int32)


# PHOLD's hot-spot variant: half of all forwards target the first eighth
# of the hosts, whose ≈32 events a window overflow K = 24, so the window
# steps again for the stragglers
PHOLD_HOT = phold_config(hot_frac=0.125, hot_share=0.5)
# the local-span variant at bench.py's async-sync value
PHOLD_LOCAL = phold_config(local_span=2)
# the CPU model: the last quarter of the hosts pays 10 ms an event
# (tests/test_engine_phold.py's loaded cost), 100 events/s against ≈160
# offered, so their CPU clocks run away
PHOLD_CPU = phold_config(loaded=4096, cpu_ns=10_000_000)

COUNTER_NAMES = (
    "bulk_contract_violations", "bytes_delivered", "bytes_sent",
    "cpu_delay_applied", "events_committed", "events_emitted",
    "exchange_deferred", "exchange_sent", "inbox_overflow_deferred",
    "micro_steps", "outbox_overflow_dropped", "outbox_stall_deferred",
    "packets_delivered", "packets_dropped_loss",
    "packets_dropped_unreachable", "packets_sent", "pool_overflow_dropped")


def all_counters(**nonzero) -> dict:
    """Every counter of ``Simulation.counters()``: the ones given, 0 the
    rest."""
    return {k: nonzero.pop(k, 0) for k in COUNTER_NAMES} | nonzero


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
# config 2 with the CPU model on every host: the 1,280 servers at 5 ms an
# event, each taking ≈350 datagrams/s from 7 clients at 20 ms intervals
# against 200 events/s of CPU, so their events serialize; the 8,960
# clients at 25 ms an event, past their 20 ms interval, so each send runs
# late and the next timer with it (a send every 25 ms): the CPU model moves
# the emitted history, its chain and counters
CONFIG2_CPU = {**CONFIG2, "hosts": {
    "server": {**CONFIG2["hosts"]["server"], "cpu_ns_per_event": 5_000_000},
    "client": {**CONFIG2["hosts"]["client"],
               "cpu_ns_per_event": 25_000_000}}}


def qdisc_config(qdisc: dict, stop_time: int | None = None) -> dict:
    """Config 2 with its clients' uplinks starved to 300 Kbit (each
    client's ≈421 Kbit/s of wire bytes queues at its NIC) and the
    ``qdisc:`` section ``qdisc``; ``stop_time`` in seconds cuts it."""
    general = dict(CONFIG2["general"])
    if stop_time is not None:
        general["stop_time"] = stop_time
    return {**CONFIG2, "general": general, "qdisc": qdisc, "hosts": {
        "server": CONFIG2["hosts"]["server"],
        "client": {**CONFIG2["hosts"]["client"],
                   "bandwidth_up": "300 Kbit"}}}


# the device-queue disciplines' paths: configs/incast.yaml's section
# (pifo, WFQ, RED) and an Eiffel section with the CoDel hook, the
# override prefixes naming this config's hosts
QDISC_OVERRIDES = {"client": 0, "server": 1}
PIFO_SECTION = {
    "discipline": "pifo", "rank": "wfq", "classes": 2, "weights": [1, 4],
    "drop": "red", "red_min_frac": 0.25, "red_max_frac": 0.75,
    "red_max_p": 0.1, "queue_slots": 32, "overrides": QDISC_OVERRIDES}
EIFFEL_SECTION = {
    "discipline": "eiffel", "rank": "wfq", "classes": 2, "weights": [1, 4],
    "buckets": 16, "bucket_width": 4096, "drop": "codel",
    "queue_slots": 64, "overrides": QDISC_OVERRIDES}
CONFIG2_PIFO = qdisc_config(PIFO_SECTION)
CONFIG2_EIFFEL = qdisc_config(EIFFEL_SECTION)
# the cut runs of the qdisc paths stop here (s; the clients send from
# 1 s); the shaped one shapes the clients' class to 200 Kbit, so that
# K22's eligibility term runs
QDISC_CUT_S = 1.1
CONFIG2_PIFO_SHAPED = qdisc_config(
    {**PIFO_SECTION, "shaping": {0: "200 Kbit"}}, stop_time=QDISC_CUT_S)


def qdisc_digest(arrays: dict) -> str:
    """A digest of every ``subs.qdisc.*`` array of a state flattened by
    the interop paths (each path, dtype, shape and bytes, in path
    order)."""
    h = hashlib.sha256()
    for path in sorted(p for p in arrays if p.startswith("subs.qdisc.")):
        a = np.ascontiguousarray(arrays[path])
        h.update(f"{path} {a.dtype} {a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()[:16]

# The JAX package's values for the variants and the CPU model at full
# width and depth: build_simulation(cfg) then sim.run() on a CPU (config 2
# with windows_per_dispatch=32), windows from obs_snapshot()["win"].
REF_NEW = {
    "phold_hot": {
        "windows": 538, "audit_chain": 0xF59BDFCC81EC8F4A,
        "counters": all_counters(
            bytes_sent=1_509_949_440, events_committed=23_592_960,
            events_emitted=23_592_960, micro_steps=538,
            packets_sent=23_592_960)},
    "phold_local": {
        "windows": 180, "audit_chain": 0x44963D2162ACAE3C,
        "counters": all_counters(
            bytes_sent=1_509_949_440, events_committed=23_592_960,
            events_emitted=23_592_960, micro_steps=180,
            packets_sent=23_592_960)},
    "phold_cpu": {
        "windows": 180, "audit_chain": 0x5A4BF1F83F1CB644,
        "counters": all_counters(
            bytes_sent=928_388_736, cpu_delay_applied=465_034_480_000_000,
            events_committed=14_506_074, events_emitted=14_506_074,
            micro_steps=180, packets_sent=14_506_074)},
    "config2_cpu": {
        "windows": 241, "audit_chain": 0x44AA225B06E15BCE,
        "counters": all_counters(
            bytes_delivered=1_099_926_528,
            bytes_sent=1_131_110_400, cpu_delay_applied=658_424_230_000_000,
            events_committed=2_158_307, events_emitted=2_149_347,
            micro_steps=723, outbox_stall_deferred=367_676,
            packets_delivered=1_074_147, packets_dropped_loss=1_053,
            packets_sent=1_075_200)},
}


# The JAX package's values for the device-queue disciplines' paths at full
# width and depth, and for the shaped pifo cut to QDISC_CUT_S: windows,
# every counter, the audit chain and qdisc_digest of the final
# subs["qdisc"] (JAX_PLATFORMS=cpu python tools/qdisc_reference.py on a
# CPU prints them: ≈62 min for each whole path, ≈2 min for the cut).
# The two disciplines commit the same history: each client's queue holds
# one flow class, so WFQ serves it in arrival order, its pump sends
# whenever its tokens allow, and what a discipline drops is a queued
# packet like the one it sends next; the planes differ.
REF_QDISC = {
    "config2_pifo": {
        "windows": 756, "audit_chain": 0x5227644F4F211922,
        "qdisc_digest": "704bf333e187a293",
        "counters": all_counters(
            bytes_delivered=971_623_424, bytes_sent=999_147_520,
            events_committed=28_868_211, events_emitted=28_877_171,
            micro_steps=25_766, outbox_stall_deferred=99_981_018,
            packets_delivered=948_851, packets_dropped_loss=909,
            packets_sent=949_760)},
    "config2_eiffel": {
        "windows": 756, "audit_chain": 0x5227644F4F211922,
        "qdisc_digest": "563a6024243bc4ab",
        "counters": all_counters(
            bytes_delivered=971_623_424, bytes_sent=999_147_520,
            events_committed=28_868_211, events_emitted=28_877_171,
            micro_steps=25_766, outbox_stall_deferred=99_981_018,
            packets_delivered=948_851, packets_dropped_loss=909,
            packets_sent=949_760)},
    "config2_pifo_shaped": {
        "windows": 15, "audit_chain": 0xBC8A2C67BC262D8C,
        "qdisc_digest": "958a991195f00a79",
        "counters": all_counters(
            bytes_delivered=36_658_176, bytes_sent=37_703_680,
            events_committed=671_959, events_emitted=680_919,
            micro_steps=456, outbox_stall_deferred=1_526_993,
            packets_delivered=35_799, packets_dropped_loss=41,
            packets_sent=35_840)},
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


def mixed_flood(bandwidth: str | None = None) -> dict:
    """Config 4's shape at 16 hosts over MIXED_GML, 2 s: the servers and
    six clients on vertex 1, eight clients on vertex 0. A server takes a
    far packet ahead of a near one sent later, so speculation rolls back
    on the loop path (``tests/test_torch_optimistic.py`` pins the JAX
    package's values). ``bandwidth`` replaces every node's 100 Mbit."""
    gml = MIXED_GML if bandwidth is None else MIXED_GML.replace(
        '"100 Mbit"', f'"{bandwidth}"')
    cfg = config4(16, gml)
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
# At 100 Mbit nothing of the mixed flood queues, so its ring_append
# launches append no packet. At this bandwidth the clients' NIC send
# rings and the servers' router rings queue, and rolled-back attempts
# append to both: phase 14's snapshot check runs it.
SNAPSHOT_FLOOD_BW = "200 Kbit"
# phase 14's TCP snapshot check runs config 3's shape at this width
SNAPSHOT_TCP_HOSTS = 32


def mixed_flood_qdisc() -> dict:
    """The mixed flood at SNAPSHOT_FLOOD_BW under pifo with wfq and
    codel: its speculative windows roll back after the qdisc kernels ran
    on queued packets."""
    return {**mixed_flood(SNAPSHOT_FLOOD_BW), "qdisc": {
        "discipline": "pifo", "rank": "wfq", "drop": "codel",
        "queue_slots": 32}}


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
# phase 12's wide loop_select call: bench.py:stage_udp_flood_100k's hosts
SELECT_WIDE = 100_352

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
# config 3's kernels and plain versions are compared to here (s, of 4;
# a cut, to keep the script in half its time limit): its transfers start
# at 1 s and take half their micro-steps in their first 0.2 s
PHASE11_STOP_S = 1.2

# the kernels of each main path
PHOLD_PATH = ("window_sort", "extract_slots", "phold_forward",
              "audit_commit", "spec_check", "pool_merge")
# every send through the stack takes nic_tx (the direct send), every
# arrival nic_rx
LOOP_PATH = ("window_sort", "extract_slots", "audit_commit", "loop_select",
             "loop_route", "codel_dequeue", "ring_append", "spec_check",
             "nic_tx", "nic_rx", "pool_merge")
# config 2 never queues at a router (1 Gbit, 7 clients a server), so no
# host takes a receive-pump event and codel_dequeue's handler never runs;
# its UDP arrivals are batched behind nic_gate
CONFIG2_PATH = tuple(k for k in LOOP_PATH if k != "codel_dequeue") + (
    "nic_gate",)
TCP_PATH = ("tcp_demux", "tcp_ack", "tcp_reorder", "tcp_out")
# config 3's routers queue a few packets, so its receive pump runs, and
# refills its bucket with nic_refill; TCP takes no bulk batch (no
# nic_gate)
CONFIG3_PATH = LOOP_PATH + TCP_PATH + ("nic_refill",)
# config 4 is config 2's flood at 50,176 hosts under the optimistic driver
CONFIG4_PATH = CONFIG2_PATH
MIXED_PATH = PHOLD_PATH
# the CPU model adds cpu_serialize (K21) to a path
PHOLD_CPU_PATH = PHOLD_PATH + ("cpu_serialize",)
CONFIG2_CPU_PATH = CONFIG2_PATH + ("cpu_serialize",)
# each new path: its config and its kernels; and (NEW_MID) the simulated
# time its kernels are captured from (phase 15) and its cut runs stop at
# (phase 17)
NEW_PATHS = {
    "phold_hot": (PHOLD_HOT, PHOLD_PATH),
    "phold_local": (PHOLD_LOCAL, PHOLD_PATH),
    "phold_cpu": (PHOLD_CPU, PHOLD_CPU_PATH),
    "config2_cpu": (CONFIG2_CPU, CONFIG2_CPU_PATH),
}
NEW_MID = {"phold_hot": 5_000_000_000, "phold_local": 5_000_000_000,
           "phold_cpu": 5_000_000_000, "config2_cpu": 2_000_000_000}
# the device-queue disciplines replace the NIC's send ring: each send
# that does not go straight to the wire takes qdisc_enqueue (K22), the
# send pump qdisc_dequeue (K23), its bucket's nic_refill and link_send;
# the routers' ring_append stays, send_dequeue never runs, and no router
# queues (codel_dequeue)
QDISC_PATH = CONFIG2_PATH + ("nic_refill", "link_send", "qdisc_enqueue",
                             "qdisc_dequeue")
QDISC_PATHS = {"config2_pifo": CONFIG2_PIFO, "config2_eiffel": CONFIG2_EIFFEL}
# phase 18's synthetic planes: rows of QDISC_SLOTS at config 2's width
QDISC_SLOTS = 64
# the windows phase 18 captures each kernel's busiest call from: at
# least the first, and on until every kernel of the path ran and a pump
# popped (a client's pump pops once in ≈28 ms, a 1,052-byte datagram at
# 300 Kbit, in rounds the outbox stalls shift), at most the second
QDISC_CAPTURE_WINDOWS = (8, 40)
# no NIC send ring queues at 1 Gbit (configs 2 to 4), so only the
# NIC-bound transfer takes the send pump: its dequeue and its link_send
NIC_PATH = CONFIG3_PATH + ("send_dequeue", "link_send")
# the pumps' kernels, which the runs at 1 Gbit launch only where a
# pump runs: never on configs 2 and 4, and on config 3 nic_refill once a
# receive-pump call (as often as codel_dequeue)
PUMP_ONLY = ("nic_refill", "link_send")

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
    "window_sort": "shadow_tpu/core/engine.py:447",
    "pool_merge": "shadow_tpu/core/engine.py:710",
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
    "nic_tx": "shadow_tpu/net/stack.py:142",
    "nic_rx": "shadow_tpu/net/stack.py:293",
    "nic_gate": "shadow_tpu/net/stack.py:483",
    # the matrix form; on the loop path, the loop body's chain
    # (REPLACES_LOOP)
    "cpu_serialize": "shadow_tpu/core/engine.py:1224",
    "qdisc_enqueue": "shadow_tpu/net/qdisc/pifo.py:178",
    "qdisc_dequeue": "shadow_tpu/net/qdisc/pifo.py:200",
}
REPLACES_LOOP = {"cpu_serialize": "shadow_tpu/core/engine.py:904"}


# the entry functions whose name is not their kernel's with "_kernel"
ENTRIES = {"plan": "loop_select", "apply": "loop_select",
           "spec_init": "spec_check", "window_count": "window_sort",
           "window_pass": "window_sort", "window_place": "window_sort",
           "merge_count": "pool_merge", "merge_first_pass": "pool_merge",
           "merge_pass": "pool_merge"}


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


# rounds of 200 calls from Python an issue time is the median of: one
# round's reading of the same wrapper moved by up to half between calls
ISSUE_ROUNDS = 5


def issue_times(fn, base=None) -> dict:
    """``issue_ms``: the median over ISSUE_ROUNDS rounds of
    ``time_ms(fn, 200)`` (less ``time_ms(base, 200)`` of the same round,
    where given); ``issue_rounds_ms``: every round's reading."""
    rounds = [time_ms(fn, 200) - (0.0 if base is None else time_ms(base, 200))
              for _ in range(ISSUE_ROUNDS)]
    return dict(issue_ms=float(np.median(rounds)), issue_rounds_ms=rounds)


def issue_rounds(r: dict) -> str:
    """The rounds behind an issue time, for a phase's line."""
    return " ".join(f"{x:.6f}" for x in r["issue_rounds_ms"])


def kernel_times(kern, plain) -> dict:
    """``ms``: a kernel call's device time (``graph_ms``, 200 calls);
    ``issue_ms``: the same calls back to back from Python (CUDA events,
    ``issue_times``), which at small sizes measures the wrapper's host
    cost; ``plain_ms``: the plain version's calls back to back (20)."""
    return dict(ms=graph_ms(kern, 200), **issue_times(kern),
                plain_ms=time_ms(plain, 20))


# what each in-place kernel writes on the card: its argument positions,
# each mapped to the result field that returns it (Kernel.writes)
WRITES = {k.name: k.writes for k in kernels.KERNELS if k.writes}
# a repeated ring_append on the same inputs writes the same cells (its
# input tail is not written), so its calls are timed without a restore
IDEMPOTENT = ("ring_append",)
# rounds of restore-alone and restore-and-call graphs an in-place call's
# device time is the median difference of
IN_PLACE_ROUNDS = 11


def clone_arg(x):
    if isinstance(x, kernels.Boxes):
        return clone_boxes(x)
    if isinstance(x, list):  # the merge's blocks, nic_tx's counters
        return [type(b)(*map(clone_arg, b)) if isinstance(b, tuple)
                else clone_arg(b) for b in x]
    return x.clone() if isinstance(x, torch.Tensor) else x


def work_args(name: str, args) -> tuple:
    """``args`` with clones of what the kernel ``name`` writes in place."""
    idx = WRITES.get(name, {})
    return tuple(clone_arg(a) if i in idx else a for i, a in enumerate(args))


def _flat(xs) -> list:
    """The tensors of ``xs``, each box tuple and field list flattened,
    each None left out."""
    out = []
    for x in xs:
        out.extend(x if isinstance(x, (kernels.Boxes, list, tuple)) else
                   [] if x is None else [x])
    return out


def written(name: str, args) -> list:
    """The tensors among ``args`` that the kernel ``name`` writes in place
    (none for the others)."""
    return _flat(args[i] for i in WRITES.get(name, {}))


def returned(name: str, out) -> list:
    """The tensors of the kernel's result that are the ones it wrote, in
    the order of ``written``."""
    return _flat(kernels.written_result(out, w)
                 for w in WRITES.get(name, {}).values())


def in_place_times(name: str, kern, plain, args, kw) -> dict:
    """``kernel_times`` of a kernel that writes into its arguments, on
    clones of those. ``ring_append`` writes the same cells on every call,
    so its calls run back to back. Every other call first restores what
    it writes from a pristine copy (one ``torch._foreach_copy_``), so each
    call updates the same inputs; the same number of restores alone,
    timed the same way, is subtracted from ``ms`` and ``issue_ms``. A
    restore takes up to several times the kernel's own time and varies
    from graph to graph, so ``ms`` is the median of IN_PLACE_ROUNDS
    differences, the two graphs timed in turn."""
    work = work_args(name, args)
    if name in IDEMPOTENT:
        return kernel_times(lambda: kern(*work, **kw),
                            lambda: plain(*args, **kw))
    pristine, target = written(name, args), written(name, work)
    restore = lambda: torch._foreach_copy_(target, pristine)  # noqa: E731

    def call():
        restore()
        kern(*work, **kw)

    alone, diffs = [], []
    for _ in range(IN_PLACE_ROUNDS):
        alone.append(graph_ms(restore, 200))
        diffs.append(graph_ms(call, 200) - alone[-1])
    return dict(ms=float(np.median(diffs)), **issue_times(call, restore),
                plain_ms=time_ms(lambda: plain(*args, **kw), 20),
                restore_ms=float(np.median(alone)), rounds_ms=diffs)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def per_host_bytes(t: torch.Tensor, H: int) -> int:
    """Bytes of a per-host input that may be one value for every host."""
    if t.dim() == 0 or t.stride(0) == 0:
        return t.element_size()
    return t.element_size() * H


def flat_extract(out) -> list:
    """The tensors of an extraction: the dense window's, then the
    tail's."""
    return [*out.dense, *out.tail]


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
    if name == "window_sort":
        # the pool's four key columns read; s_k1 and perm over N written
        return bound(nbytes(*args[:4]) + nbytes(*out), 0)
    if name == "pool_merge":
        # each candidate's time read, but for a row behind its host's
        # cursor (empty by the cursor alone), and each cursor; the other
        # five columns of the C rows kept read (a row past C is never
        # read again); the next pool and the dropped count written
        blocks, C = args[0], int(args[1])
        reads = 0
        for b in blocks:
            n, cut = b.time.shape[0], getattr(b, "cut", None)
            if cut is not None:
                n -= int(cut.clamp(0, n // cut.shape[0]).sum())
                reads += nbytes(cut)
            reads += 8 * n
        row = 8 + 4 * 4 + 8 * blocks[0].payload.shape[-1]
        return bound(reads + C * (row - 8) + nbytes(*out), 0)
    if name == "extract_slots":
        s_k1, perm, p_t = args[0], args[1], args[2]
        H, Kc, PP = args[8], args[9], args[7].shape[1]
        N, C = s_k1.shape[0], p_t.shape[0]
        row = 8 + 3 * 4 + 8 * PP  # time, src, seq, kind, payload
        # every pool row in the window lands in the dense block with a
        # finite time, every filler there is NEVER
        n_dense = int((out.dense.time != NEVER).sum())
        # each sorted key and its source row; each pool row read once,
        # its dst only where it goes to the tail (a dense row's host is
        # its key), fillers made in registers; each dense row written,
        # and each tail row with its dst. Operations: a row's compare
        # with the row Kc before, the search over Kc keys, the place
        ops = N * (4 + max(Kc - 1, 1).bit_length())
        return bound(nbytes(s_k1, perm) + C * row + 4 * (C - n_dense)
                     + H * Kc * row + C * (row + 4), ops)
    if name == "phold_forward":
        n_send = int(out.stats[:, 1].sum())
        H, K = args[0].shape
        return bound(nbytes(*args) + nbytes(*out),
                     UNIFORM_OPS * (H * K + n_send))
    if name == "audit_commit":
        d_t, e_t, gid = args[0], args[1], args[4]
        n_valid = int(out.n_valid.sum())
        # every cell's time; the src and kind of the committed ones, and
        # their exec times where these are another tensor (the CPU model)
        ex = 0 if e_t is d_t else 8 * n_valid
        return bound(nbytes(d_t, gid, *args[5:]) + 8 * n_valid + ex
                     + nbytes(*out), 16 * n_valid)
    if name == "cpu_serialize":
        # every time read and every exec time written, a host's cost and
        # clock read and its clock written, the sum
        return bound(nbytes(*args[:3]) + nbytes(*out), 0)
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
    if name == "nic_tx":
        mask, now, dst, payload = args[0], args[1], args[2], args[11]
        H = mask.shape[0]
        rolled = out.deliver | out.drop
        control = payload[:, kernels.W_LEN] == 0
        n_draw = int((rolled & ~(now < kw["bootstrap_end"])
                      & ~control).sum())
        multi = args[14].shape[0] > 1
        # every host's mask, queued flag, gid, bucket, tx counters, draw
        # counter and its packet's protocol and length words; now and dst
        # (each may be one value for all); with several vertices its
        # vertex, its destination's vertex and its path's latency and
        # reliability, with one the one path's; the key pair of each host
        # that draws; the four run counters
        reads = (nbytes(mask, *args[3:11], args[17], *args[18]) + 8 * H
                 + per_host_bytes(now, H) + per_host_bytes(dst, H)
                 + (H * (4 + 4 + 8 + 4) if multi else 12) + 16 * n_draw)
        return bound(reads + nbytes(*out), UNIFORM_OPS * n_draw)
    if name == "nic_rx":
        H = args[0].shape[0]
        # every host's mask, src, gid, bucket, router ring head and tail,
        # CoDel interval and mode, now (may be one value for all) and its
        # packet's protocol and length words
        reads = (nbytes(*args[:3], *args[4:10], *args[11:])
                 + per_host_bytes(args[3], H) + 8 * H)
        return bound(reads + nbytes(*out), 0)
    if name == "nic_gate":
        # every host's two buckets, router ring head and tail and three
        # flags in, its gate out
        return bound(nbytes(*args) + nbytes(out), 0)
    if name in ("qdisc_enqueue", "qdisc_dequeue"):
        return bound(qdisc_bytes(name, args, kw["spec"], out), 0)
    raise ValueError(name)


def qdisc_bytes(name: str, args, spec, out) -> int:
    """The bytes K22 or K23 must move on this call: every cell of the
    plane the call changes read and written once (a slot: its payload
    words, dst, rank, seq and enqueue time, and Eiffel's bucket), each
    host's depth read (PIFO: q_len; Eiffel: its valid flags) and its
    outputs written; for the hosts with a packet offered (K22) or asked
    for (K23), the per-host inputs and, for PIFO's K22, the ranks of the
    queued packets it compares, for Eiffel's K23 the valid flags,
    buckets and seqs of the row it scans."""
    fields = dict(zip(spec.names, args[0]))
    H, Q, P = fields["q_payload"].shape
    moved = 0
    for n, before, after in zip(spec.names, args[0], out.fields):
        diff = before != after
        cell = before.element_size() * (P if before.dim() == 3 else 1)
        if before.dim() == 3:
            diff = diff.any(dim=2)
        moved += 2 * cell * int(diff.sum())
    depth = nbytes(fields["q_valid"] if spec.eiffel else fields["q_len"])
    if name == "qdisc_enqueue":
        mask, dst, payload, now = args[1:5]
        n = int(mask.sum())
        reads = nbytes(mask) + n * (4 * P + 4 + 8 + 4)  # packet, dst, now, cls
        if not spec.eiffel:
            queued = torch.where(mask, fields["q_len"], 0)
            reads += 8 * int(queued.sum())
        return moved + depth + reads + nbytes(out.ok)
    now, want = args[1:3]
    n = int(want.sum())
    reads = nbytes(want) + 8 * n
    if spec.eiffel:
        reads += n * Q * (1 + 8 + 8)
    return moved + depth + reads + nbytes(out.have, out.payload, out.dst)


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

    # K19: the window's first sort, its keys built from the pool's columns
    pool, C = st.pool, st.pool.capacity
    wargs = (pool.time, pool.dst, pool.src, pool.seq, ws, we, H, K)
    keys = kernels.window_sort_plain(*wargs)
    err = max_abs_err(kernels.window_sort(*wargs), keys)
    results["window_sort"] = dict(
        err=err, bound=kernel_bound("window_sort", wargs, {}, keys),
        shape=f"C={C} H={H} Kc={K} N={keys[0].shape[0]}",
        library_ms=library_ms("window_sort", wargs),
        **kernel_times(lambda: kernels.window_sort(*wargs),
                       lambda: kernels.window_sort_plain(*wargs)),
    )

    # K3: extract_slots places the rows of the window's first sort
    xargs = (*keys, pool.time, pool.dst, pool.src, pool.seq, pool.kind,
             pool.payload, H, K)
    N = xargs[0].shape[0]
    want = kernels.extract_slots_plain(*xargs)
    err = max_abs_err(flat_extract(kernels.extract_slots(*xargs)),
                      flat_extract(want))
    results["extract_slots"] = dict(
        err=err, bound=kernel_bound("extract_slots", xargs, {}, want),
        shape=f"N={N} C={C} Kc={K}",
        **kernel_times(lambda: kernels.extract_slots(*xargs),
                       lambda: kernels.extract_slots_plain(*xargs)),
    )

    # K1 / K2 on the window's dense matrix
    dense, tail = engine.dense_extract(st.pool, ws, we, H, K,
                                       kernels.PLAIN_OPS)
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
    # the CPU model is off: the exec times are the times, one tensor
    cargs = (dense.time, dense.time, dense.src, dense.kind, h.gid,
             ob.host_digest, ob.host_events, ob.host_last_t, h.done_t)
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

    # K20: the window's merge of the tail and the emissions
    margs = ([tail, fw], C)
    want = kernels.pool_merge_plain(*margs)
    err = max_abs_err(kernels.pool_merge(*margs), want)
    results["pool_merge"] = dict(
        err=err, bound=kernel_bound("pool_merge", margs, {}, want),
        shape=(f"M={tail.time.shape[0] + fw.time.shape[0]} C={C} "
               f"live={int((want.time != NEVER).sum())} "
               f"dropped={int(want.dropped)}"),
        library_ms=library_ms("pool_merge", margs),
        **kernel_times(lambda: kernels.pool_merge(*margs),
                       lambda: kernels.pool_merge_plain(*margs)),
    )
    for name, r in results.items():
        lib = ("" if "library_ms" not in r else
               f" library_ms={r['library_ms']:.6f} (torch.sort)")
        print(f"[{card}] phase 3 {name}: {r['shape']} max_abs_err="
              f"{r['err']} kernel_ms={r['ms']:.6f} issue_ms="
              f"{r['issue_ms']:.6f} (rounds {issue_rounds(r)}) "
              f"plain_ms={r['plain_ms']:.6f}{lib} "
              f"bound_ms={r['bound'][0]:.6f} "
              f"({r['bound'][1]})", flush=True)
        if r["err"] != 0:
            fail(f"{name} disagrees with its plain version on the card")

    # the device launches of one dense_extract and of one merge, through
    # the kernels and as the parent ran them (the two torch sorts and
    # their gathers before extract_slots; the merge's cat, sort and
    # gathers)
    parent = kernels.KERNEL_OPS._replace(
        window_sort=kernels.window_sort_plain,
        pool_merge=kernels.pool_merge_plain)
    calls = {
        "dense_extract": lambda: engine.dense_extract(pool, ws, we, H, K),
        "dense_extract parent": lambda: engine.dense_extract(
            pool, ws, we, H, K, parent),
        "merge": lambda: engine.merge(tail, fw, C),
        "merge parent": lambda: engine.merge(tail, fw, C, parent),
    }
    prof = {k: device_profile(f) for k, f in calls.items()}
    print(f"[{card}] phase 3 device launches (torch.profiler: kernels, "
          f"copies, sets) and their device ms, one call each: "
          + json.dumps({k: {"launches": n, "device_ms": round(ms, 6)}
                        for k, (n, ms, _) in prof.items()}), flush=True)
    print(f"[{card}] phase 3 device us and launches by entry function, "
          f"one call each: " + json.dumps(
              {k: by_entry(prof[k][2]) for k in ("dense_extract", "merge")}),
          flush=True)

    # the window step's parts, on the same window (no kernel count kept)
    parts = {
        "window_keys (window_sort)": lambda: kernels.window_sort(*wargs),
        "window_keys parent (2 sorts + gathers)":
            lambda: kernels.window_sort_plain(*wargs),
        "dense_extract (all of extract)": calls["dense_extract"],
        "phold_forward": lambda: kernels.phold_forward(*fargs, **fkw),
        "audit_commit": lambda: kernels.audit_commit(*cargs),
        "merge (pool_merge)": calls["merge"],
        "merge parent (1 sort + gathers)": calls["merge parent"],
        f"torch.sort stable int64 N={N}": lambda: torch.sort(
            xargs[0], stable=True),
    }
    parts_ms = {k: time_ms(f, 20) for k, f in parts.items()}
    # each call's issue time under inference_mode, as Simulation.run
    # calls them
    with torch.inference_mode():
        issue = {
            "window_sort": issue_times(lambda: kernels.window_sort(*wargs)),
            "extract_slots": issue_times(
                lambda: kernels.extract_slots(*xargs)),
            "pool_merge": issue_times(lambda: kernels.pool_merge(*margs)),
        }
    for k, r in issue.items():
        parts_ms[f"{k} issue under inference_mode"] = r["issue_ms"]
    print(f"[{card}] phase 3 window breakdown (ms): "
          + json.dumps({k: round(v, 6) for k, v in parts_ms.items()})
          + " (issue rounds: " + "; ".join(
              f"{k} {issue_rounds(r)}" for k, r in issue.items()) + ")",
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
    if name == "window_sort":
        return int((args[0] < args[5]).sum())  # rows before the window end
    if name == "pool_merge":
        return int((out.time != NEVER).sum())  # live rows kept
    if name == "extract_slots":
        return int((out.dense.time != NEVER).sum())  # events extracted
    if name == "audit_commit":
        return int(out.n_valid.sum())  # events committed
    if name == "phold_forward":
        return int(out.stats[:, 1].sum())  # messages sent
    if name == "cpu_serialize":
        return int((args[0] != NEVER).sum())  # events serialized
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
    if name in ("nic_tx", "nic_rx"):
        return int(args[0].sum())  # packets offered, packets arrived
    if name == "nic_gate":
        return int(out.sum())  # extra arrivals granted
    if name == "qdisc_enqueue":
        return int(args[1].sum())  # packets offered
    if name == "qdisc_dequeue":
        return int(out.have.sum())  # packets handed up
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


def kept(pre, args) -> tuple:
    """A kept call's arguments: ``pre``, the copies ``work_args`` made
    before the call of what the kernel itself writes in place, and copies
    of the rest, made just after the call, before a later in-place kernel
    writes into a tensor the call read (``loop_select`` reads the boxes
    that ``loop_route`` writes; ``codel_dequeue`` and ``send_dequeue``
    the rings that ``ring_append`` writes; ``tcp_demux``, ``tcp_ack``,
    ``tcp_reorder`` and ``tcp_out`` fields of the TCP table that the
    others write)."""
    return tuple(clone_arg(p) if p is a else p for p, a in zip(pre, args))


def clone_boxes(boxes: kernels.Boxes) -> kernels.Boxes:
    return kernels.Boxes(*(x.clone() for x in boxes))


def capture_ops(best: dict, names=LOOP_PATH,
                branches: dict | None = None) -> kernels.WindowOps:
    """The kernel wrappers, keeping for each kernel of ``names`` the
    arguments of its busiest call (``best[name] = (score, args, kw)``),
    and counting in ``branches`` the calls that took each TCP branch."""
    def wrap(name, fn):
        def call(*args, **kw):
            pre = work_args(name, args)
            out = fn(*args, **kw)
            score = activity(name, args, out)
            if name not in best or score > best[name][0]:
                best[name] = (score, kept(pre, args), kw)
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
    twice from one saved state (a snapshot: its own copy of the rings and
    boards the in-place kernels write), first timed alone, then under
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
    rows = device_rows(prof)
    busy_s = sum(r[0] for r in rows) / 1e6
    ours = port_kernels(rows)
    n_dev = sum(r[2] for r in rows)
    n_ours = sum(n for _, n in ours.values())
    print(f"[{card}] {label} [{first}, {until}): micro_steps={steps} "
          f"wall_s={wall:.4f} alone, {wall_prof:.4f} under the profiler; "
          f"device launches (kernels, copies and sets) {n_dev}: "
          f"device_launches_per_micro_step={n_dev / max(steps, 1):.2f}, "
          f"the port's kernels {n_ours / max(steps, 1):.2f}; "
          f"device busy (kernels and copies) {busy_s:.4f} s: busy_share="
          f"{busy_s / wall:.4f} of the wall alone, "
          f"{busy_s / wall_prof:.4f} of the profiled wall; top device "
          f"time (us, launches): " + json.dumps(
              [[k[:60], round(us, 1), n] for us, k, n in rows[:12]])
          + "; the port's kernels (us, launches): " + json.dumps(
              {k: [round(us, 1), n] for k, (us, n) in sorted(
                  ours.items(), key=lambda kv: -kv[1][0])}),
          flush=True)


def device_rows(prof) -> list:
    """(device us, name, launches) of each kernel, copy or set a profile
    traced, the most time first (kernels only: an operator's device time
    is its kernels')."""
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
        if dev_us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((dev_us, e.key, e.count))
    rows.sort(reverse=True)
    return rows


def device_profile(fn) -> tuple:
    """(device launches (kernels, copies, sets), their device ms, the
    profile's rows (``device_rows``)) of one call of fn, warmed, from
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = device_rows(prof)
    return sum(r[2] for r in rows), sum(r[0] for r in rows) / 1e3, rows


def by_entry(rows) -> dict:
    """{entry function (or the copy's or set's name): [device us,
    launches]} of a profile's rows."""
    out: dict = {}
    for us, key, n in rows:
        m = re.search(r"\w+_kernel\b", key)
        t = out.setdefault(m.group(0) if m else key[:40], [0.0, 0])
        t[0] = round(t[0] + us, 3)
        t[1] += n
    return out


def port_kernels(rows) -> dict:
    """{kernel: [device us, launches]} of the port's kernels among a
    profile's rows ((device us, entry function's name, launches))."""
    ours: dict = {}
    for us, key, n in rows:
        m = re.search(r"(\w+)_kernel\b", key)
        name = m and ENTRIES.get(m.group(1), m.group(1))
        if name in REPLACES:
            t = ours.setdefault(name, [0.0, 0])
            t[0] += us
            t[1] += n
    return ours


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
        work = work_args(name, args)  # an in-place kernel takes clones
        got = kern(*work, **kw)
        want = plain(*args, **kw)
        torch.cuda.synchronize()
        extra = ""
        if name in WRITES:
            cells = check_in_place(phase, label, args, work, got, want)
            extra = f" in_place cells_written={cells}"
        if name == "loop_route":
            err = max(max_abs_err(got.boxes, want.boxes),
                      max_abs_err(got[1:], want[1:]))
        elif name in ("spec_check", "nic_gate"):
            err = max_abs_err([got], [want])
        elif name == "extract_slots":
            err = max_abs_err(flat_extract(got), flat_extract(want))
        elif name in ("tcp_ack", "tcp_out", "qdisc_enqueue",
                      "qdisc_dequeue"):
            err = max(max_abs_err(got.fields, want.fields),
                      max_abs_err(got[1:], want[1:]))
        else:
            err = max_abs_err(got, want)
        if name == "codel_dequeue":
            n = int(want.dropped.sum())
            extra = f" codel_drops={n}"
            if "drop mode" in label and n == 0:
                fail(f"{phase}: the synthetic drop-mode state dropped none")
        if name == "extract_slots":
            extra = f" N={args[0].shape[0]} C={args[2].shape[0]} Kc={args[9]}"
        if name == "window_sort":
            extra = (f" C={args[0].shape[0]} H={args[6]} Kc={args[7]} "
                     f"N={got[0].shape[0]}")
        if name == "pool_merge":
            extra = (f" blocks={len(args[0])} M="
                     f"{sum(b.time.shape[0] for b in args[0])} C={args[1]} "
                     f"dropped={int(want.dropped)}")
        if name in BRANCHES:
            hosts = {b: int(((want.flags >> bit) & 1).sum())
                     for b, bit in BRANCHES[name].items()}
            extra += f" hosts_by_branch={json.dumps(hosts)}"
            if "synthetic" in label and not all(hosts.values()):
                fail(f"{phase}: {label} misses a branch: {hosts}")
        b = kernel_bound(name, args, kw, want)
        times = (in_place_times(name, kern, plain, args, kw)
                 if name in WRITES else
                 kernel_times(lambda: kern(*args, **kw),
                              lambda: plain(*args, **kw)))
        results[label] = dict(err=err, bound=b, **times)
        r = results[label]
        if name in SORTS:
            r["library_ms"] = library_ms(name, args)
            extra += f" library_ms={r['library_ms']:.6f} (torch.sort)"
        print(f"[{card}] {phase} {label}: max_abs_err={err}{extra} "
              f"kernel_ms={r['ms']:.6f} issue_ms={r['issue_ms']:.6f} "
              f"(rounds {issue_rounds(r)}) "
              f"plain_ms={r['plain_ms']:.6f} bound_ms={b[0]:.6f} ({b[1]})"
              + (f" restore_ms={r['restore_ms']:.6f} (subtracted; rounds "
                 + " ".join(f"{x:.6f}" for x in r["rounds_ms"]) + ")"
                 if "restore_ms" in r else ""), flush=True)
        if err != 0:
            fail(f"{label} disagrees with its plain version on the card")
    return results


# the two sorts, which have one torch.sort call as their yardstick
SORTS = ("window_sort", "pool_merge")


def sort_keys(name: str, args) -> torch.Tensor:
    """The keys of the one ``torch.sort(stable=True)`` beside a sort: the
    k1 column of window_sort's N rows (pool rows and fillers; the JAX
    package's second key is a second sort that this leaves out), or the
    time of every candidate row of the merge."""
    if name == "window_sort":
        return kernels.window_sort_keys(*args)[0]
    return torch.cat([kernels.block_rows(b)[0] for b in args[0]])


def library_ms(name: str, args) -> float:
    """``library_ms``: one ``torch.sort(stable=True)`` of the sort's keys,
    CUDA events over 20 calls back to back, warmed."""
    keys = sort_keys(name, args)
    return time_ms(lambda: torch.sort(keys, stable=True), 20)


def check_in_place(phase: str, label: str, args, work, got, want) -> int:
    """An in-place kernel's call on clones (``work``) of its inputs
    (``args``): it returned the very tensors it was given, and every cell
    its plain version leaves as it was is as it was. Returns the cells
    it wrote."""
    name = label.split()[0]
    ins, mine = written(name, args), written(name, work)
    outs, plains = returned(name, got), returned(name, want)
    if len(outs) != len(mine) or any(o is not w for o, w in zip(outs, mine)):
        fail(f"{phase} {label}: the kernel returned other tensors than the "
             f"ones it was given")
    cells = 0
    for before, after, plain in zip(ins, mine, plains):
        same = plain == before
        if not torch.equal(after[same], before[same]):
            fail(f"{phase} {label}: the kernel wrote a cell its plain "
                 f"version leaves as it was")
        cells += int((after != before).sum())
    return cells


def phase_loop_kernels(card: str) -> dict:
    """Phase 6: every kernel of the loop path on a real config-2 window,
    and the flood's device time by kernel over a few windows."""
    sim = build_simulation(CONFIG2)
    sim.run(until=2_000_000_000)
    best: dict = {}
    sim.ops = capture_ops(best, CONFIG2_PATH)
    # the clients all send on one 20 ms grid and the path takes 10 ms, so
    # a window holds either the sends or the arrivals: take two
    first = sim._frontier(sim.stop_time).mn
    for _ in range(2):
        mn, occ, _, _ = sim._frontier(sim.stop_time)
        we = min(mn + sim.runahead, sim.stop_time)
        sim.step_loop(mn, we, occ)
    print(f"[{card}] phase 6 inputs: the busiest call of each kernel in "
          f"the config-2 windows [{first}, {we}), H={sim.num_hosts} "
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


def flood_run(card: str, ops, label: str, cfg: dict = CONFIG2,
              until: int | None = None, stepwise: bool = False):
    """``cfg`` built and run through ``ops`` with ``run`` (``run_stepwise``
    with ``stepwise``) to ``until``, its launches counted from 0."""
    t0 = time.perf_counter()
    sim = build_simulation(cfg)
    sim.ops = ops
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    kernels.reset_launches()
    windows = (sim.run_stepwise if stepwise else sim.run)(until)
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
          f"cpu_delay_applied={c['cpu_delay_applied']} "
          f"cpu_avail_max={int(sim.state.host.cpu_avail.max())} "
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


def _three_vertex_paths(rs, H: int):
    """synthetic_link_send's three vertices (one pair unreachable, loss up
    to 0.5), its bootstrap end, each host's vertex, key pair and draw
    counter."""
    ms = 1_000_000
    lat = np.array([[10, 40, NEVER], [40, 20, 60], [NEVER, 60, 30]])
    lat = np.where(lat == NEVER, NEVER, lat * ms).astype(np.int64)
    rel = np.array([[0.5, 0.9, 1.0], [0.9, 0.5, 0.75], [1.0, 0.75, 0.5]],
                   np.float32)
    keys = np.stack([rs.integers(0, 2**32, H, dtype=np.int64)
                     for _ in range(2)], axis=1)
    return (lat, rel, 1_000 * ms, (np.arange(H) % 3).astype(np.int32), keys,
            rs.integers(0, 2**32, H, dtype=np.int64))


def _buckets(rs, now, H: int):
    """Token buckets at ``now`` [H]: in debt, below and above an MTU, last
    refilled 0 to 3 grid ticks ago or long ago (the refill product wraps
    on NEVER lanes), or at a tick past ``now``'s."""
    refill = rs.integers(1, 200_000, H)
    now_tick = np.where(now == NEVER, rs.integers(0, 3_000, H),
                        now // 1_000_000)
    tick = now_tick - np.select(
        [rs.random(H) < 0.6, rs.random(H) < 0.5],
        [rs.integers(0, 4, H), rs.integers(4, 10**6, H)], -1)
    return (rs.integers(-100_000, 3_000, H), np.maximum(tick, 0), refill,
            refill + 1500)


def _packets(rs, H: int, P: int = 12) -> np.ndarray:
    """[H, P] packet words: UDP and TCP, control packets (length 0)."""
    pl = rs.integers(-2**31, 2**31, (H, P)).astype(np.int32)
    pl[:, 0] = rs.choice([17, 6], H)
    pl[:, 3] = np.where(rs.random(H) < 0.15, 0, rs.integers(1, 1461, H))
    return pl


def synthetic_nic_tx(H: int, device, seed: int = 41):
    """Arguments of nic_tx: synthetic_link_send's three vertices (one
    pair unreachable, loss up to 0.5), buckets in debt and refilled over
    idle gaps, NEVER ``now`` on unmasked lanes, hosts on both sides of the
    end of bootstrap, queued NICs, loopback and control packets, and
    destinations outside [0, H) on the hosts that send nothing."""
    rs = np.random.default_rng(seed)
    lat, rel, boot, vertex, keys, counter = _three_vertex_paths(rs, H)
    ms = 1_000_000
    mask = rs.random(H) < 0.8
    gid = np.arange(H, dtype=np.int32)
    now = rs.integers(boot - 20 * ms, boot + 200 * ms, H)
    now[~mask & (rs.random(H) < 0.5)] = NEVER
    dst = np.where(mask, np.where(rs.random(H) < 0.1, gid,
                                  rs.integers(0, H, H)),
                   rs.integers(-2 * H, 2 * H, H)).astype(np.int32)
    rem, tick, refill, cap = _buckets(rs, now, H)
    cols = (mask, now, dst, rs.random(H) < 0.2, gid, rem, tick, refill, cap,
            rs.integers(0, 10**9, H), rs.integers(0, 10**12, H),
            _packets(rs, H), vertex, vertex, lat, rel, keys, counter)
    counters = [torch.tensor(int(c), device=device)
                for c in rs.integers(0, 10**9, 4)]
    return tuple(torch.as_tensor(np.asarray(a), device=device)
                 for a in cols) + (counters,), {"bootstrap_end": boot}


def synthetic_nic_rx(H: int, device, seed: int = 43, Q: int = 16):
    """Arguments of nic_rx: loopback and remote arrivals, NEVER ``now`` on
    unmasked lanes, both sides of the end of bootstrap, buckets in debt
    and refilled over idle gaps, router rings empty, part full, full and
    with their counters across the int32 wrap, CoDel in and out of drop
    mode."""
    rs = np.random.default_rng(seed)
    boot, ms = 1_000_000_000, 1_000_000
    mask = rs.random(H) < 0.8
    gid = np.arange(H, dtype=np.int32)
    src = np.where(rs.random(H) < 0.1, gid,
                   rs.integers(0, H, H)).astype(np.int32)
    now = rs.integers(boot - 20 * ms, boot + 200 * ms, H)
    now[~mask & (rs.random(H) < 0.5)] = NEVER
    rem, tick, refill, cap = _buckets(rs, now, H)
    head = np.where(rs.random(H) < 0.1, rs.integers(2**31 - 20, 2**31, H),
                    rs.integers(0, 2**30, H))
    n = np.select([rs.random(H) < 0.5, rs.random(H) < 0.5], [0, Q],
                  rs.integers(1, Q, H))
    cols = (mask, src, gid, now, rem, tick, refill, cap, _wrap32(head),
            _wrap32(head + n), _packets(rs, H),
            np.where(rs.random(H) < 0.3, 0, rs.integers(1, 10**10, H)),
            rs.random(H) < 0.4)
    return tuple(torch.as_tensor(np.asarray(a), device=device)
                 for a in cols), {"slots": Q, "bootstrap_end": boot}


def synthetic_nic_gate(H: int, device, seed: int = 47, free: bool = False,
                       G: int = 8):
    """Arguments of nic_gate: both buckets in debt, below and above
    several MTUs, refilled to the window start over idle gaps; router
    rings and NIC queues empty and not, pumps armed and not."""
    rs = np.random.default_rng(seed)
    ws = 2_500_000_000 + int(rs.integers(0, 10**6))
    now = np.full(H, ws)
    rx, tx = _buckets(rs, now, H), _buckets(rs, now, H)
    rx = (rs.integers(-20_000, 20_000, H), *rx[1:])
    head = rs.integers(0, 2**30, H)
    cols = (*rx, *tx, _wrap32(head),
            _wrap32(head + (rs.random(H) < 0.1)), rs.random(H) < 0.1,
            rs.random(H) < 0.1, rs.random(H) < 0.1)
    return tuple(torch.as_tensor(np.asarray(a), device=device)
                 for a in cols), {"win_start": ws, "free": free, "G": G}


def synthetic_select(H: int, K: int, B: int, O: int, PP: int, G: int,
                     need_by_kind, device, seed: int = 37,
                     bulk_kind: int = 0):
    """A micro-step's selection inputs at any width, made with numpy in
    bulk (as ``tests/test_torch_cuda.py:random_select_inputs`` makes them
    host by host): dense rows sorted by (time, src, seq) with ties, cells
    past the window and NEVER fillers, sources that are the host itself,
    mostly the bulk kind; inboxes a quarter full whose free slots keep
    stale src and seq (the first four hosts' all free); outboxes empty to
    full; gates; and a pool budget that lets about the first half of the
    hot hosts in. Returns (the wrapper's positional arguments, its
    keyword arguments)."""
    rs = np.random.default_rng(seed)
    Kc = K + 1
    ws, we = 1_000_000_000, 1_010_000_000
    need_by_kind = np.asarray(
        need_by_kind.cpu() if torch.is_tensor(need_by_kind)
        else need_by_kind, np.int32)
    NK = need_by_kind.shape[0]
    hosts = np.arange(H)
    live = np.arange(Kc)[None, :] < rs.integers(0, Kc + 1, H)[:, None]
    t = ws + rs.integers(0, 5, (H, Kc)) * 2_500_000  # some at we
    src = np.where(rs.random((H, Kc)) < 0.3, hosts[:, None],
                   rs.integers(0, H, (H, Kc)))
    seq = rs.integers(0, 50, (H, Kc))
    t, src, seq = (np.where(live, x, v) for x, v in
                   ((t, NEVER), (src, 0), (seq, 0)))
    order = np.lexsort((seq, src, t), axis=-1)
    d_t, d_s, d_q = (np.take_along_axis(x, order, axis=1)
                     for x in (t, src, seq))
    d_t[d_t >= we] = NEVER
    d_k = np.where(rs.random((H, Kc)) < 0.8, bulk_kind,
                   rs.integers(0, NK, (H, Kc)))
    i_t = np.where(rs.random((H, B)) < 0.75, NEVER,
                   ws + rs.integers(2, 4, (H, B)) * 2_500_000)
    i_t[:4] = NEVER  # empty inboxes: stale keys compete at NEVER
    o_count = np.minimum(rs.integers(0, O + 4, H), O) * (rs.random(H) < 0.5)
    i32 = np.int32
    cols = (d_t.astype(np.int64), d_s.astype(i32), d_q.astype(i32),
            d_k.astype(i32),
            rs.integers(-2**62, 2**62, (H, Kc, PP), dtype=np.int64),
            rs.integers(0, K + 1, H).astype(i32), i_t.astype(np.int64),
            rs.integers(0, H, (H, B)).astype(i32),
            rs.integers(0, 50, (H, B)).astype(i32),
            rs.integers(0, NK, (H, B)).astype(i32),
            rs.integers(-2**62, 2**62, (H, B, PP), dtype=np.int64),
            o_count.astype(i32), rs.integers(0, G, H).astype(i32),
            hosts.astype(i32), need_by_kind)
    box_used = int(o_count.sum() + (i_t != NEVER).sum())
    kw = dict(K=K, G=G, O=O, bulk_kind=bulk_kind, self_excluded=True,
              win_end=we, pool_budget=box_used + H // 2)
    return tuple(torch.as_tensor(a, device=device) for a in cols), kw


I64_MAX = np.iinfo(np.int64).max
I64_MIN = np.iinfo(np.int64).min
QDISC_WEIGHTS = [1, 2.5, 4]
QDISC_SHAPING = {0: 200_000, 2: 3_000_000}
# every discipline with every ranker, each discipline with every drop
# policy and shaping on and off; chip_smoke.py's two paths last
QDISC_CASES = [("pifo", "fifo", False, "none"), ("pifo", "prio", True, "red"),
               ("pifo", "wfq", False, "codel"),
               ("eiffel", "fifo", True, "codel"),
               ("eiffel", "prio", False, "none"),
               ("eiffel", "wfq", True, "red"), ("pifo", "wfq", True, "red"),
               ("eiffel", "wfq", False, "codel")]


class _QdiscStack:
    """What a discipline's ``attach`` reads of the network stack."""

    def __init__(self, H, device, P=12):
        self.num_hosts, self.payload_words = H, P
        self.sockets_per_host, self.device = 8, device


def qdisc_discipline(disc, rank, shaped, drop, H, Q, device, C=3, B=4,
                     modules=None):
    """A discipline built as ``sim.py`` builds one, attached to H hosts;
    ``modules`` = (ranks, drops, pifo class, eiffel class), the port's
    by default."""
    if modules is None:
        from shadow_tpu_torch.net.qdisc import drops, ranks
        from shadow_tpu_torch.net.qdisc.eiffel import EiffelDiscipline
        from shadow_tpu_torch.net.qdisc.pifo import PifoDiscipline

        modules = (ranks, drops, PifoDiscipline, EiffelDiscipline)
    ranks_m, drops_m, pifo_c, eiffel_c = modules
    weights = (QDISC_WEIGHTS * C)[:C]
    shaping = ({c: b for c, b in QDISC_SHAPING.items() if c < C}
               if shaped else None)
    kw = dict(queue_slots=Q, drop=drop,
              ranker=ranks_m.make_ranker(rank, classes=C, weights=weights,
                                         shaping=shaping),
              red=(drops_m.RedConfig(Q, 0.25, 0.75, 0.3) if drop == "red"
                   else None),
              host_class=np.random.default_rng(5).integers(-1, C, H))
    d = (eiffel_c(buckets=B, bucket_width=300, **kw) if disc == "eiffel"
         else pifo_c(**kw))
    d.attach(_QdiscStack(H, device))
    return d


def synthetic_qdisc_plane(rs, disc: str, now: int, H: int, Q: int, C: int = 3,
                       B: int = 4, P: int = 12, extreme: bool = False):
    """A plane in mid-run, {field: numpy array}: a quarter of the rows
    empty, a quarter full, the rest 1 to Q - 1 deep (pifo: a sorted
    prefix with ties and stale cells past it; eiffel: valid slots
    anywhere, buckets around the service bucket), sojourns across CoDel's
    target, RED's average across its thresholds, drop mode and intervals
    armed or not. ``extreme``: ranks, virtual times and finish times
    near the int64 limits (sums past them wrap)."""
    kind = rs.integers(0, 4, H)
    n = np.where(kind == 0, 0, np.where(kind == 1, Q, rs.integers(
        1, max(Q, 2), H)))
    n = np.minimum(n, Q)
    pl = np.zeros((H, Q, P), np.int32)
    pl[..., 0] = np.where(rs.random((H, Q)) < 0.8, 17, 6)
    pl[..., 3] = rs.integers(0, 1473, (H, Q))
    pl[..., 4] = rs.integers(-5, 5, (H, Q))
    pl[..., 10] = rs.integers(-9, 9, (H, Q))
    pl[..., 11] = rs.integers(-2**31, 2**31 - 1, (H, Q))
    top = (I64_MAX - 2**40) if extreme else 40_000
    rank = np.sort(rs.integers(-top if extreme else 0, top, (H, Q)), axis=1)
    if extreme:
        rank[:, :Q // 3] = I64_MIN + rs.integers(0, 3, (H, Q // 3))
        rank[:, Q - Q // 3:] = I64_MAX - rs.integers(0, 3, (H, Q // 3))
        rank = np.sort(rank, axis=1)
    if disc == "eiffel":
        valid = rs.random((H, Q)) < n[:, None] / Q
        rank = rs.permuted(rank, axis=1)
    else:
        valid = np.arange(Q)[None, :] < n[:, None]
    wire = (pl[..., 3] + np.where(pl[..., 0] == 6, 40, 28)).astype(np.int64)
    age = np.where(rs.random((H, Q)) < 0.4, rs.integers(0, 9_000_000, (H, Q)),
                   rs.integers(10_000_000, 400_000_000, (H, Q)))
    vt = (I64_MAX - rs.integers(0, 2**20, H)) if extreme else rs.integers(
        0, 20_000, H)
    fin = (I64_MAX - rs.integers(0, 2**20, (H, C))) if extreme else (
        rs.integers(0, 40_000, (H, C)))
    ms = 1_000_000
    qd = dict(
        q_payload=pl, q_dst=rs.integers(0, H, (H, Q)).astype(np.int32),
        q_rank=rank.astype(np.int64),
        q_seq=np.cumsum(rs.integers(1, 3, (H, Q)), axis=1).astype(np.int64),
        q_enq_ts=(now - age).astype(np.int64),
        q_bytes=np.where(valid, wire, 0).sum(axis=1),
        seq=rs.integers(2 * Q, 3 * Q, H).astype(np.int64),
        cls=rs.integers(-1, C, H).astype(np.int32),
        vtime=vt.astype(np.int64), finish=fin.astype(np.int64),
        shape_next=(now + rs.integers(-50 * ms, 50 * ms, (H, C))).astype(
            np.int64),
        drop_mode=rs.random(H) < 0.5,
        interval_expire=np.where(rs.random(H) < 0.3, 0, now + rs.integers(
            -200 * ms, 50 * ms, H)).astype(np.int64),
        next_drop=(now + rs.integers(-100 * ms, 50 * ms, H)).astype(
            np.int64),
        drop_count=rs.integers(0, 40, H).astype(np.int32),
        drop_count_last=rs.integers(0, 40, H).astype(np.int32),
        red_avg=rs.integers(0, (Q << 8) + 1, H).astype(np.int64),
        red_count=rs.integers(0, 8, H).astype(np.int64),
        **{k: rs.integers(0, 100, H).astype(np.int64) for k in (
            "enqueues", "dequeues", "drops_overflow", "drops_red",
            "drops_codel", "sojourn_sum", "depth_peak")},
    )
    if disc == "eiffel":
        qd.update(q_valid=valid,
                  q_bucket=rs.integers(0, B, (H, Q)).astype(np.int64),
                  cur_bucket=rs.integers(0, B, H).astype(np.int64))
    else:
        qd["q_len"] = n.astype(np.int32)
    return qd


def synthetic_qdisc_packets(rs, now: int, H: int, P: int = 12):
    """(mask, dst, payload, now) of an enqueue: UDP and TCP packets,
    sockets and priorities of both signs, NEVER where unmasked."""
    pl = np.zeros((H, P), np.int32)
    pl[:, 0] = np.where(rs.random(H) < 0.8, 17, 6)
    pl[:, 3] = rs.integers(0, 1473, H)
    pl[:, 4] = rs.integers(-5, 5, H)
    pl[:, 10] = rs.integers(-9, 9, H)
    mask = rs.random(H) < 0.75
    return (mask, rs.integers(0, H, H).astype(np.int32), pl,
            np.where(mask, now, NEVER).astype(np.int64))



def compiler_view(reports: dict) -> dict:
    """{kernel: {entry function: registers, shared memory bytes, spill
    bytes (stores + loads)}} of the matrix path's extract_slots and
    phold_forward, the micro-step's two kernels, the in-place net-stack
    kernels, the NIC's admission kernels, the window's two sorts, the CPU
    model and the device-queue disciplines' two kernels, from nvcc's
    -Xptxas -v reports."""
    view = {}
    for name in ("extract_slots", "phold_forward", "loop_select",
                 "loop_route", "ring_append", "tcp_ack",
                 "tcp_reorder", "tcp_out", "nic_tx", "nic_rx", "nic_gate",
                 "window_sort", "pool_merge", "cpu_serialize",
                 "qdisc_enqueue", "qdisc_dequeue"):
        funcs, cur = {}, None
        for ln in reports[name].splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", ln)
            if m:
                # the last name of the mangled one, and its template B
                short = re.findall(r"\d+([a-z][a-z_]*_kernel)(?:ILi(\d+)E)?",
                                   m.group(1))
                fn, b = short[-1] if short else (m.group(1), "")
                cur = f"{fn}<{b}>" if b else fn
                funcs[cur] = {"registers": None, "smem": 0, "spill": 0}
            elif cur is not None:
                m = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                              r"spill loads", ln)
                if m:
                    funcs[cur]["spill"] = int(m.group(1)) + int(m.group(2))
                m = re.search(r"Used (\d+) registers", ln)
                if m:
                    funcs[cur]["registers"] = int(m.group(1))
                m = re.search(r"(\d+) bytes smem", ln)
                if m:
                    funcs[cur]["smem"] = int(m.group(1))
        view[name] = funcs
    return view


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
    best4["nic_tx (synthetic lossy)"] = (0, *synthetic_nic_tx(H, sim.device))
    best4["nic_rx (synthetic rings)"] = (0, *synthetic_nic_rx(H, sim.device))
    best4["nic_gate (synthetic debt)"] = (
        0, *synthetic_nic_gate(H, sim.device))
    best4["nic_gate (synthetic bootstrap)"] = (
        0, *synthetic_nic_gate(H, sim.device, free=True))
    # loop_select at bench.py:stage_udp_flood_100k's width, at config
    # 4's K, B, O, G and PP
    _, sa, skw = best4["loop_select"]
    wide = f"loop_select (synthetic H={SELECT_WIDE})"
    best4[wide] = (0, *synthetic_select(
        SELECT_WIDE, skw["K"], sa[6].shape[1], skw["O"], sa[4].shape[-1],
        skw["G"], sa[14], sim.device, bulk_kind=skw["bulk_kind"]))
    del sim
    res4 = compare_calls(card, "phase 12 config 4", best4)
    print(f"[{card}] phase 12 loop_select from H={H} to H={SELECT_WIDE}: "
          f"kernel_ms {res4['loop_select']['ms']:.6f} -> "
          f"{res4[wide]['ms']:.6f}, ratio "
          f"{res4[wide]['ms'] / res4['loop_select']['ms']:.3f}; bound_ms "
          f"{res4['loop_select']['bound'][0]:.6f} -> "
          f"{res4[wide]['bound'][0]:.6f}", flush=True)
    viol = kernels.spec_check_plain(
        *best4["spec_check (synthetic violations)"][1])
    ls = kernels.link_send_plain(*best4["link_send (synthetic lossy)"][1],
                                 **best4["link_send (synthetic lossy)"][2])
    unreach = best4["link_send (synthetic lossy)"][1][0] & ~(
        ls.deliver | ls.drop)
    tx_args, tx_kw = best4["nic_tx (synthetic lossy)"][1:]
    tx = kernels.nic_tx_plain(*tx_args, **tx_kw)
    rx = kernels.nic_rx_plain(*best4["nic_rx (synthetic rings)"][1],
                              **best4["nic_rx (synthetic rings)"][2])
    gate = kernels.nic_gate_plain(*best4["nic_gate (synthetic debt)"][1],
                                  **best4["nic_gate (synthetic debt)"][2])
    if int(viol) == NEVER or not all(bool(x.any()) for x in (
            ls.drop, unreach, tx.deliver, tx.drop, tx.loopback,
            tx.counters[2] > tx_args[18][2], ~tx.direct, rx.local, rx.no_room,
            rx.queued & ~rx.no_room, gate, gate == 0)):
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
    sim.ops = kernels.KERNEL_OPS
    profile_windows(card, sim, "phase 12 the NIC-bound transfer windows",
                    PHASE9_PROFILE_NS)
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


def counting_appends(ops, counts: dict) -> kernels.WindowOps:
    """``ops`` with its ``ring_append`` counting in ``counts`` the packets
    each call appends: under "nic" (the send ring, no timestamp column)
    or "router"."""
    def append(*args, **kw):
        out = ops.ring_append(*args, **kw)
        ring = "nic" if args[2] is None else "router"
        counts[ring] = counts.get(ring, 0) + int(out.ok.sum())
        return out
    return ops._replace(ring_append=append)


def counting_tcp(ops, counts: dict) -> kernels.WindowOps:
    """``ops`` with its ``tcp_ack`` and ``tcp_out`` counting in ``counts``,
    under their names, the masked hosts of each call (those whose slot
    the call writes)."""
    def counted(name):
        fn = getattr(ops, name)

        def call(*args, **kw):
            counts[name] = counts.get(name, 0) + int(args[0].sum())
            return fn(*args, **kw)
        return call
    return ops._replace(tcp_ack=counted("tcp_ack"),
                        tcp_out=counted("tcp_out"))


def counting_qdisc(ops, counts: dict) -> kernels.WindowOps:
    """``ops`` with its ``qdisc_enqueue`` and ``qdisc_dequeue`` counting in
    ``counts``, under their names, the packets each call admits or hands
    up."""
    def enqueue(*args, **kw):
        out = ops.qdisc_enqueue(*args, **kw)
        counts["qdisc_enqueue"] = (counts.get("qdisc_enqueue", 0)
                                   + int(out.ok.sum()))
        return out

    def dequeue(*args, **kw):
        out = ops.qdisc_dequeue(*args, **kw)
        counts["qdisc_dequeue"] = (counts.get("qdisc_dequeue", 0)
                                   + int(out.have.sum()))
        return out
    return ops._replace(qdisc_enqueue=enqueue, qdisc_dequeue=dequeue)


def rolled_back_attempt(sim, counts: dict, need=()) -> tuple:
    """Step ``sim``'s speculative windows as ``run_optimistic`` does (each
    attempt from a snapshot of the last commit, a violation retried in a
    narrower window), outside inference mode so every tensor keeps its
    version counter, until an attempt with a count above 0 under each key
    of ``need`` in ``counts`` (``counting_appends``' rings,
    ``counting_tcp``'s kernels) rolls back. After every
    rolled-back attempt its base must keep every tensor: the same
    object, version and value. Returns (windows committed before it, the
    window start, the violation time, the number of the base's tensors,
    the attempt's appends)."""
    cons = sim.runahead
    neg1 = torch.full((sim.num_hosts,), -1, dtype=torch.int64,
                      device=sim.device)
    sim.state = sim.state.with_host(done_t=neg1)
    ws = sim._frontier(sim.stop_time).mn
    for n in range(400):
        base = sim.state  # attempt steps a snapshot of it
        we = ws + 8 * cons
        while True:
            before = {p: (t, t._version, t.clone())
                      for p, t in tensors_of(base).items()}
            counts.clear()
            st, mn, viol = sim.attempt(base, ws, we)
            if viol >= NEVER or we <= ws + cons:
                break
            after = tensors_of(base)
            if sorted(after) != sorted(before):
                fail("the rolled-back attempt changed the base's paths")
            for p, (t, version, value) in before.items():
                if (after[p] is not t or t._version != version
                        or not torch.equal(t, value)):
                    fail(f"the rolled-back attempt changed base {p}")
            if all(counts.get(r, 0) for r in need):
                return n, ws, viol, len(before), dict(counts)
            we = max(viol, ws + cons)
        sim.state = st.with_host(done_t=neg1)
        ws = mn
        if ws >= sim.stop_time:
            break
    fail(f"no attempt that counted {list(need)} rolled back")


def check_snapshot(card: str) -> None:
    """Rolled-back attempts leave their base state as it was
    (``rolled_back_attempt``): one of the mixed run, on the matrix path;
    one of the mixed flood at SNAPSHOT_FLOOD_BW, on the loop path, that
    appended to both the NIC's and the router's ring through the in-place
    ``ring_append``; and one of config 3's shape at SNAPSHOT_TCP_HOSTS
    hosts that ran the in-place ``tcp_ack`` and ``tcp_out`` on masked
    hosts."""
    for label, cfg, need in (
            ("the mixed run", MIXED, ()),
            (f"the mixed flood at {SNAPSHOT_FLOOD_BW}",
             mixed_flood(SNAPSHOT_FLOOD_BW), ("nic", "router")),
            (f"config 3 at {SNAPSHOT_TCP_HOSTS} hosts",
             config3(SNAPSHOT_TCP_HOSTS), ("tcp_ack", "tcp_out"))):
        sim = build_simulation(cfg)
        counts: dict = {}
        sim.ops = counting_tcp(counting_appends(sim.ops, counts), counts)
        n, ws, viol, nt, seen = rolled_back_attempt(sim, counts, need)
        print(f"[{card}] phase 14 snapshot, {label}: with {n} windows "
              f"committed, the attempt from t={ws} rolled back at "
              f"t={viol}, having counted {json.dumps(seen)} (packets "
              f"appended, hosts handled); its base's {nt} tensors are the "
              f"same objects, versions and values", flush=True)
        del sim


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
    for k in PUMP_ONLY:
        if launches4[k]:
            fail(f"phase 13: {k} launched {launches4[k]} times")
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


# ---------------------------------------------------------------------------
# PHOLD's variants and the CPU model
# ---------------------------------------------------------------------------

def step_windows(sim, n: int) -> None:
    """Step ``n`` windows as ``Simulation.run`` does."""
    for _ in range(n):
        f = sim._frontier(sim.stop_time)
        if f.mn >= sim.stop_time:
            return
        sim.window_step(f.mn, min(f.mn + sim.runahead, sim.stop_time), f)


def phase_new_kernels(card: str) -> dict:
    """Phase 15: every kernel of each new path on its busiest call over a
    few windows from NEW_MID (ten on the matrix paths, two on config 2's
    loop path, which alternate sends and arrivals), against its plain
    version; the next ten windows of the two CPU-model paths and of their
    model-off twins (the bench shape, config 2) run alone and under the
    profiler; and phold_forward's pick on swept draws (``pick_sweep``)."""
    results = {}
    for name, (cfg, path) in NEW_PATHS.items():
        sim = build_simulation(cfg)
        sim.run(until=NEW_MID[name])
        best: dict = {}
        sim.ops = capture_ops(best, path)
        step_windows(sim, 2 if name == "config2_cpu" else 10)
        print(f"[{card}] phase 15 {name} inputs: the busiest call of each "
              f"kernel over the windows from {NEW_MID[name]}, "
              f"H={sim.num_hosts} K={sim.K}: "
              + json.dumps({k: v[0] for k, v in best.items()}), flush=True)
        missing = [k for k in path if k not in best]
        if missing:
            fail(f"phase 15 {name}: the windows did not call {missing}")
        results[name] = compare_calls(card, f"phase 15 {name}", best)
        if name in ("phold_cpu", "config2_cpu"):
            # the CPU model's windows beside their model-off twins' below
            sim.ops = kernels.KERNEL_OPS
            profile_windows(card, sim, f"phase 15 the {name} windows",
                            10 * sim.runahead)
        dev = sim.device
        del sim, best
    for label, cfg, skip in (("the bench shape's", phold_config(), 10),
                             ("config 2's", CONFIG2, 2)):
        sim = build_simulation(cfg)
        sim.run(until=NEW_MID["phold_cpu" if skip == 10 else "config2_cpu"])
        step_windows(sim, skip)
        profile_windows(card, sim, f"phase 15 {label} windows",
                        10 * sim.runahead)
        del sim
    H = BENCH["num_hosts"]
    for label, app in (("uniform", {}), ("hot", PHOLD_HOT),
                       ("local", PHOLD_LOCAL)):
        opts = (app["hosts"]["peer"]["app_options"] if app else {})
        a = PholdApp(H, **{k: v for k, v in opts.items()
                           if k in ("hot_frac", "hot_share", "local_span")})
        u, me = (torch.as_tensor(x, device=dev)
                 for x in pick_sweep(H, **a.pick))
        got = kernels.phold_pick(u, me, H, **a.pick)
        want = kernels.pick_dst(u, me, H, **a.pick)
        err = max_abs_err([got], [want])
        print(f"[{card}] phase 15 phold_forward's pick_dst ({label}) on "
              f"{u.numel()} swept draws: max_abs_err={err}, self-sends "
              f"{int((got == me).sum())}, to hosts below {a.hot_n or 0}: "
              f"{int((got < a.hot_n).sum())}", flush=True)
        if err != 0:
            fail(f"phase 15: phold_forward's {label} pick disagrees with "
                 f"pick_dst on the card")
    return results


def new_phases(card: str):
    """Phases 16-17: each new path's whole run through the kernels against
    the JAX package's values; each to NEW_MID through the kernels and the
    plain versions, state by state; ``run_stepwise`` against ``run`` on
    phold_cpu. Returns the whole runs' launches by path."""
    out = {}
    for name, (_, path) in NEW_PATHS.items():
        sim, windows, c, chain, launches = flood_run(
            card, kernels.KERNEL_OPS, f"phase 16 {name} through the kernels",
            NEW_PATHS[name][0])
        ref = REF_NEW[name]
        for what, got, want in (("windows", windows, ref["windows"]),
                                ("counters", c, ref["counters"]),
                                ("audit_chain", chain, ref["audit_chain"])):
            if got != want:
                fail(f"phase 16 {name}: {what} = {got}, want {want}")
        for k in kernels.KERNELS:
            n = launches[k.name]
            if (k.name in path) != (n > 0):
                fail(f"phase 16 {name}: {k.name} launched {n} times")
        win = sim.obs_snapshot()["win"]
        loop = name == "config2_cpu"
        if win["loop_dispatches" if loop else "matrix_dispatches"] != windows:
            fail(f"phase 16 {name}: not every window took its path: {win}")
        if loop:
            # a launch each micro-step that commits, as audit_commit's
            if launches["cpu_serialize"] != launches["audit_commit"]:
                fail(f"phase 16 {name}: cpu_serialize and audit_commit "
                     f"launched {launches['cpu_serialize']} and "
                     f"{launches['audit_commit']} times")
        elif any(launches[k] != windows for k in path):
            fail(f"phase 16 {name}: a kernel of the path did not launch "
                 f"once a window")
        out[name] = launches
        print(f"[{card}] phase 16 {name} equal to the JAX package's "
              f"windows, counters and chain", flush=True)
        del sim
    for name, (cfg, _) in NEW_PATHS.items():
        until = NEW_MID[name]
        cut = [flood_run(card, ops, f"phase 17 {name} to {until} ({label})",
                         cfg, until)
               for ops, label in ((kernels.KERNEL_OPS, "kernels"),
                                  (kernels.PLAIN_OPS, "plain versions"))]
        (ks, kw, kc, kch, _), (ps, pw, pc, pch, pl) = cut
        if any(pl.values()):
            fail(f"phase 17 {name}: a kernel launched in the plain run: {pl}")
        if (pw, pc, pch) != (kw, kc, kch):
            fail(f"phase 17 {name}: the plain run's windows, counters or "
                 f"chain differ")
        diff = same_state(ks.state, ps.state)
        if diff:
            fail(f"phase 17 {name}: final state differs from the kernels' "
                 f"in {diff}")
        print(f"[{card}] phase 17 {name} plain run equal to the kernels' "
              f"run to {until}: windows, counters, chain, "
              f"{len(interop.state_paths(ps.state))} state arrays (cpu_avail "
              f"among them)", flush=True)
        if name == "phold_cpu":
            ss, sw, sc, sch, _ = flood_run(
                card, kernels.KERNEL_OPS,
                f"phase 17 {name} to {until} (run_stepwise)", cfg, until,
                stepwise=True)
            diff = same_state(ks.state, ss.state)
            if (sw, sc, sch) != (kw, kc, kch) or diff:
                fail(f"phase 17: run_stepwise's windows, counters, chain or "
                     f"state differ from run's ({diff})")
            print(f"[{card}] phase 17 run_stepwise equal to run on {name} "
                  f"to {until}: {sw} windows, chain, every state array",
                  flush=True)
            del ss
        del cut, ks, ps
    return out


def qdisc_synthetic(card: str, H: int, dev) -> None:
    """Phase 18's synthetic planes: K22 and K23 on a full-width plane
    (``synthetic_qdisc_plane``: random ranks, classes and fill, empty and
    full rows, ranks and virtual times near the int64 limits) of every
    case of QDISC_CASES, six steps each from the plain versions' states,
    each call on clones against its plain version. The flood's own WFQ
    ranks always insert at a row's tail; only these take PIFO's mid-row
    insert and Eiffel's wrapped scan."""
    calls = mid_insert = wrapped = 0
    for case in QDISC_CASES:
        for extreme in (False, True):
            rs = np.random.default_rng(53 + QDISC_CASES.index(case)
                                       + 100 * extreme)
            d = qdisc_discipline(*case, H, QDISC_SLOTS, dev)
            now = 2_000_000_000
            plane = synthetic_qdisc_plane(rs, case[0], now, H, QDISC_SLOTS,
                                          extreme=extreme)
            fields = [torch.as_tensor(plane[n], device=dev)
                      for n in d.spec.names]
            for step in range(6):
                now += int(rs.integers(0, 30_000_000))
                if step % 3 != 2:
                    name = "qdisc_enqueue"
                    args = (fields, *(torch.as_tensor(x, device=dev) for x in
                                      synthetic_qdisc_packets(rs, now, H)))
                else:
                    name = "qdisc_dequeue"
                    w = rs.random(H) < 0.8
                    args = (fields, torch.as_tensor(
                        np.where(w, now, NEVER), device=dev),
                        torch.as_tensor(w, device=dev))
                want = getattr(kernels, f"{name}_plain")(*args, spec=d.spec)
                work = work_args(name, args)
                got = getattr(kernels, name)(*work, spec=d.spec)
                torch.cuda.synchronize()
                check_in_place("phase 18", f"{name} {case}", args, work, got,
                               want)
                err = max(max_abs_err(got.fields, want.fields),
                          max_abs_err(got[1:], want[1:]))
                if err != 0:
                    fail(f"phase 18: {name} disagrees with its plain version "
                         f"on the synthetic plane {case} extreme={extreme}")
                old = dict(zip(d.spec.names, fields))
                new = dict(zip(d.spec.names, want.fields))
                if name == "qdisc_enqueue" and not d.spec.eiffel:
                    # the new packet's slot holds the host's old seq
                    pos = (new["q_seq"] == old["seq"][:, None]).to(
                        torch.int8).argmax(dim=1)
                    mid_insert += int((want.ok & (
                        pos < old["q_len"])).sum())
                if name == "qdisc_dequeue" and d.spec.eiffel:
                    # the scan passed the last bucket and went on from 0
                    wrapped += int((want.have & (
                        new["cur_bucket"] < old["cur_bucket"])).sum())
                fields = list(want.fields)
                calls += 1
    print(f"[{card}] phase 18 synthetic planes: K22 and K23 equal to their "
          f"plain versions, in place, on {calls} calls over "
          f"{len(QDISC_CASES)} cases at H={H} Q={QDISC_SLOTS} (and with "
          f"ranks and virtual times near the int64 limits); PIFO inserts "
          f"mid-row {mid_insert}, Eiffel scans wrapped {wrapped}",
          flush=True)
    if not (mid_insert and wrapped):
        fail("phase 18: the synthetic planes missed PIFO's mid-row insert "
             "or Eiffel's wrapped scan")


def phase_qdisc(card: str) -> dict:
    """Phase 18: each qdisc path to QDISC_CUT_S through the kernels and
    the plain versions, state by state; every kernel of the path on its
    busiest call over the next windows (QDISC_CAPTURE_WINDOWS) against
    its plain version,
    timed beside its bound; one window alone and under the profiler; and
    the synthetic planes (``qdisc_synthetic``). Returns the calls'
    results by path."""
    results = {}
    until = int(QDISC_CUT_S * 1_000_000_000)
    for name, cfg in QDISC_PATHS.items():
        cut = [flood_run(card, ops, f"phase 18 {name} to {until} ({label})",
                         cfg, until)
               for ops, label in ((kernels.KERNEL_OPS, "kernels"),
                                  (kernels.PLAIN_OPS, "plain versions"))]
        (ks, kw, kc, kch, kl), (ps, pw, pc, pch, pl) = cut
        if any(pl.values()):
            fail(f"phase 18 {name}: a kernel launched in the plain run: {pl}")
        for k in ("qdisc_enqueue", "qdisc_dequeue"):
            if kl[k] == 0:
                fail(f"phase 18 {name}: {k} never launched")
        if (pw, pc, pch) != (kw, kc, kch):
            fail(f"phase 18 {name}: the plain run's windows, counters or "
                 f"chain differ")
        diff = same_state(ks.state, ps.state)
        if diff:
            fail(f"phase 18 {name}: final state differs from the kernels' "
                 f"in {diff}")
        qd = ks.state.subs["qdisc"]
        print(f"[{card}] phase 18 {name} plain run equal to the kernels' "
              f"run to {until}: windows, counters, chain, "
              f"{len(interop.state_paths(ps.state))} state arrays; qdisc "
              + json.dumps({k: int(getattr(qd, k).sum()) for k in (
                  "enqueues", "dequeues", "drops_overflow", "drops_red",
                  "drops_codel")}) + f" depth_peak_max="
              f"{int(qd.depth_peak.max())}", flush=True)
        del ps, cut
        best: dict = {}
        ks.ops = capture_ops(best, QDISC_PATH)
        least, most = QDISC_CAPTURE_WINDOWS
        for n in range(1, most + 1):
            step_windows(ks, 1)
            if n >= least and all(k in best for k in QDISC_PATH) and (
                    best["qdisc_dequeue"][0] > 0):
                break
        print(f"[{card}] phase 18 {name} inputs: the busiest call of each "
              f"kernel over {n} windows from {until}, H={ks.num_hosts}: "
              + json.dumps({k: v[0] for k, v in best.items()}), flush=True)
        missing = [k for k in QDISC_PATH if k not in best]
        if missing:
            fail(f"phase 18 {name}: the windows did not call {missing}")
        if best["qdisc_dequeue"][0] == 0:
            fail(f"phase 18 {name}: no qdisc_dequeue call popped a packet")
        results[name] = compare_calls(card, f"phase 18 {name}", best)
        ks.ops = kernels.KERNEL_OPS
        profile_windows(card, ks, f"phase 18 the {name} window", ks.runahead)
        H, dev = ks.num_hosts, ks.device
        del ks, best
    qdisc_synthetic(card, H, dev)
    return results


def qdisc_phases(card: str) -> dict:
    """Phases 19-20: each qdisc path from t = 0 to the stop in one
    ``run()`` through the kernels against the JAX package's values
    (``REF_QDISC``), every kernel of QDISC_PATH launched and no other;
    the shaped pifo cut through the kernels against its JAX values and
    through the plain versions, state by state; and a rolled-back
    attempt of the mixed flood under pifo that leaves its base as it
    was. Returns the whole runs' launches by path."""
    out = {}
    for name, cfg in QDISC_PATHS.items():
        sim, windows, c, chain, launches = flood_run(
            card, kernels.KERNEL_OPS, f"phase 19 {name} through the kernels",
            cfg)
        check_qdisc_ref(f"phase 19 {name}", sim, windows, c, chain,
                        REF_QDISC[name])
        for k in kernels.KERNELS:
            if (k.name in QDISC_PATH) != (launches[k.name] > 0):
                fail(f"phase 19 {name}: {k.name} launched "
                     f"{launches[k.name]} times")
        win = sim.obs_snapshot()["win"]
        if win["loop_dispatches"] != windows or win["matrix_dispatches"]:
            fail(f"phase 19 {name}: not every window took the loop path: "
                 f"{win}")
        out[name] = launches
        qd = sim.state.subs["qdisc"]
        print(f"[{card}] phase 19 {name} equal to the JAX package's "
              f"windows, counters, chain and qdisc plane; qdisc "
              + json.dumps({k: int(getattr(qd, k).sum()) for k in (
                  "enqueues", "dequeues", "drops_overflow", "drops_red",
                  "drops_codel", "sojourn_sum")})
              + f" depth_peak_max={int(qd.depth_peak.max())}", flush=True)
        del sim
    name = "config2_pifo_shaped"
    cut = [flood_run(card, ops, f"phase 20 {name} ({label})",
                     CONFIG2_PIFO_SHAPED)
           for ops, label in ((kernels.KERNEL_OPS, "kernels"),
                              (kernels.PLAIN_OPS, "plain versions"))]
    (ks, kw, kc, kch, _), (ps, pw, pc, pch, pl) = cut
    check_qdisc_ref(f"phase 20 {name}", ks, kw, kc, kch, REF_QDISC[name])
    if any(pl.values()):
        fail(f"phase 20 {name}: a kernel launched in the plain run: {pl}")
    diff = same_state(ks.state, ps.state)
    if (pw, pc, pch) != (kw, kc, kch) or diff:
        fail(f"phase 20 {name}: the plain run differs from the kernels' "
             f"({diff})")
    shaped = int((ks.state.subs["qdisc"].shape_next != 0).sum())
    print(f"[{card}] phase 20 {name} equal to the JAX package's values "
          f"and the plain run to the kernels' run, state by state; "
          f"{shaped} shaped classes' eligibility times advanced",
          flush=True)
    if shaped == 0:
        fail("phase 20: no shaped class advanced its eligibility time")
    del cut, ks, ps
    sim = build_simulation(mixed_flood_qdisc())
    counts: dict = {}
    sim.ops = counting_qdisc(sim.ops, counts)
    n, ws, viol, nt, seen = rolled_back_attempt(
        sim, counts, ("qdisc_enqueue", "qdisc_dequeue"))
    print(f"[{card}] phase 20 snapshot, the mixed flood at "
          f"{SNAPSHOT_FLOOD_BW} under pifo: with {n} windows committed, the "
          f"attempt from t={ws} rolled back at t={viol}, having counted "
          f"{json.dumps(seen)} (packets admitted, handed up); its base's "
          f"{nt} tensors are the same objects, versions and values",
          flush=True)
    return out


def check_qdisc_ref(phase: str, sim, windows, c, chain, ref) -> None:
    digest = qdisc_digest(interop.state_to_numpy(sim.state))
    for what, got, want in (("windows", windows, ref["windows"]),
                            ("counters", c, ref["counters"]),
                            ("audit_chain", chain, ref["audit_chain"]),
                            ("qdisc_digest", digest, ref["qdisc_digest"])):
        if got != want:
            fail(f"{phase}: {what} = {got}, want {want}")


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
    print(f"[{card}] phase 2 compiler view (registers, smem bytes, spill "
          f"bytes by entry function): " + json.dumps(compiler_view(reports)),
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
    for k in PUMP_ONLY:
        if launches2[k]:
            fail(f"phase 7: {k} launched {launches2[k]} times")
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
    if launches3["link_send"] or (launches3["nic_refill"]
                                  > launches3["codel_dequeue"]):
        fail("phase 10: link_send launched, or nic_refill more often than "
             "the receive pump's codel_dequeue")
    nic = {k: launches3[k] for k in (*PUMP_ONLY, "nic_tx", "nic_rx",
                                     "nic_gate")}
    print(f"[{card}] phase 10 the NIC's and the link's launches: "
          f"{json.dumps(nic)}, sum {sum(nic.values())}", flush=True)
    win = sim.obs_snapshot()["win"]
    if win["loop_dispatches"] != windows3 or win["matrix_dispatches"]:
        fail(f"phase 10: not every window took the loop path: {win}")
    check_transfers(sim, "phase 10")
    check_reference("phase 10", c3, tc3, chain3, REF3)
    print(f"[{card}] phase 10 config 3 equal to the JAX package's counters, "
          f"TCP counters and chain; every transfer complete", flush=True)

    del sim
    cut = {**CONFIG3, "general": {**CONFIG3["general"],
                                  "stop_time": PHASE11_STOP_S}}
    ksim, kwindows, kc, ktc, kchain, _ = tcp_run(
        card, cut, kernels.KERNEL_OPS,
        f"phase 11 config 3 to {PHASE11_STOP_S} s through the kernels")
    psim, pwindows, pc, ptc, pchain, plaunches = tcp_run(
        card, cut, kernels.PLAIN_OPS,
        f"phase 11 config 3 to {PHASE11_STOP_S} s, plain versions")
    if any(plaunches.values()):
        fail(f"phase 11: a kernel launched in the plain run: {plaunches}")
    if (pwindows, pc, ptc, pchain) != (kwindows, kc, ktc, kchain):
        fail("phase 11: the plain run's windows, counters or chain differ")
    diff = same_state(ksim.state, psim.state)
    if diff:
        fail(f"phase 11: final state differs from the kernels' in {diff}")
    print(f"[{card}] phase 11 plain run equal to the kernels' run to "
          f"{PHASE11_STOP_S} s: counters, chain, "
          f"{len(interop.state_paths(ksim.state))} state arrays", flush=True)
    del ksim, psim

    t_opt = time.perf_counter()
    opt_results, launches4, launchesm, launches_nic = optimistic_phases(card)

    t_new = time.perf_counter()
    new_results = phase_new_kernels(card)
    new_launches = new_phases(card)

    t_qdisc = time.perf_counter()
    qdisc_results = phase_qdisc(card)
    qdisc_launches = qdisc_phases(card)

    # one entry for each kernel on each main path: its launches in that
    # path's run, and its times and bound on that path's inputs
    paths = (("phold", PHOLD_PATH, launches, results),
             ("config2", CONFIG2_PATH, launches2, loop_results),
             ("config3", CONFIG3_PATH, launches3, tcp_results),
             ("config4", CONFIG4_PATH, launches4, opt_results["config4"]),
             ("mixed", MIXED_PATH, launchesm, opt_results["mixed"]),
             ("config3_100mbit", NIC_PATH, launches_nic,
              opt_results["config3_100mbit"]))
    # the CPU model is off on the six earlier paths: K21 launches nothing
    for path, _, counts, _ in paths:
        if counts["cpu_serialize"]:
            fail(f"cpu_serialize launched {counts['cpu_serialize']} times "
                 f"on {path}, whose hosts have no CPU cost")
    paths += tuple((name, NEW_PATHS[name][1], new_launches[name],
                    new_results[name]) for name in NEW_PATHS)
    # no earlier path has a device-queue discipline: K22 and K23 launch
    # nothing there
    for path, _, counts, _ in paths:
        for k in ("qdisc_enqueue", "qdisc_dequeue"):
            if counts[k]:
                fail(f"{k} launched {counts[k]} times on {path}, which has "
                     f"no pifo or eiffel qdisc")
    paths += tuple((name, QDISC_PATH, qdisc_launches[name],
                    qdisc_results[name]) for name in QDISC_PATHS)
    line = {"kernels": [
        {
            "name": k.name,
            "path": path,
            "route": "cuda",
            "source": f"shadow_tpu_torch/csrc/{k.name}.cu",
            "replaces": (REPLACES_LOOP.get(k.name, REPLACES[k.name])
                         if path == "config2_cpu" else REPLACES[k.name]),
            "launches": counts[k.name],
            "max_abs_err": res[k.name]["err"],
            "ms": res[k.name]["ms"],
            "issue_ms": res[k.name]["issue_ms"],
            "plain_ms": res[k.name]["plain_ms"],
            "bound_ms": res[k.name]["bound"][0],
            "bound_by": res[k.name]["bound"][1],
            "library_ms": res[k.name].get("library_ms"),
        }
        for k in kernels.KERNELS
        for path, on_path, counts, res in paths if k.name in on_path
    ]}
    t_end = time.perf_counter()
    print(f"[{card}] phases 9-11 wall_s={t_opt - t_tcp:.3f}; phases 12-14 "
          f"wall_s={t_new - t_opt:.3f}; phases 15-17 "
          f"wall_s={t_qdisc - t_new:.3f}; phases 18-20 "
          f"wall_s={t_end - t_qdisc:.3f}; whole script "
          f"wall_s={t_end - t_start:.3f}", flush=True)
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))


if __name__ == "__main__":
    main()
