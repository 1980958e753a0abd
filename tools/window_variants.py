"""Time the matrix path's extract_slots and phold_forward against variants
of their sources.

    python3 tools/window_variants.py [--rounds 5]

On one CUDA card. Each variant is a copy of ``shadow_tpu_torch/csrc``
with one change, built by nvcc with the kernels' flags
(``tools/variants.py``):

- ``extract_slots`` ``row_payload``: each row's own thread copies its PP
  payload words (the port's kernel has a warp copy its 32 rows' words
  together, neighbouring lanes on neighbouring words);
- ``phold_forward`` ``hosts2``, ``hosts4``: 2 or 4 hosts (warps) a block
  (the port builds 8).

The port's own build is the variant named ``port``. Each build is bound
in turn in place of the port's, checked against the plain version, and
timed: one call's device time (``chip_smoke.graph_ms``, 200 calls
replayed from one CUDA graph), the variants in turns over the rounds.
Inputs: the PHOLD bench window of ``chip_smoke.py`` phase 3 (both
kernels, PP = 1) and the busiest ``extract_slots`` call of config 4's
optimistic window of phase 12 (the loop path: Kc = K + 1, PP = 6, a pool
of 2^18 rows). Prints nvcc's ``-Xptxas -v`` lines of each build, one JSON
line a kernel, input and variant with the median and every round, and
the card's name and power limit.

Then, on both ``extract_slots`` inputs, the wrapper's host side: its
issue time (``chip_smoke.time_ms``, 200 calls from Python, under
``torch.inference_mode`` as ``Simulation.run`` calls it) with each way
of returning its one allocation (``RETURNS``): the port's two splits and
five shapes, eleven ``as_strided`` views, and the buffer alone (no views:
the floor of any leaner return), one JSON line each.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from shadow_tpu_torch import kernels  # noqa: E402
from shadow_tpu_torch.core import engine  # noqa: E402
from shadow_tpu_torch.sim import build_simulation  # noqa: E402
from tools import variants  # noqa: E402

COOPERATIVE = (
    "  // every lane runs PP rounds, so the whole warp reaches each shuffle\n"
    "  for (int j = threadIdx.x & 31; j < 32 * PP; j += 32) {\n"
    "    const int row = j / PP, w = j - row * PP;\n"
    "    const long long ro = __shfl_sync(kFull, o, row);\n"
    "    const long long rr = __shfl_sync(kFull, r, row);\n"
    "    if (ro >= 0) o_p[ro * PP + w] = rr < C ? p_p[rr * PP + w] : 0;\n"
    "  }\n")
ROW_PAYLOAD = (
    "  if (o >= 0)\n"
    "    for (int w = 0; w < PP; ++w)\n"
    "      o_p[o * PP + w] = r < C ? p_p[r * PP + w] : 0;\n")
HOSTS = "constexpr int kHostsPerBlock = 8;"
# {kernel: {variant: {source file: {text: replacement}}}}
VARIANTS = {
    "extract_slots": {
        "port": {},
        "row_payload": {"extract_slots.cu": {COOPERATIVE: ROW_PAYLOAD}},
    },
    "phold_forward": {
        "port": {},
        "hosts2": {"phold_forward.cu": {HOSTS: HOSTS.replace("8", "2")}},
        "hosts4": {"phold_forward.cu": {HOSTS: HOSTS.replace("8", "4")}},
    },
}


def buffer_only(buf, C, H, Kc, PP):
    """No views: the floor of any leaner return of ``extract_slots``."""
    return buf


def strided_views(buf, C, H, Kc, PP):
    """The eleven views each made by one ``as_strided`` of the buffer (the
    port splits it twice and shapes five of the pieces)."""
    HK, N = H * Kc, C + H * Kc
    s, s32 = buf.as_strided, buf.view(torch.int32).as_strided
    o = 2 * N * (1 + PP)  # the int32 columns: src, seq, kind, tail dst
    hk = ((H, Kc), (Kc, 1))
    return kernels.Extracted(
        kernels.DenseWindow(
            time=s(*hk, 0), src=s32(*hk, o), seq=s32(*hk, o + N),
            kind=s32(*hk, o + 2 * N),
            payload=s((H, Kc, PP), (Kc * PP, PP, 1), N)),
        kernels.Tail(
            time=s((C,), (1,), HK), dst=s32((C,), (1,), o + 3 * N),
            src=s32((C,), (1,), o + HK), seq=s32((C,), (1,), o + N + HK),
            kind=s32((C,), (1,), o + 2 * N + HK),
            payload=s((C, PP), (PP, 1), N + HK * PP)))


# extract_slots' host-side return: how its one allocation becomes tensors
RETURNS = {"port": kernels._extract_views, "strided": strided_views,
           "buffer": buffer_only}


def inputs() -> list:
    """[(kernel, label, args, kwargs)]: the PHOLD bench window's calls and
    config 4's busiest extract_slots call."""
    sim, ws, we = chip_smoke.window_inputs("inputs")
    st, p, H, K = sim.state, sim.params, sim.num_hosts, sim.K
    pool = st.pool
    xargs = (*engine.window_keys(pool, ws, we, H, K), pool.time, pool.dst,
             pool.src, pool.seq, pool.kind, pool.payload, H, K)
    dense, _ = kernels.extract_slots_plain(*xargs)
    h = st.host
    fargs = (dense.time, dense.payload, st.rng_keys, h.rng_counter,
             h.seq_next, h.gid, h.vertex, p.latency_vv, p.reliability_vv,
             p.vertex_g)
    fkw = dict(num_hosts=H, stop_sending=sim.app.stop_sending,
               bootstrap_end=p.bootstrap_end, win_end=we, kind=1)
    best = chip_smoke.capture_window(build_simulation(chip_smoke.CONFIG4),
                                     ("extract_slots",),
                                     chip_smoke.PHASE12_FROM)
    _, cargs, ckw = best["extract_slots"]
    return [("extract_slots", "phold", xargs, {}),
            ("phold_forward", "phold", fargs, fkw),
            ("extract_slots", "config4", cargs, ckw)]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=5)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        chip_smoke.fail("no CUDA device")
    card = chip_smoke.card_line()
    kernels.build()
    calls = inputs()
    libs = variants.build({(name, v): edits
                           for name, vs in VARIANTS.items()
                           for v, edits in vs.items()})
    for name, label, args, kw in calls:
        kern = getattr(kernels, name)
        flat = chip_smoke.flat_extract if name == "extract_slots" else tuple
        want = flat(getattr(kernels, f"{name}_plain")(*args, **kw))
        mine = list(VARIANTS[name])
        dev = {v: [] for v in mine}
        for _ in range(a.rounds):
            for v in mine:
                kernels._libs[name] = libs[(name, v)]
                if chip_smoke.max_abs_err(flat(kern(*args, **kw)), want):
                    chip_smoke.fail(f"{name} {v} disagrees with its plain "
                                    f"version on {label}")
                dev[v].append(chip_smoke.graph_ms(
                    lambda: kern(*args, **kw), 200))
        for v in mine:
            print(json.dumps({
                "kernel": name, "input": label, "variant": v,
                "ms": statistics.median(dev[v]), "rounds_ms": dev[v],
                "card": card}), flush=True)
    kernels._libs.clear()
    for name, label, args, kw in calls:
        if name == "extract_slots":
            wrapper_returns(label, args, a.rounds, card)
    print(card)


def wrapper_returns(label: str, args, rounds: int, card: str) -> None:
    """extract_slots' issue time (``chip_smoke.time_ms``, 200 calls from
    Python, under inference_mode as Simulation.run calls it) with each of
    RETURNS, in turns over the rounds."""
    want = chip_smoke.flat_extract(kernels.extract_slots_plain(*args))
    issue = {r: [] for r in RETURNS}
    with torch.inference_mode():
        for _ in range(rounds):
            for r, fn in RETURNS.items():
                kernels._extract_views = fn
                got = kernels.extract_slots(*args)
                if r != "buffer" and chip_smoke.max_abs_err(
                        chip_smoke.flat_extract(got), want):
                    chip_smoke.fail(f"extract_slots' {r} return disagrees "
                                    f"with its plain version on {label}")
                issue[r].append(chip_smoke.time_ms(
                    lambda: kernels.extract_slots(*args), 200))
    kernels._extract_views = RETURNS["port"]
    for r in RETURNS:
        print(json.dumps({
            "kernel": "extract_slots", "input": label, "return": r,
            "issue_ms": statistics.median(issue[r]),
            "issue_rounds_ms": issue[r], "card": card}), flush=True)


if __name__ == "__main__":
    main()
