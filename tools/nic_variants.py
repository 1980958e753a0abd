"""Time the NIC's admission kernels against variants of their sources.

    python3 tools/nic_variants.py [--hosts 10240,50176] [--rounds 5]

On one CUDA card. Each variant is a copy of ``shadow_tpu_torch/csrc``
with one change, built by nvcc with the kernels' flags
(``tools/variants.py``):

- ``block64``, ``block256``: ``nic_tx``, ``nic_rx`` and ``nic_gate``
  with blocks of 64 or 256 threads (``nic::kBlock``; the port builds
  ``block128``, the sources as they are);
- ``memset``: ``nic_tx`` summing its four counts the plain way, with
  one ``atomicAdd`` a warp into the output's counter slot, which its C
  entry clears with ``cudaMemsetAsync`` before the launch (the slot then
  holds the sums, not the counters advanced by them).

Each build is bound in turn in place of the port's own, checked against
the plain version on ``chip_smoke.py``'s synthetic tables at each width,
and timed: one call's device time (``chip_smoke.graph_ms``, 200 calls
replayed from one CUDA graph, so the memset counts) and issue time
(``chip_smoke.time_ms``, 200 calls from Python), the variants in turns
over the rounds. Prints nvcc's ``-Xptxas -v`` lines of each build, one
JSON line a kernel, width and variant with the medians and every round,
and the card's name and power limit.
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
from tools import variants  # noqa: E402

BLOCK = "constexpr int kBlock = 128;"
MEMSET = {  # nic_tx.cu: text of the source -> text of the variant
    "  const long long before = threadIdx.x < 4 ? *a.counters[threadIdx.x]"
    " : 0;\n": "",
    "  __shared__ unsigned long long part[4][kWarps];":
    "  unsigned long long* slot = (unsigned long long*)(a.out + 6LL * H);",
    "    if (lane == 0) part[i][warp] = v;":
    "    if (lane == 0) atomicAdd(slot + i, v);",
    "  nic_tx_kernel<<<":
    "  cudaMemsetAsync(k.out + 6LL * H, 0, 4 * sizeof(long long),\n"
    "                  (cudaStream_t)stream);\n  nic_tx_kernel<<<",
}
# the memset variant ends its kernel after the warps' adds
MEMSET_CUT = ("  __syncthreads();\n  if (threadIdx.x < 4) {", "\n}\n\n}  //")


def memset_tx(src: str) -> str:
    """nic_tx.cu with MEMSET's edits and its kernel cut after the adds."""
    src = variants.replace_once(src, MEMSET, "memset: nic_tx.cu")
    head, cut = src.split(MEMSET_CUT[0])
    return head.rstrip() + MEMSET_CUT[1] + cut.split(MEMSET_CUT[1])[1]


VARIANTS = {
    "block64": {"nic_common.cuh": {BLOCK: BLOCK.replace("128", "64")}},
    "block128": {},
    "block256": {"nic_common.cuh": {BLOCK: BLOCK.replace("128", "256")}},
    "memset": {"nic_tx.cu": memset_tx},
}
KERNELS = (kernels.NIC_TX, kernels.NIC_RX, kernels.NIC_GATE)
SYNTHETIC = {"nic_tx": chip_smoke.synthetic_nic_tx,
             "nic_rx": chip_smoke.synthetic_nic_rx,
             "nic_gate": chip_smoke.synthetic_nic_gate}


def check(name: str, variant: str, got, want, args) -> None:
    if variant == "memset":  # the slot holds the sums alone
        sums = want.counters - torch.stack(args[18])
        ok = torch.equal(got.counters, sums) and chip_smoke.max_abs_err(
            got._replace(counters=want.counters), want) == 0
    else:
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        ok = chip_smoke.max_abs_err(got, want) == 0
    if not ok:
        chip_smoke.fail(f"{name} {variant} disagrees with its plain version")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--hosts", default="10240,50176")
    ap.add_argument("--rounds", type=int, default=5)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        chip_smoke.fail("no CUDA device")
    card = chip_smoke.card_line()
    libs = variants.build({
        (k.name, v): edits for v, edits in VARIANTS.items() for k in KERNELS
        if v != "memset" or k is kernels.NIC_TX})
    for H in map(int, a.hosts.split(",")):
        for k in KERNELS:
            args, kw = SYNTHETIC[k.name](H, torch.device("cuda"))
            kern = getattr(kernels, k.name)
            want = getattr(kernels, f"{k.name}_plain")(*args, **kw)
            mine = [v for (n, v) in libs if n == k.name]
            dev = {v: [] for v in mine}
            issue = {v: [] for v in mine}
            for _ in range(a.rounds):
                for v in mine:
                    kernels._libs[k.name] = libs[(k.name, v)]
                    check(k.name, v, kern(*args, **kw), want, args)
                    call = lambda: kern(*args, **kw)  # noqa: E731
                    dev[v].append(chip_smoke.graph_ms(call, 200))
                    issue[v].append(chip_smoke.time_ms(call, 200))
            for v in mine:
                print(json.dumps({
                    "kernel": k.name, "hosts": H, "variant": v,
                    "ms": statistics.median(dev[v]),
                    "issue_ms": statistics.median(issue[v]),
                    "rounds_ms": dev[v], "issue_rounds_ms": issue[v],
                    "card": card}), flush=True)
    kernels._libs.clear()
    print(card)


if __name__ == "__main__":
    main()
