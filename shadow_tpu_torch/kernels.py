"""The window step's hand-written CUDA kernels, their plain PyTorch
versions, and the build and ctypes binding.

Twenty-three kernels carry the window step on the card (sources under
``csrc/``, one shared library each). Every window of both paths begins
and ends with two radix sorts:

* ``window_sort`` (K19): the window's first sort — the keys built from
  the pool's columns and the two stable key sorts of
  ``shadow_tpu/core/engine.py:_dense_extract``, the filler rows placed
  without being sorted.
* ``pool_merge`` (K20): the next pool — the stable sort by time of
  ``make_window_step``'s ``assemble`` and the loop path's ``finish``,
  truncated to the capacity, each block of rows read where it lies.

The PHOLD matrix path runs three more:

* ``extract_slots`` (K3): every row of the window's first sort moved to
  its place in the dense window or the tail — the rank scan and the
  second sort of ``shadow_tpu/core/engine.py:_dense_extract``, with the
  filler rows made in registers.
* ``phold_forward`` (K1): PHOLD's forwarding over the ``[H, K]`` window —
  ``shadow_tpu/net/apps.py:PholdApp.handle_msg_matrix`` with its threefry
  draws and its three destination modes (uniform, hot spot, ring
  offset), plus the per-source seq numbering of ``run_matrix``.
* ``audit_commit`` (K2): the per-host commit of the window — the audit
  fold (``shadow_tpu/obs/audit.py:fold``, column by column) and the
  per-host event count and frontier updates of ``run_matrix``. The
  micro-step loop path reuses it on each micro-step's taken events.

Where any host has a CPU cost (``cpu_ns_per_event``), both paths run one
more:

* ``cpu_serialize`` (K21): the CPU model — each host's events execute
  one after another on its virtual CPU (``shadow_tpu/core/engine.py``:
  ``run_matrix``'s cummax form over the dense window, the loop body's
  chain over a micro-step's taken events), with the new CPU clocks and
  the exact sum of the delays.

The micro-step loop path and the network stack run the other four:

* ``loop_select`` (K4): each host's event for one micro-step — the
  candidate choice, bulk batch plan, outbox and pool-headroom gates of
  ``shadow_tpu/core/engine.py:make_loop_fns.body``.
* ``loop_route`` (K5): the routing of one micro-step's emissions into the
  per-host inbox and outbox, in emit order (the same ``body``); on the
  card it updates the boxes in place.
* ``codel_dequeue`` (K6): the CoDel router's dequeue,
  ``shadow_tpu/net/codel.py:dequeue``.
* ``ring_append`` (K7): a masked append to a per-host ring, for the
  router's ``codel.enqueue`` and the NIC's ``nic.enqueue_send``; on the
  card it writes the appended slots into the ring planes in place.

The TCP stack (``net/tcp.py``) runs four more, each on the one socket
each host's segment or self-event names, returning its decisions so
that the emissions stay in the JAX package's order:

* ``tcp_demux`` (K8): the socket match of ``shadow_tpu/net/tcp.py:demux``.
* ``tcp_ack`` (K9): the ACK block of ``Tcp.on_segment`` — RTT, Reno and
  NewReno, the SACK scoreboard and the retransmission choice; on the card
  it updates the socket's fields in place.
* ``tcp_reorder`` (K10): the data-receive block of ``Tcp.on_segment``
  (the reorder board) and the SACK word of its ACK reply; on the card it
  updates the board, ``rcv_nxt`` and ``bytes_received`` in place.
* ``tcp_out`` (K11): the output pump ``Tcp.on_out``; on the card it
  updates the socket's fields in place.

The optimistic driver and the network stack's NIC and link run four more:

* ``spec_check`` (K12): the speculation-violation signal ``xmit_min`` of
  both window paths (``shadow_tpu/core/engine.py``, loop ``finish`` and
  ``run_matrix``): the earliest emission behind its destination's
  progress clock.
* ``nic_refill`` (K13): the token buckets' lazy refill, ``nic.lazy_refill``.
* ``send_dequeue`` (K14): the fifo qdisc's dequeue, ``nic.peek_send``
  then ``nic.pop_send``.
* ``link_send`` (K15): ``net/link.py:send``'s path lookup, per-host
  threefry draw and loss roll.

K13 and K15 remain for the pumps (and the app's own ``link.send``). The
network stack's busiest calls fold them into the launch that consumes
their result, three kernels with out-of-place results packed in one
allocation:

* ``nic_tx`` (K16): the direct send of ``NetStack._tx`` — the tx refill,
  admission, charge and counters, and ``link_send``'s roll of the remote
  packets, advancing ``link.send``'s four counters.
* ``nic_rx`` (K17): the admission of ``NetStack.on_pkt_deliver`` — the rx
  refill, the direct test, the charge and the zero-sojourn CoDel reset.
* ``nic_gate`` (K18): ``NetStack.bulk_gate`` — both refills to the window
  start, the budgets and the gate.

The device-queue disciplines (``qdisc: pifo`` or ``eiffel``) run two
more in place of the NIC's send ring:

* ``qdisc_enqueue`` (K22): ``DeviceQueueDiscipline.enqueue`` of
  ``shadow_tpu/net/qdisc/pifo.py`` — admission, RED, the rank (fifo,
  prio or wfq, and shaping) and the insert (PIFO's compare-and-place and
  row shift, Eiffel's first free slot and bucket).
* ``qdisc_dequeue`` (K23): ``DeviceQueueDiscipline.dequeue`` — the pop
  (PIFO's slot 0 and row shift, Eiffel's circular bucket scan) under no
  hook or the CoDel hook, whose control law it shares with K6.

Each wrapper runs its plain version for tensors on the CPU and launches
its kernel for tensors on the card; there is no fallback from one to the
other. Seven kernels write into tensors they are given: ``loop_route``
the micro-step's boxes; ``ring_append``, ``tcp_ack``, ``tcp_reorder``,
``tcp_out``, ``qdisc_enqueue`` and ``qdisc_dequeue`` the state fields
their sub-state classes list in ``IN_PLACE`` (``SimState.snapshot()``
clones those); each ``Kernel``'s ``writes`` says which arguments. The
plain versions work out of place.
A wrapper adds one to its kernel's ``launches`` where it launches the
kernel and nowhere else.

The kernels are built with nvcc for ``sm_90a`` at first use, into
``_build/`` beside this file, and loaded with ctypes; every pointer and
the stream pass as ``c_void_p`` (``tcp_ack`` and ``tcp_out`` take host
arrays of their many pointers). Each C entry returns
``cudaGetLastError()`` after its launch and the wrapper raises if it is not
0. ``--fmad=false`` keeps every float32 multiply and add separately
rounded, as XLA and the plain versions compute them.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import struct
import subprocess
import tempfile
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from shadow_tpu_torch.core import rng, soa
from shadow_tpu_torch.core.simtime import NEVER, NS_PER_MS

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# the k1 sort key of a window row is run_key << DT_BITS | clipped dt
DT_BITS = 44
DT_MAX = (1 << DT_BITS) - 1

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float


@dataclass
class Kernel:
    """One CUDA kernel: its source, C entry and argument types, and the
    count of its launches. ``writes`` maps the positions of the wrapper's
    arguments that the kernel writes in place on the card to where its
    result returns them (``written_result``): a field's name, or
    ("fields", k) for the k-th tensor of the tuple ``fields``. ``checks``
    names the library's other C entries and their argument types: entries
    that run a part of the kernel alone for a check, on no path, so
    ``_call`` counts no launch."""

    name: str
    argtypes: tuple
    launches: int = 0
    writes: dict = field(default_factory=dict)
    checks: dict = field(default_factory=dict)

    @property
    def source(self) -> str:
        return os.path.join(CSRC, f"{self.name}.cu")


# extract_slots, the two sorts and the NIC's admission kernels take their
# arguments packed in one host array of int64 (``_PACK``: pointers,
# strides, sizes; the C entry names them in order) and the stream: one
# ctypes argument costs more than packing one value
WINDOW_SORT = Kernel("window_sort", (ctypes.c_char_p, _P))
POOL_MERGE = Kernel("pool_merge", (ctypes.c_char_p, _P))
EXTRACT_SLOTS = Kernel("extract_slots", (ctypes.c_char_p, _P))
PHOLD_FORWARD = Kernel(
    "phold_forward",
    (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,  # inputs
     _P, _P, _P, _P, _P, _P, _P, _P, _P,  # outputs
     _I, _I, _I, _I, _I, _L, _L, _L, _I,
     _I, _F, _F, _F, _I,  # the pick: hot_n, its three floats, local_span
     _P),
    checks={"phold_pick": (_P, _P, _P, _L, _I, _I, _F, _F, _F, _I, _P)},
)
AUDIT_COMMIT = Kernel(
    "audit_commit",
    (_P, _P, _P, _P, _P, _P, _P, _P, _P,  # inputs
     _P, _P, _P, _P, _P,  # outputs
     _I, _I, _P),
)
CPU_SERIALIZE = Kernel("cpu_serialize", (_P, _P, _P, _P, _I, _I, _I, _P))
# the device-queue disciplines write their sub-state's fields in place
# (argument 0, a list of tensors); their arguments come packed as
# extract_slots' do (_PACK is set beside their wrappers)
QDISC_ENQUEUE = Kernel("qdisc_enqueue", (ctypes.c_char_p, _P),
                       writes={0: "fields"})
QDISC_DEQUEUE = Kernel("qdisc_dequeue", (ctypes.c_char_p, _P),
                       writes={0: "fields"})
LOOP_SELECT = Kernel(
    "loop_select",
    (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,  # inputs
     _P, _P, _P, _P, _P, _P, _P, _P, _P,  # outputs
     _P, _L,  # scratch and its bytes
     _I, _I, _I, _I, _I, _I, _I, _L, _L, _I, _I, _I, _P),
)
LOOP_ROUTE = Kernel(
    "loop_route",
    (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,  # records, seq_next, keys
     _P, _P, _P, _P, _P,  # inbox, updated in place
     _P, _P, _P, _P, _P, _P, _P,  # outbox, updated in place
     _P, _P,  # seq_next and stats out
     _I, _I, _I, _I, _I, _L, _P),
    writes={10: "boxes"},
)
CODEL_DEQUEUE = Kernel(
    "codel_dequeue",
    (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,  # inputs
     _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,  # outputs
     _I, _I, _I, _I, _P),
)
RING_APPEND = Kernel(
    "ring_append",
    (_P, _P, _P,  # ring planes, updated in place
     _P, _P, _P, _P, _P, _P, _P,  # inputs
     _P, _P, _P,  # outputs
     _I, _I, _I, _P),
    writes={0: "payload", 1: "col", 2: "ts"},
)
TCP_DEMUX = Kernel(
    "tcp_demux",
    (_P, _P, _P, _P, _P, _P, _P, _P, _P,  # inputs
     _P, _P, _P,  # outputs
     _I, _I, _P),
)
# tcp_ack and tcp_out take host arrays of their input and output pointers;
# their writes are set beside ACK_IN and OUT_IN below
TCP_ACK = Kernel("tcp_ack", (_P, _P, _I, _I, _I, _P))
TCP_REORDER = Kernel(
    "tcp_reorder",
    (_P, _P, _P, _P, _P,  # inputs
     _P, _P, _P,  # rcv_nxt, bytes_received, ooo_map, updated in place
     _P, _P, _P,  # outputs
     _I, _I, _I, _I, _P),
    writes={5: "rcv_nxt", 6: "ooo_map", 7: "bytes_received"},
)
TCP_OUT = Kernel("tcp_out", (_P, _P, _I, _I, _I, _P))
SPEC_CHECK = Kernel("spec_check", (_P, _P, _P, _P, _L, _I, _P, _P))
NIC_REFILL = Kernel(
    "nic_refill", (_P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _P))
SEND_DEQUEUE = Kernel(
    "send_dequeue", (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P))
LINK_SEND = Kernel(
    "link_send",
    (_P, _P, _P, _I, _P, _I, _P, _P, _I, _P, _P, _I, _P, _P, _L,  # inputs
     _P, _P, _P, _P,  # outputs
     _I, _P),
)
NIC_TX = Kernel("nic_tx", (ctypes.c_char_p, _P))
NIC_RX = Kernel("nic_rx", (ctypes.c_char_p, _P))
NIC_GATE = Kernel("nic_gate", (ctypes.c_char_p, _P))
# the merge's blocks: at most MERGE_BLOCKS, ten values each
MERGE_BLOCKS = 4
_PACK = {"window_sort": struct.Struct("<13q"),
         "pool_merge": struct.Struct(f"<{12 + 10 * MERGE_BLOCKS}q"),
         "extract_slots": struct.Struct("<19q"),
         "nic_tx": struct.Struct("<30q"), "nic_rx": struct.Struct("<19q"),
         "nic_gate": struct.Struct("<18q")}
KERNELS = (EXTRACT_SLOTS, PHOLD_FORWARD, AUDIT_COMMIT, LOOP_SELECT,
           LOOP_ROUTE, CODEL_DEQUEUE, RING_APPEND, TCP_DEMUX, TCP_ACK,
           TCP_REORDER, TCP_OUT, SPEC_CHECK, NIC_REFILL, SEND_DEQUEUE,
           LINK_SEND, NIC_TX, NIC_RX, NIC_GATE, WINDOW_SORT, POOL_MERGE,
           CPU_SERIALIZE, QDISC_ENQUEUE, QDISC_DEQUEUE)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


def written_result(out, where) -> torch.Tensor:
    """The tensor of a kernel's result that a value of its ``writes``
    names."""
    if isinstance(where, str):
        return getattr(out, where)
    name, k = where
    return getattr(out, name)[k]


# ---------------------------------------------------------------------------
# Build and binding
# ---------------------------------------------------------------------------

_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        nvcc = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (set CUDA_HOME or PATH)")
    return nvcc


def _lib_path(k: Kernel) -> str:
    """The library's path, named by a digest of its source, the shared
    headers and the flags."""
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    headers = sorted(n for n in os.listdir(CSRC) if n.endswith(".cuh"))
    for path in (k.source, *(os.path.join(CSRC, n) for n in headers)):
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"{k.name}-{digest.hexdigest()[:12]}.so")


def build(kernels=KERNELS, force: bool = False) -> dict[str, str]:
    """Compile every kernel not yet built (every one with ``force``), one
    nvcc process per source, all started together. Returns {name: nvcc's
    -Xptxas -v report} for the kernels compiled by this call. Raises if any
    build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for k in kernels:
        out = _lib_path(k)
        if os.path.exists(out) and not force:
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, k.source]
        procs[k.name] = (out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    reports, failed = {}, []
    for name, (out, tmp, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
        reports[name] = log
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def csrc_constant(source: str, name: str) -> int:
    """The value of ``constexpr int <name> = <value>;`` in the file
    ``source`` of ``csrc/``: a kernel's limit, read where it is set."""
    with open(os.path.join(CSRC, source)) as f:
        found = re.findall(rf"constexpr int {name} = (\d+);", f.read())
    if len(found) != 1:
        raise RuntimeError(f"{source} sets {name} {len(found)} times")
    return int(found[0])


def _lib(k: Kernel):
    lib = _libs.get(k.name)
    if lib is None:
        path = _lib_path(k)
        if not os.path.exists(path):
            build((k,))
        lib = ctypes.CDLL(path)
        for name, types in ((k.name, k.argtypes), *k.checks.items()):
            fn = getattr(lib, name)
            fn.argtypes = list(types)
            fn.restype = ctypes.c_int
        _libs[k.name] = lib
    return getattr(lib, k.name)


_scratch: dict = {}


def _scratch_bytes(k: Kernel, n: int) -> int:
    """The scratch bytes the kernel ``k`` needs for ``n`` rows, from its
    library's ``<name>_scratch`` (the C entry refuses less)."""
    b = _scratch.get((k.name, n))
    if b is None:
        _lib(k)
        fn = getattr(_libs[k.name], f"{k.name}_scratch")
        fn.argtypes = [_L]
        fn.restype = _L
        b = _scratch[(k.name, n)] = fn(n)
    return b


def _raise_on(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")


def _launch(k: Kernel, *args) -> None:
    _raise_on(k.name, _lib(k)(*args))
    k.launches += 1


def _call(k: Kernel, entry: str, *args) -> None:
    """Run the check entry ``entry`` of ``k``'s library; no launch
    counted."""
    _lib(k)
    _raise_on(entry, getattr(_libs[k.name], entry)(*args))


def _on_card(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU tensors; raises on a mix or on
    another device type."""
    for t in tensors:  # the card's case first: no device objects made
        if not t.is_cuda:
            break
    else:
        return True
    types = {t.device.type for t in tensors}
    if types == {"cpu"}:
        return False
    if types == {"cuda"}:
        return True
    raise ValueError(f"tensors on devices {sorted(types)}: the kernels take "
                     f"all-CUDA or all-CPU arguments")


def _check(t: torch.Tensor, dtype, shape, name: str) -> int:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: want {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    return t.data_ptr()


def _stream(t: torch.Tensor) -> int:
    """The raw handle of the current stream of ``t``'s card (what
    ``torch.cuda.current_stream(t.device).cuda_stream`` gives, without
    making the Stream object)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


# ---------------------------------------------------------------------------
# K19 window_sort
# ---------------------------------------------------------------------------

# the hosts the k1 key holds: run_key << DT_BITS stays below 2^63
WINDOW_MAX_HOSTS = 1 << (63 - DT_BITS)


def _window_hosts(H: int) -> None:
    if not 0 < H < WINDOW_MAX_HOSTS:
        raise ValueError(f"window_sort: the k1 key holds run keys below "
                         f"{WINDOW_MAX_HOSTS} (run_key << {DT_BITS} in "
                         f"int64), got H={H}")


def window_sort_keys(time, dst, src, seq, win_start: int, win_end: int,
                     H: int, Kc: int):
    """(k1, k2) [N = C + H·Kc] int64: the keys of the C pool rows, then of
    the H·Kc filler rows, host-major."""
    _window_hosts(H)
    C = time.shape[0]
    N = C + H * Kc
    dev = time.device
    inwin = (time < win_end) & (dst >= 0) & (dst < H)
    run_key = torch.where(inwin, dst.to(torch.int64), H)
    dt = (time - win_start).clamp(0, DT_MAX)
    k1 = torch.empty(N, dtype=torch.int64, device=dev)
    k1[:C] = (run_key << DT_BITS) | dt
    hosts = torch.arange(H, dtype=torch.int64, device=dev)
    k1[C:] = ((hosts << DT_BITS) | DT_MAX).repeat_interleave(Kc)
    k2 = torch.zeros(N, dtype=torch.int64, device=dev)
    k2[:C] = (src.to(torch.int64) << 32) | (seq.to(torch.int64) & rng.M32)
    return k1, k2


def window_sort_plain(time, dst, src, seq, win_start: int, win_end: int,
                      H: int, Kc: int):
    """Plain version: the keys (``window_sort_keys``), then a stable sort
    by k2 and a stable sort by k1, which is the JAX package's
    ``lax.sort(num_keys=2, is_stable=True)``."""
    k1, k2 = window_sort_keys(time, dst, src, seq, win_start, win_end, H,
                              Kc)
    p2 = torch.sort(k2, stable=True).indices
    s_k1, p1 = torch.sort(k1[p2], stable=True)
    return s_k1, p2[p1]


def window_sort(time, dst, src, seq, win_start: int, win_end: int, H: int,
                Kc: int):
    """The window's first sort (``engine.window_keys``): from the pool's
    ``time``, ``dst``, ``src`` and ``seq`` columns (C rows), the keys
    k1 = run_key << 44 | clip(time - win_start, 0, DT_MAX) and
    k2 = src << 32 | seq of the pool rows and of H·Kc filler rows (host h's
    Kc rows k1 = h << 44 | DT_MAX, k2 = 0, after the pool rows), sorted by
    (k1, k2, row). Returns (s_k1, perm) [N = C + H·Kc] int64: the sorted k1
    and the row each place came from. On the card: one C entry, its keys
    built on the card, only the pool rows sorted."""
    args = (time, dst, src, seq)
    if not _on_card(*args):
        return window_sort_plain(*args, win_start, win_end, H, Kc)
    _window_hosts(H)
    C = time.shape[0]
    ins = (_check(time, torch.int64, (C,), "time"),
           _check(dst, torch.int32, (C,), "dst"),
           _check(src, torch.int32, (C,), "src"),
           _check(seq, torch.int32, (C,), "seq"))
    N = C + H * Kc
    out = torch.empty(2 * N, dtype=torch.int64, device=time.device)
    scratch = torch.empty(_scratch_bytes(WINDOW_SORT, C), dtype=torch.uint8,
                          device=time.device)
    base = out.data_ptr()
    _launch(WINDOW_SORT, _PACK["window_sort"].pack(
        *ins, base, base + 8 * N, scratch.data_ptr(), scratch.numel(), C, H,
        Kc, int(win_start), int(win_end)), _stream(time))
    s_k1, perm = out.split(N)
    return s_k1, perm


# ---------------------------------------------------------------------------
# K20 pool_merge
# ---------------------------------------------------------------------------


class MergeBlock(NamedTuple):
    """One block of the merge's candidate rows, read where it lies:
    ``time``, ``src``, ``seq``, ``kind`` [n] and ``payload`` [n, PP];
    ``dst`` [n], or one value a host ([H], each host's n / H rows in turn);
    ``cut`` (None or [H] int32): row j of host h's run is empty (time
    NEVER) where j < cut[h]."""

    time: torch.Tensor
    dst: torch.Tensor
    src: torch.Tensor
    seq: torch.Tensor
    kind: torch.Tensor
    payload: torch.Tensor
    cut: torch.Tensor | None = None


class Merged(NamedTuple):
    """The next pool's columns, [C] each (``payload`` [C, PP]), and the
    rows dropped past the capacity (0-d int64)."""

    time: torch.Tensor
    dst: torch.Tensor
    src: torch.Tensor
    seq: torch.Tensor
    kind: torch.Tensor
    payload: torch.Tensor
    dropped: torch.Tensor


def block_rows(b):
    """A block's six columns, one row each: ``cut`` applied to the time
    and a host's dst repeated over its run."""
    n = b.time.shape[0]
    t, d = b.time, b.dst
    cut = getattr(b, "cut", None)
    if cut is not None:
        w = n // cut.shape[0]
        j = torch.arange(w, dtype=torch.int32, device=t.device)
        t = torch.where(j[None, :] >= cut[:, None], t.view(-1, w),
                        NEVER).reshape(-1)
    if d.shape[0] != n:
        d = d.repeat_interleave(n // d.shape[0])
    return t, d, b.src, b.seq, b.kind, b.payload


def pool_merge_plain(blocks, capacity: int) -> Merged:
    """Plain version: the blocks' rows concatenated in block order (the
    sort's ties depend on it), a stable sort by time, the first
    ``capacity`` rows gathered; dropped counts the rows past it whose time
    is not NEVER."""
    cols = list(zip(*(block_rows(b) for b in blocks)))
    s_t, order = torch.sort(torch.cat(cols[0]), stable=True)
    keep = order[:capacity]
    rest = [torch.cat(c)[keep] for c in cols[1:]]
    return Merged(s_t[:capacity], *rest,
                  dropped=(s_t[capacity:] != NEVER).sum())


def pool_merge(blocks, capacity: int) -> Merged:
    """The next pool: a stable sort by time of the blocks' rows in block
    order, truncated to ``capacity``, and the rows dropped past it. Each
    block has ``time``, ``dst``, ``src``, ``seq``, ``kind``, ``payload``
    and optionally ``cut`` (``MergeBlock``). On the card: one C entry that
    reads each block where it lies (at most ``MERGE_BLOCKS``)."""
    first = blocks[0].time
    if not _on_card(*(t for b in blocks for t in b if t is not None)):
        return pool_merge_plain(blocks, capacity)
    if not 0 < len(blocks) <= MERGE_BLOCKS:
        raise ValueError(f"pool_merge: 1 to {MERGE_BLOCKS} blocks, got "
                         f"{len(blocks)}")
    PP = blocks[0].payload.shape[-1]
    packed, M = [], 0
    for i, b in enumerate(blocks):
        n = b.time.shape[0]
        cut = getattr(b, "cut", None)
        nd = b.dst.shape[0]
        if nd < 1 or n % nd or (cut is not None and n % cut.shape[0]):
            raise ValueError(f"pool_merge: block {i}'s dst or cut does not "
                             f"divide its {n} rows")
        packed += [
            n, _check(b.time, torch.int64, (n,), f"block {i} time"),
            _check(b.dst, torch.int32, (nd,), f"block {i} dst"), n // nd,
            _check(b.src, torch.int32, (n,), f"block {i} src"),
            _check(b.seq, torch.int32, (n,), f"block {i} seq"),
            _check(b.kind, torch.int32, (n,), f"block {i} kind"),
            _check(b.payload, torch.int64, (n, PP), f"block {i} payload"),
            0 if cut is None else _check(cut, torch.int32, cut.shape,
                                         f"block {i} cut"),
            0 if cut is None else n // cut.shape[0]]
        M += n
    packed += [0] * (10 * (MERGE_BLOCKS - len(blocks)))
    C = int(capacity)
    if M < C:
        raise ValueError(f"pool_merge: {M} rows for a pool of {C}")
    dev = first.device
    # one allocation: time, payload and dropped as int64, then dst, src,
    # seq and kind as int32
    buf = torch.empty(C * (1 + PP) + 1 + 2 * C, dtype=torch.int64,
                      device=dev)
    scratch = torch.empty(_scratch_bytes(POOL_MERGE, M), dtype=torch.uint8,
                          device=dev)
    base = buf.data_ptr()
    b32 = base + 8 * (C * (1 + PP) + 1)
    _launch(POOL_MERGE, _PACK["pool_merge"].pack(
        len(blocks), C, PP, base, b32, b32 + 4 * C, b32 + 8 * C,
        b32 + 12 * C, base + 8 * C, base + 8 * C * (1 + PP),
        scratch.data_ptr(), scratch.numel(), *packed), _stream(first))
    t, p, dropped, i32 = buf.split_with_sizes([C, C * PP, 1, 2 * C])
    d, s, q, k = i32.view(torch.int32).split(C)
    return Merged(t, d, s, q, k, p.view(C, PP), dropped[0])


# ---------------------------------------------------------------------------
# K3 extract_slots
# ---------------------------------------------------------------------------


class DenseWindow(NamedTuple):
    """Each host's earliest Kc in-window events in (time, src, seq) order;
    cells past a host's events hold filler rows at time NEVER."""

    time: torch.Tensor  # [H, Kc] int64
    src: torch.Tensor  # [H, Kc] int32
    seq: torch.Tensor  # [H, Kc] int32
    kind: torch.Tensor  # [H, Kc] int32
    payload: torch.Tensor  # [H, Kc, PP] int64


class Tail(NamedTuple):
    """Every row not extracted, in the first sort's order: C rows."""

    time: torch.Tensor
    dst: torch.Tensor
    src: torch.Tensor
    seq: torch.Tensor
    kind: torch.Tensor
    payload: torch.Tensor  # [C, PP]


class Extracted(NamedTuple):
    """A window's extraction: the dense window and the tail."""

    dense: DenseWindow
    tail: Tail


def dense_slots(s_k1: torch.Tensor, H: int, Kc: int) -> torch.Tensor:
    """[N] int32 dense slot of each sorted window row: key * Kc + rank for
    the first Kc rows of each host run, N for every other row (the JAX
    package's boundary + cummax rank scan)."""
    N = s_k1.shape[0]
    s_key = s_k1 >> DT_BITS
    iota = torch.arange(N, dtype=torch.int64, device=s_k1.device)
    boundary = torch.ones(N, dtype=torch.bool, device=s_k1.device)
    boundary[1:] = s_key[1:] != s_key[:-1]
    run_start = torch.cummax(torch.where(boundary, iota, -1), dim=0).values
    rank = iota - run_start
    extract = (s_key < H) & (rank < Kc)
    return torch.where(extract, s_key * Kc + rank, N).to(torch.int32)


def place_rows(slot, perm, time, dst, src, seq, kind, payload, H: int,
               Kc: int) -> Extracted:
    """The JAX package's second sort: every sorted row, pool row or
    filler, gathered in stable order of its dense slot; the first H·Kc
    land as the dense window, the rest are the tail. Filler rows are time
    NEVER, dst = their host, src = seq = kind = 0 and a zero payload."""
    HK = H * Kc
    dev = time.device
    rows = perm[torch.sort(slot, stable=True).indices]

    def col(pool_col, filler):
        return torch.cat([pool_col, filler])[rows]

    z32 = torch.zeros(HK, dtype=torch.int32, device=dev)
    fill_dst = torch.arange(H, dtype=torch.int32,
                            device=dev).repeat_interleave(Kc)
    o_t = col(time, torch.full((HK,), NEVER, dtype=torch.int64, device=dev))
    o_s, o_q, o_k = col(src, z32), col(seq, z32), col(kind, z32)
    o_d = col(dst, fill_dst)
    PP = payload.shape[1]
    o_p = col(payload, torch.zeros((HK, PP), dtype=torch.int64, device=dev))
    return Extracted(
        DenseWindow(time=o_t[:HK].view(H, Kc), src=o_s[:HK].view(H, Kc),
                    seq=o_q[:HK].view(H, Kc), kind=o_k[:HK].view(H, Kc),
                    payload=o_p[:HK].view(H, Kc, PP)),
        Tail(time=o_t[HK:], dst=o_d[HK:], src=o_s[HK:], seq=o_q[HK:],
             kind=o_k[HK:], payload=o_p[HK:]),
    )


def extract_slots_plain(s_k1, perm, time, dst, src, seq, kind, payload,
                        H: int, Kc: int) -> Extracted:
    """Plain version, the JAX package's form: the rank scan, then the
    stable sort by slot and the gathers."""
    return place_rows(dense_slots(s_k1, H, Kc), perm, time, dst, src, seq,
                      kind, payload, H, Kc)


def extract_slots(s_k1, perm, time, dst, src, seq, kind, payload, H: int,
                  Kc: int) -> Extracted:
    """Place every row of the window's first sort: ``s_k1`` and ``perm``
    from ``window_sort`` (N = C + H·Kc sorted k1 keys and the row
    each came from: the C pool rows, whose columns follow, then H·Kc
    fillers, host-major). Returns the dense window and the tail, as the
    JAX package's rank scan and second sort leave them."""
    args = (s_k1, perm, time, dst, src, seq, kind, payload)
    if not _on_card(*args):
        return extract_slots_plain(*args, H, Kc)
    C = time.shape[0]
    PP = payload.shape[-1]
    N = C + H * Kc
    # the kernel places row i by the keys and gathers pool rows by perm,
    # so every input must have its type and length
    ins = []
    for t, dtype, n in ((s_k1, torch.int64, N), (perm, torch.int64, N),
                        (time, torch.int64, C), (dst, torch.int32, C),
                        (src, torch.int32, C), (seq, torch.int32, C),
                        (kind, torch.int32, C), (payload, torch.int64,
                                                 C * PP)):
        if t.dtype is not dtype or t.numel() != n or not t.is_contiguous():
            raise ValueError(f"extract_slots: want contiguous {dtype} of "
                             f"{n} elements, got {t.dtype} "
                             f"{tuple(t.shape)}")
        ins.append(t.data_ptr())
    # one allocation, each column of the N placed rows (dense slots, then
    # the tail) contiguous: time and payload as int64, then src, seq, kind
    # and the tail's dst as int32
    n64, n32 = N * (1 + PP), 3 * N + C
    buf = torch.empty(n64 + (n32 + 1) // 2, dtype=torch.int64,
                      device=time.device)
    base = buf.data_ptr()
    b32 = base + 8 * n64
    _launch(EXTRACT_SLOTS, _PACK["extract_slots"].pack(
        *ins, base, b32, b32 + 4 * N, b32 + 8 * N, base + 8 * N,
        b32 + 12 * N, N, C, H, Kc, PP), _stream(time))
    return _extract_views(buf, C, H, Kc, PP)


def _extract_views(buf: torch.Tensor, C: int, H: int, Kc: int,
                   PP: int) -> Extracted:
    """The views of ``extract_slots``' one allocation: two splits and the
    shapes."""
    HK, N = H * Kc, C + H * Kc
    n32 = 3 * N + C
    d_t, t_t, d_p, t_p, i32 = buf.split_with_sizes(
        [HK, C, HK * PP, C * PP, (n32 + 1) // 2])
    d_s, t_s, d_q, t_q, d_k, t_k, t_d, _ = i32.view(
        torch.int32).split_with_sizes([HK, C, HK, C, HK, C, C, n32 & 1])
    return Extracted(
        DenseWindow(time=d_t.view(H, Kc), src=d_s.view(H, Kc),
                    seq=d_q.view(H, Kc), kind=d_k.view(H, Kc),
                    payload=d_p.view(H, Kc, PP)),
        Tail(time=t_t, dst=t_d, src=t_s, seq=t_q, kind=t_k,
             payload=t_p.view(C, PP)),
    )


# ---------------------------------------------------------------------------
# K1 phold_forward
# ---------------------------------------------------------------------------


class ForwardOut(NamedTuple):
    """PHOLD's emissions for one window, [H*K] rows in (host, column)
    order, time NEVER where nothing was sent; plus the per-host state
    after the window and per-host tallies ``stats[:, i]`` for
    i = (events received, sends, emissions kept, bulk-contract
    violations)."""

    time: torch.Tensor  # [H*K] int64
    dst: torch.Tensor  # [H*K] int32
    src: torch.Tensor  # [H*K] int32
    seq: torch.Tensor  # [H*K] int32
    kind: torch.Tensor  # [H*K] int32
    payload: torch.Tensor  # [H*K, PP] int64
    rng_counter: torch.Tensor  # [H] int64 (uint32 values)
    seq_next: torch.Tensor  # [H] int32
    stats: torch.Tensor  # [H, 4] int64


@functools.lru_cache(maxsize=None)
def hot_split(num_hosts: int, hot_n: int, hot_share: float):
    """The hot variant's three float32 constants (Python floats, each a
    float32 value): the split ``hs``, and the scales of the hot and the
    cold draw. The JAX package writes ``floor(u / hs * nh)`` and
    ``floor((u - hs) / (1 - hs) * (H - nh))``; jitted, XLA folds each
    division by a constant into a multiply by its float32 reciprocal and
    the two constant factors into one, so the draws are
    ``floor(u * f32(f32(1 / hs) * nh))`` and
    ``floor((u - hs) * f32(f32(1 / f32(1 - hs)) * (H - nh)))``, ``1 - hs``
    taken in double and rounded once. All 0 without a hot split."""
    if not hot_n:
        return 0.0, 0.0, 0.0
    f32 = np.float32
    hs = f32(hot_share)
    c_hot = f32(f32(f32(1) / hs) * f32(hot_n))
    c_cold = f32(f32(f32(1) / f32(1.0 - hot_share)) * f32(num_hosts - hot_n))
    return float(hs), float(c_hot), float(c_cold)


def pick_dst(u: torch.Tensor, my_id: torch.Tensor, num_hosts: int,
             hot_n: int = 0, hot_share: float = 0.0, local_span: int = 0):
    """PHOLD's destination for a float32 uniform draw, as the JAX package's
    ``PholdApp._pick_dst`` computes it: with ``local_span`` a nonzero ring
    offset in [-span, span] (``ring_offset_dst``, a floor mod); with
    ``hot_n`` the first ``hot_share`` of the unit interval to the first
    ``hot_n`` hosts and the rest to the others (``hot_split``; self-sends
    allowed), clipped to [0, H - 1]; else uniform, skipping self
    (``floor(u * (H - 1))`` clipped to [0, H - 2])."""
    if local_span > 0:
        span = local_span
        off = torch.floor(u * float(2 * span)).to(torch.int32)
        off = off.clamp(0, 2 * span - 1) - span
        off = off + (off >= 0).to(torch.int32)
        return torch.remainder(my_id + off, num_hosts).to(torch.int32)
    if hot_n > 0:
        hs, c_hot, c_cold = hot_split(num_hosts, hot_n, hot_share)
        hot = torch.floor(u * c_hot).to(torch.int32)
        cold = hot_n + torch.floor((u - hs) * c_cold).to(torch.int32)
        return torch.where(u < hs, hot, cold).clamp(0, num_hosts - 1)
    if num_hosts <= 1:
        return my_id.expand(u.shape).to(torch.int32)
    d = torch.floor(u * float(num_hosts - 1)).to(torch.int32)
    d = d.clamp(0, num_hosts - 2)
    return d + (d >= my_id).to(torch.int32)


def phold_forward_plain(d_t, d_p, rng_keys, rng_counter, seq_next, gid,
                        vertex, latency_vv, reliability_vv, vertex_g, *,
                        num_hosts: int, stop_sending: int,
                        bootstrap_end: int, win_end: int, kind: int,
                        hot_n: int = 0, hot_share: float = 0.0,
                        local_span: int = 0) -> ForwardOut:
    """Plain version, vectorized over [H, K] as the JAX package computes
    it: event k's draws sit at counters c0 + 2·(sends before k) and +1."""
    H, K = d_t.shape
    valid = d_t != NEVER
    send = valid & (d_t < stop_sending)
    si = send.to(torch.int64)
    excl = torch.cumsum(si, dim=1) - si
    off = (rng_counter[:, None] + 2 * excl) & rng.M32
    u1 = rng.uniform_matrix(rng_keys, off)
    u2 = rng.uniform_matrix(rng_keys, (off + 1) & rng.M32)
    my_id = gid[:, None]
    dst = pick_dst(u1, my_id, num_hosts, hot_n, hot_share, local_span)
    if latency_vv.shape[0] == 1:
        lat = latency_vv[0, 0].expand(H, K)
        rel = reliability_vv[0, 0].expand(H, K)
    else:
        table = vertex_g if vertex_g is not None else vertex
        vd = table[dst.to(torch.int64)].to(torch.int64)
        vs = vertex[:, None].to(torch.int64).expand(H, K)
        lat = latency_vv[vs, vd]
        rel = reliability_vv[vs, vd]
    kept = (d_t < bootstrap_end) | (u2 < rel)
    emit = send & kept
    t_e = d_t + lat
    ei = emit.to(torch.int32)
    e_excl = torch.cumsum(ei, dim=1, dtype=torch.int32) - ei
    n_emit = ei.sum(dim=1, dtype=torch.int32)
    viol = emit & (dst == my_id) & (t_e < win_end)
    stats = torch.stack([
        valid.sum(dim=1), send.sum(dim=1), emit.sum(dim=1),
        viol.sum(dim=1),
    ], dim=1).to(torch.int64)
    return ForwardOut(
        time=torch.where(emit, t_e, NEVER).reshape(-1),
        dst=dst.reshape(-1),
        src=my_id.expand(H, K).reshape(-1).to(torch.int32),
        seq=(seq_next[:, None] + e_excl).reshape(-1),
        kind=torch.full((H * K,), kind, dtype=torch.int32,
                        device=d_t.device),
        payload=d_p.reshape(H * K, -1),
        rng_counter=(rng_counter + 2 * si.sum(dim=1)) & rng.M32,
        seq_next=seq_next + n_emit,
        stats=stats,
    )


def phold_forward(d_t, d_p, rng_keys, rng_counter, seq_next, gid, vertex,
                  latency_vv, reliability_vv, vertex_g, *, num_hosts: int,
                  stop_sending: int, bootstrap_end: int, win_end: int,
                  kind: int, hot_n: int = 0, hot_share: float = 0.0,
                  local_span: int = 0) -> ForwardOut:
    """PHOLD forward over one window's [H, K] dense events: draws, the
    destination pick (``pick_dst``'s three modes), latency and loss, and
    the numbered emission rows. ``d_t`` holds the times the events
    execute at (the CPU model's shifted times where it is on)."""
    args = (d_t, d_p, rng_keys, rng_counter, seq_next, gid, vertex,
            latency_vv, reliability_vv)
    if not _on_card(*args, *(() if vertex_g is None else (vertex_g,))):
        return phold_forward_plain(
            *args, vertex_g, num_hosts=num_hosts, stop_sending=stop_sending,
            bootstrap_end=bootstrap_end, win_end=win_end, kind=kind,
            hot_n=hot_n, hot_share=hot_share, local_span=local_span,
        )
    H, K = d_t.shape
    PP = d_p.shape[-1]
    U = latency_vv.shape[0]
    dev = d_t.device
    table = vertex_g if vertex_g is not None else vertex
    ins = (
        _check(d_t, torch.int64, (H, K), "d_t"),
        _check(d_p, torch.int64, (H, K, PP), "d_p"),
        _check(rng_keys, torch.int64, (H, 2), "rng_keys"),
        _check(rng_counter, torch.int64, (H,), "rng_counter"),
        _check(seq_next, torch.int32, (H,), "seq_next"),
        _check(gid, torch.int32, (H,), "gid"),
        _check(vertex, torch.int32, (H,), "vertex"),
        _check(table, torch.int32, (table.shape[0],), "vertex_g"),
        _check(latency_vv, torch.int64, (U, U), "latency_vv"),
        _check(reliability_vv, torch.float32, (U, U), "reliability_vv"),
    )
    if U > 1 and table.shape[0] < num_hosts:
        raise ValueError("vertex table shorter than the host count")
    e32 = lambda: torch.empty(H * K, dtype=torch.int32,  # noqa: E731
                              device=dev)
    out = ForwardOut(
        time=torch.empty(H * K, dtype=torch.int64, device=dev),
        dst=e32(), src=e32(), seq=e32(), kind=e32(),
        payload=torch.empty((H * K, PP), dtype=torch.int64, device=dev),
        rng_counter=torch.empty(H, dtype=torch.int64, device=dev),
        seq_next=torch.empty(H, dtype=torch.int32, device=dev),
        stats=torch.empty((H, 4), dtype=torch.int64, device=dev),
    )
    hs, c_hot, c_cold = hot_split(num_hosts, hot_n, hot_share)
    _launch(PHOLD_FORWARD, *ins, *(t.data_ptr() for t in out),
            H, K, PP, U, num_hosts, stop_sending, bootstrap_end, win_end,
            kind, hot_n, hs, c_hot, c_cold, local_span, _stream(d_t))
    return out


def phold_pick(u, my_id, num_hosts: int, hot_n: int = 0,
               hot_share: float = 0.0, local_span: int = 0) -> torch.Tensor:
    """``phold_forward``'s device function ``pick_dst`` alone, on given
    float32 draws ``u`` and senders ``my_id`` (int32, u's shape), on the
    card: the check entry that sweeps the draws around every split of the
    destination modes, which the forward's own threefry draws cannot aim
    at. Not on any path, so it counts no launch."""
    if not _on_card(u, my_id):
        raise ValueError("phold_pick runs on the card only (pick_dst is "
                         "its plain version)")
    n = u.numel()
    _check(u, torch.float32, u.shape, "u")
    _check(my_id, torch.int32, u.shape, "my_id")
    out = torch.empty_like(my_id)
    hs, c_hot, c_cold = hot_split(num_hosts, hot_n, hot_share)
    _call(PHOLD_FORWARD, "phold_pick", u.data_ptr(), my_id.data_ptr(),
          out.data_ptr(), n, num_hosts, hot_n, hs, c_hot, c_cold,
          local_span, _stream(u))
    return out


# ---------------------------------------------------------------------------
# K2 audit_commit
# ---------------------------------------------------------------------------


class CommitOut(NamedTuple):
    """Per-host state after committing one window, [H] each."""

    host_digest: torch.Tensor  # int64 audit chain
    host_events: torch.Tensor  # int64 committed events
    host_last_t: torch.Tensor  # int64 committed frontier
    done_t: torch.Tensor  # int64 progress clock
    n_valid: torch.Tensor  # int64 events committed this window


def audit_commit_plain(d_t, e_t, d_s, d_k, gid, host_digest, host_events,
                       host_last_t, done_t) -> CommitOut:
    """Plain version: the JAX package's fold over the K columns in order,
    keyed on the event times ``d_t``; the frontiers take the latest of the
    times ``e_t`` the events executed at."""
    from shadow_tpu_torch.obs import audit

    valid = d_t != NEVER
    keys = audit.event_key(d_t, d_s, gid[:, None], d_k)
    hd = host_digest
    for j in range(d_t.shape[1]):
        hd = torch.where(valid[:, j], hd * audit.CHAIN_MULT + keys[:, j],
                         hd)
    n = valid.sum(dim=1)
    last_t = torch.where(valid, e_t, -1).amax(dim=1)
    return CommitOut(
        host_digest=hd,
        host_events=host_events + n,
        host_last_t=torch.where(n > 0, last_t, host_last_t),
        done_t=torch.where(n > 0, last_t, done_t),
        n_valid=n,
    )


def audit_commit(d_t, e_t, d_s, d_k, gid, host_digest, host_events,
                 host_last_t, done_t) -> CommitOut:
    """Commit one window's [H, K] dense events per host: fold each event
    into the audit chain in column order (its time ``d_t``), count it,
    advance the frontier to the latest time ``e_t`` one executed at (the
    CPU model's shifted times; ``d_t`` itself where the model is off)."""
    args = (d_t, e_t, d_s, d_k, gid, host_digest, host_events, host_last_t,
            done_t)
    if not _on_card(*args):
        return audit_commit_plain(*args)
    H, K = d_t.shape
    dev = d_t.device
    ins = (
        _check(d_t, torch.int64, (H, K), "d_t"),
        _check(e_t, torch.int64, (H, K), "e_t"),
        _check(d_s, torch.int32, (H, K), "d_s"),
        _check(d_k, torch.int32, (H, K), "d_k"),
        _check(gid, torch.int32, (H,), "gid"),
        _check(host_digest, torch.int64, (H,), "host_digest"),
        _check(host_events, torch.int64, (H,), "host_events"),
        _check(host_last_t, torch.int64, (H,), "host_last_t"),
        _check(done_t, torch.int64, (H,), "done_t"),
    )
    out = CommitOut(*(torch.empty(H, dtype=torch.int64, device=dev)
                      for _ in range(5)))
    _launch(AUDIT_COMMIT, *ins, *(t.data_ptr() for t in out), H, K,
            _stream(d_t))
    return out


# ---------------------------------------------------------------------------
# K21 cpu_serialize
# ---------------------------------------------------------------------------

# the matrix form's floor for an empty cell (the JAX package's sentinel)
CPU_EMPTY = -(1 << 62)


class Serialized(NamedTuple):
    """The CPU model's result for one window pass (matrix) or micro-step
    (loop)."""

    exec_t: torch.Tensor  # [H, W] int64: when each event executes
    cpu_avail: torch.Tensor  # [H] int64: each host's CPU free from
    delay: torch.Tensor  # [] int64: sum of exec - time over real events


def cpu_serialize_plain(t, cost, cpu_avail, matrix: bool) -> Serialized:
    """Plain version: each host's events, in column order, execute at
    ``exec_k = max(t_k, exec_{k-1} + cost)`` from ``exec_{-1} + cost =
    cpu_avail``, each path in the JAX package's own form (they agree where
    a host's real events, time != NEVER, are a prefix of its row).

    ``matrix`` (``run_matrix``, shadow_tpu/core/engine.py:1224-1254): a
    cummax of ``t_k - k·cost`` over real cells (``CPU_EMPTY`` on empty
    ones) floored at ``cpu_avail``; an empty cell keeps its time; the last
    exec time is the cell at index (real count - 1). Else the loop body's
    chain (engine.py:904-966) over every column, empty ones included
    (where ``NEVER + cost`` wraps); the last exec time is the last real
    column's. ``cpu_avail`` moves to last + cost where the host has a real
    event (column 0's, on the loop path)."""
    H, W = t.shape
    valid = t != NEVER
    if matrix:
        c = cost[:, None]
        ks = torch.arange(W, dtype=torch.int64, device=t.device)[None, :]
        shifted = torch.where(valid, t - ks * c, CPU_EMPTY)
        u = torch.cummax(shifted, dim=1).values
        u = torch.maximum(u, cpu_avail[:, None])
        exec_t = torch.where(valid, u + ks * c, t)
        n = valid.sum(dim=1)
        last = exec_t.gather(1, (n - 1).clamp(min=0)[:, None])[:, 0]
        busy = n > 0
    else:
        cols = [torch.maximum(t[:, 0], cpu_avail)]
        last = cols[0]
        for k in range(1, W):
            cols.append(torch.maximum(t[:, k], cols[-1] + cost))
            last = torch.where(valid[:, k], cols[-1], last)
        exec_t = torch.stack(cols, dim=1)
        busy = valid[:, 0]
    return Serialized(
        exec_t=exec_t,
        cpu_avail=torch.where(busy, last + cost, cpu_avail),
        delay=torch.where(valid, exec_t - t, 0).sum(),
    )


def cpu_serialize(t, cost, cpu_avail, matrix: bool) -> Serialized:
    """The CPU model over one window's [H, W] event times (``matrix``: the
    dense window, W = K) or one micro-step's taken events (W = G): one
    launch, a thread a host; the delay sum is exact (int64 atomics)."""
    if not _on_card(t, cost, cpu_avail):
        return cpu_serialize_plain(t, cost, cpu_avail, matrix)
    H, W = t.shape
    ins = (_check(t, torch.int64, (H, W), "t"),
           _check(cost, torch.int64, (H,), "cost"),
           _check(cpu_avail, torch.int64, (H,), "cpu_avail"))
    buf = torch.empty(H * W + H + 1, dtype=torch.int64, device=t.device)
    _launch(CPU_SERIALIZE, *ins, buf.data_ptr(), H, W, int(bool(matrix)),
            _stream(t))
    return Serialized(
        exec_t=buf[:H * W].view(H, W), cpu_avail=buf[H * W:H * W + H],
        delay=buf[H * W + H])


# ---------------------------------------------------------------------------
# K4 loop_select
# ---------------------------------------------------------------------------

# hosts a block of the kernel plans (kThreads in csrc/loop_select.cu)
SELECT_BLOCK = 128


def key_lt(t1, s1, q1, t2, s2, q2):
    """(t1, s1, q1) < (t2, s2, q2) lexicographically."""
    return (t1 < t2) | ((t1 == t2) & ((s1 < s2) | ((s1 == s2) & (q1 < q2))))


def inbox_min(t, s, q):
    """Per-host minimum of the inbox by (time, src, seq), by the JAX
    package's tournament (``engine.py:_inbox_min``): on ties the first half
    wins, and an odd round pads its second half with (NEVER, 0, 0, slot 0).
    Returns (time, src, seq, slot) each [H]."""
    H, B = t.shape
    slot = torch.arange(B, dtype=torch.int32, device=t.device).expand(H, B)
    while B > 1:
        half = (B + 1) // 2
        pad = half - (B - half)
        t1, s1, q1, i1 = t[:, :half], s[:, :half], q[:, :half], slot[:, :half]
        t2, s2, q2, i2 = t[:, half:], s[:, half:], q[:, half:], slot[:, half:]
        if pad:
            def F(x, v=0):
                return torch.cat([x, torch.full((H, pad), v, dtype=x.dtype,
                                                device=x.device)], dim=1)
            t2, s2, q2, i2 = F(t2, NEVER), F(s2), F(q2), F(i2)
        take2 = key_lt(t2, s2, q2, t1, s1, q1)
        t = torch.where(take2, t2, t1)
        s = torch.where(take2, s2, s1)
        q = torch.where(take2, q2, q1)
        slot = torch.where(take2, i2, i1)
        B = half
    return t[:, 0], s[:, 0], q[:, 0], slot[:, 0]


class SelectOut(NamedTuple):
    """One micro-step's choice per host. ``take_*`` [H, G]: column 0 the
    head event, columns 1.. the bulk batch, time NEVER and zeros where
    nothing is taken; plus the gates' verdicts, the advanced dense cursor
    and the inbox with the taken slot cleared."""

    take_t: torch.Tensor  # [H, G] int64
    take_s: torch.Tensor  # [H, G] int32
    take_q: torch.Tensor  # [H, G] int32
    take_k: torch.Tensor  # [H, G] int32
    take_p: torch.Tensor  # [H, G, PP] int64
    valid: torch.Tensor  # [H] bool
    stalled: torch.Tensor  # [H] bool
    ptr: torch.Tensor  # [H] int32
    inbox_time: torch.Tensor  # [H, B] int64


def loop_select_plain(d_t, d_s, d_q, d_k, d_p, ptr, i_t, i_s, i_q, i_k, i_p,
                      o_count, gate, gid, need_by_kind, *, K: int, G: int,
                      O: int, bulk_kind: int, self_excluded: bool,
                      win_end: int, pool_budget: int) -> SelectOut:
    """Plain version, the JAX package's micro-step selection: the dense
    head at ``ptr`` against the inbox minimum, the bulk batch over up to
    G - 1 further dense columns, ``need`` from the per-kind emission table,
    the outbox-room and pool-headroom gates (an exclusive cumsum of the
    hot hosts' need in host order on top of the rows the boxes hold).
    ``bulk_kind`` < 0 or G == 1 plans no batch; ``gate`` None applies no
    per-host batch limit."""
    H = d_t.shape[0]
    dev = d_t.device
    rows = torch.arange(H, device=dev)
    p0 = ptr.to(torch.int64)
    m_t_raw, m_s, m_q, m_k = (x[rows, p0] for x in (d_t, d_s, d_q, d_k))
    in_run = (ptr < K) & (m_t_raw != NEVER)
    m_t = torch.where(in_run, m_t_raw, NEVER)
    i_time, i_src, i_seq, i_slot = inbox_min(i_t, i_s, i_q)
    islot = i_slot.to(torch.int64)
    use_inbox = key_lt(i_time, i_src, i_seq, m_t, m_s, m_q)
    ev_t = torch.where(use_inbox, i_time, m_t)
    ev_k = torch.where(use_inbox, i_k[rows, islot], m_k)
    ev_s = torch.where(use_inbox, i_src, m_s)
    ev_q = torch.where(use_inbox, i_seq, m_q)
    ev_p = torch.where(use_inbox[:, None], i_p[rows, islot], d_p[rows, p0])

    # the bulk batch: the g-th further column joins while every column
    # before it did (a running AND along g)
    g_extra = torch.zeros(H, dtype=torch.int32, device=dev)
    ok = None
    if bulk_kind >= 0 and G > 1:
        prev = (ev_t < win_end) & ~use_inbox & (ev_k == bulk_kind)
        if self_excluded:
            prev = prev & (m_s != gid)
        if gate is not None:
            prev = prev & (gate > 0)
        g = torch.arange(1, G, dtype=torch.int32, device=dev)[None, :]
        cg = ptr[:, None] + g
        ing = cg < K
        col = torch.where(ing, cg, 0).to(torch.int64)
        tg_r, sg, qg, kg = (x.gather(1, col) for x in (d_t, d_s, d_q, d_k))
        ing = ing & (tg_r != NEVER)
        tg = torch.where(ing, tg_r, NEVER)
        okg = (ing & (kg == bulk_kind) & (tg < win_end)
               & key_lt(tg, sg, qg, i_time[:, None], i_src[:, None],
                        i_seq[:, None]))
        if self_excluded:
            okg = okg & (sg != gid[:, None])
        if gate is not None:
            okg = okg & (gate[:, None] >= g)
        ok = (prev[:, None] & okg).to(torch.int32).cummin(dim=1).values
        g_extra = ok.sum(dim=1, dtype=torch.int32)
        ok = ok.bool()

    NK = need_by_kind.shape[0]
    known = (ev_k >= 0) & (ev_k < NK)
    need_base = torch.where(
        known, need_by_kind[ev_k.clamp(0, NK - 1).to(torch.int64)], 0)
    need = need_base * (1 + g_extra)
    room = (o_count + need) <= O
    hot = ev_t < win_end
    box_used = o_count.sum() + (i_t != NEVER).sum()
    need_hot = torch.where(hot, need, 0).to(torch.int64)
    cum = torch.cumsum(need_hot, dim=0) - need_hot
    fits = (box_used + cum + need_hot) <= pool_budget
    valid = hot & room & fits
    stalled = hot & ~(room & fits)

    take_t = torch.where(valid, ev_t, NEVER)[:, None]
    take_s, take_q, take_k = (torch.where(valid, x, 0)[:, None]
                              for x in (ev_s, ev_q, ev_k))
    take_p = torch.where(valid[:, None], ev_p, 0)[:, None, :]
    extra = 0
    if ok is not None:
        bv = ok & valid[:, None]
        extra = bv.sum(dim=1, dtype=torch.int32)
        pg = d_p[rows[:, None], col]
        take_t = torch.cat([take_t, torch.where(bv, tg, NEVER)], dim=1)
        take_s, take_q, take_k = (
            torch.cat([a, torch.where(bv, b, 0)], dim=1)
            for a, b in ((take_s, sg), (take_q, qg), (take_k, kg)))
        take_p = torch.cat([take_p, torch.where(bv[:, :, None], pg, 0)],
                           dim=1)
    elif G > 1:
        pad = lambda x, v: torch.cat(  # noqa: E731
            [x, torch.full((H, G - 1) + x.shape[2:], v, dtype=x.dtype,
                           device=dev)], dim=1)
        take_t = pad(take_t, NEVER)
        take_s, take_q, take_k, take_p = (pad(x, 0) for x in
                                          (take_s, take_q, take_k, take_p))
    new_ptr = torch.where(valid & ~use_inbox, ptr + 1 + extra, ptr)
    bcols = torch.arange(i_t.shape[1], dtype=torch.int64, device=dev)
    clear = (valid & use_inbox)[:, None] & (bcols[None, :] == islot[:, None])
    return SelectOut(
        take_t=take_t, take_s=take_s, take_q=take_q, take_k=take_k,
        take_p=take_p, valid=valid, stalled=stalled,
        ptr=new_ptr.to(torch.int32),
        inbox_time=torch.where(clear, NEVER, i_t),
    )


def loop_select(d_t, d_s, d_q, d_k, d_p, ptr, i_t, i_s, i_q, i_k, i_p,
                o_count, gate, gid, need_by_kind, *, K: int, G: int, O: int,
                bulk_kind: int, self_excluded: bool, win_end: int,
                pool_budget: int) -> SelectOut:
    """Choose each host's event(s) for one micro-step (see
    ``loop_select_plain``). On the card: one thread a host over
    ``ceil(H / SELECT_BLOCK)`` blocks, in two launches (plan, then the
    headroom gate's prefix and the outputs) that count as one call."""
    args = (d_t, d_s, d_q, d_k, d_p, ptr, i_t, i_s, i_q, i_k, i_p, o_count,
            gid, need_by_kind)
    kw = dict(K=K, G=G, O=O, bulk_kind=bulk_kind,
              self_excluded=self_excluded, win_end=win_end,
              pool_budget=pool_budget)
    if not _on_card(*args, *(() if gate is None else (gate,))):
        return loop_select_plain(*args[:12], gate, gid, need_by_kind, **kw)
    H, Kc = d_t.shape
    B = i_t.shape[1]
    PP = d_p.shape[-1]
    NK = need_by_kind.shape[0]
    if B < 1 or K >= Kc or G < 1:
        raise ValueError(f"loop_select: want B >= 1, K < Kc and G >= 1, "
                         f"got B={B} K={K} Kc={Kc} G={G}")
    dev = d_t.device
    ins = (
        _check(d_t, torch.int64, (H, Kc), "d_t"),
        _check(d_s, torch.int32, (H, Kc), "d_s"),
        _check(d_q, torch.int32, (H, Kc), "d_q"),
        _check(d_k, torch.int32, (H, Kc), "d_k"),
        _check(d_p, torch.int64, (H, Kc, PP), "d_p"),
        _check(ptr, torch.int32, (H,), "ptr"),
        _check(i_t, torch.int64, (H, B), "i_t"),
        _check(i_s, torch.int32, (H, B), "i_s"),
        _check(i_q, torch.int32, (H, B), "i_q"),
        _check(i_k, torch.int32, (H, B), "i_k"),
        _check(i_p, torch.int64, (H, B, PP), "i_p"),
        _check(o_count, torch.int32, (H,), "o_count"),
        0 if gate is None else _check(gate, torch.int32, (H,), "gate"),
        _check(gid, torch.int32, (H,), "gid"),
        _check(need_by_kind, torch.int32, (NK,), "need_by_kind"),
    )
    e = lambda dt, *sh: torch.empty(sh, dtype=dt, device=dev)  # noqa: E731
    out = SelectOut(
        take_t=e(torch.int64, H, G), take_s=e(torch.int32, H, G),
        take_q=e(torch.int32, H, G), take_k=e(torch.int32, H, G),
        take_p=e(torch.int64, H, G, PP), valid=e(torch.bool, H),
        stalled=e(torch.bool, H), ptr=e(torch.int32, H),
        inbox_time=e(torch.int64, H, B),
    )
    # the block totals, the plan words, the needs and the inbox slots
    blocks = -(-H // SELECT_BLOCK)
    scratch = torch.empty(16 * blocks + 12 * H, dtype=torch.uint8,
                          device=dev)
    _launch(LOOP_SELECT, *ins, *(t.data_ptr() for t in out),
            scratch.data_ptr(), scratch.numel(), H, Kc, B, PP, NK, K, G,
            win_end, pool_budget, O, bulk_kind, int(self_excluded),
            _stream(d_t))
    return out


# ---------------------------------------------------------------------------
# K5 loop_route
# ---------------------------------------------------------------------------


class Boxes(NamedTuple):
    """The per-host inbox [H, B] and outbox [H, O] of the micro-step loop
    (the JAX package's ``_Inbox`` / ``_Outbox``), payloads packed."""

    i_t: torch.Tensor  # [H, B] int64, NEVER = free
    i_s: torch.Tensor  # [H, B] int32
    i_q: torch.Tensor  # [H, B] int32
    i_k: torch.Tensor  # [H, B] int32
    i_p: torch.Tensor  # [H, B, PP] int64
    o_t: torch.Tensor  # [H, O] int64
    o_d: torch.Tensor  # [H, O] int32
    o_s: torch.Tensor  # [H, O] int32
    o_q: torch.Tensor  # [H, O] int32
    o_k: torch.Tensor  # [H, O] int32
    o_p: torch.Tensor  # [H, O, PP] int64
    o_count: torch.Tensor  # [H] int32

    @classmethod
    def empty(cls, H: int, B: int, O: int, PP: int, device=None) -> "Boxes":
        z = lambda *sh: torch.zeros(sh, dtype=torch.int32,  # noqa: E731
                                    device=device)
        return cls(
            i_t=torch.full((H, B), NEVER, dtype=torch.int64, device=device),
            i_s=z(H, B), i_q=z(H, B), i_k=z(H, B),
            i_p=torch.zeros((H, B, PP), dtype=torch.int64, device=device),
            o_t=torch.full((H, O), NEVER, dtype=torch.int64, device=device),
            o_d=z(H, O), o_s=z(H, O), o_q=z(H, O), o_k=z(H, O),
            o_p=torch.zeros((H, O, PP), dtype=torch.int64, device=device),
            o_count=z(H),
        )


class RouteOut(NamedTuple):
    """The boxes after routing, the advanced seq counters, and per-host
    tallies ``stats[:, i]`` for i = (events emitted, self emissions
    deferred for a full inbox, outbox overflow drops)."""

    boxes: Boxes
    seq_next: torch.Tensor  # [H] int32
    stats: torch.Tensor  # [H, 3] int64


def loop_route_plain(m, t, d, k, p, seq_next, gid, defer_t, defer_s, defer_q,
                     boxes: Boxes, *, win_end: int) -> RouteOut:
    """Plain version of the JAX package's routing loop over the records in
    emit order: number each from ``seq_next``; a self emission inside the
    window whose key precedes the host's deferred key goes to the first
    free inbox slot (or, with none free, is deferred through the outbox);
    every other goes to the outbox at ``count``, dropped where full.

    The records are taken all at once: inserts only fill inbox slots, so
    record e inserts iff it is a self emission and fewer than the free
    slots went to the self emissions before it, and it lands in the
    free slot of that rank; the outbox position is ``count`` plus the
    outbox-bound records before it."""
    bx = boxes
    O = bx.o_t.shape[1]
    dev = gid.device

    def excl(x):  # exclusive cumsum along the records
        x = x.to(torch.int32)
        return torch.cumsum(x, dim=0, dtype=torch.int32) - x

    seq = seq_next[None, :] + excl(m)
    is_self = (m & (d == gid[None, :]) & (t < win_end)
               & key_lt(t, gid[None, :], seq, defer_t[None, :],
                        defer_s[None, :], defer_q[None, :]))
    free = bx.i_t == NEVER
    ins = is_self & (excl(is_self) < free.sum(dim=1, dtype=torch.int32))
    to_out = m & ~ins
    pos = bx.o_count[None, :] + excl(to_out)
    put = to_out & (pos < O)
    rank = excl(free.T).T  # the rank of each free inbox slot
    src = gid[None, :].expand_as(m)

    def place(hit, cols, olds):
        # hit [E, H, S]: record e lands in slot s; at most one e per slot
        any_hit = hit.any(dim=0)
        out = []
        for c, old in zip(cols, olds):
            h = hit if c.dim() == 2 else hit[..., None]
            v = c[:, :, None] if c.dim() == 2 else c[:, :, None, :]
            got = torch.where(h, v, 0).sum(dim=0, dtype=old.dtype)
            a = any_hit if old.dim() == 2 else any_hit[..., None]
            out.append(torch.where(a, got, old))
        return out

    in_rank = excl(is_self)
    hit_in = (ins[:, :, None] & free[None, :, :]
              & (in_rank[:, :, None] == rank[None, :, :]))
    i_t, i_s, i_q, i_k, i_p = place(
        hit_in, (t, src, seq, k, p), (bx.i_t, bx.i_s, bx.i_q, bx.i_k, bx.i_p))
    ocols = torch.arange(O, dtype=torch.int32, device=dev)
    hit_out = put[:, :, None] & (pos[:, :, None] == ocols)
    o_t, o_d, o_s, o_q, o_k, o_p = place(
        hit_out, (t, d, src, seq, k, p),
        (bx.o_t, bx.o_d, bx.o_s, bx.o_q, bx.o_k, bx.o_p))
    stats = torch.stack([m, is_self & ~ins, to_out & ~put],
                        dim=-1).sum(dim=0, dtype=torch.int64)
    return RouteOut(
        boxes=Boxes(i_t, i_s, i_q, i_k, i_p, o_t, o_d, o_s, o_q, o_k, o_p,
                    bx.o_count + put.sum(dim=0, dtype=torch.int32)),
        seq_next=seq_next + m.sum(dim=0, dtype=torch.int32),
        stats=stats,
    )


def loop_route(m, t, d, k, p, seq_next, gid, defer_t, defer_s, defer_q,
               boxes: Boxes, *, win_end: int) -> RouteOut:
    """Route one micro-step's E emission records, stacked [E, H] (payload
    [E, H, PP] packed), into the boxes (see ``loop_route_plain``).

    On the card the kernel writes into ``boxes`` in place and returns
    them as ``RouteOut.boxes``, the very tensors it was given: the
    micro-step loop owns its boxes (``Simulation.step_loop`` makes them
    each window and replaces them with each call's result), so nothing
    reads the rows as they were. The plain version, on the CPU, returns
    new tensors. Either way the caller takes the boxes from the result
    and does not read the ones it passed; to compare the two versions,
    hand the kernel a clone."""
    args = (m, t, d, k, p, seq_next, gid, defer_t, defer_s, defer_q)
    if not _on_card(*args, *boxes):
        return loop_route_plain(*args, boxes, win_end=win_end)
    E, H = m.shape
    B, O = boxes.i_t.shape[1], boxes.o_t.shape[1]
    PP = p.shape[-1]
    dev = m.device
    ins = (
        _check(m, torch.bool, (E, H), "mask"),
        _check(t, torch.int64, (E, H), "time"),
        _check(d, torch.int32, (E, H), "dst"),
        _check(k, torch.int32, (E, H), "kind"),
        _check(p, torch.int64, (E, H, PP), "payload"),
        _check(seq_next, torch.int32, (H,), "seq_next"),
        _check(gid, torch.int32, (H,), "gid"),
        _check(defer_t, torch.int64, (H,), "defer_t"),
        _check(defer_s, torch.int32, (H,), "defer_s"),
        _check(defer_q, torch.int32, (H,), "defer_q"),
    )
    shapes = ((torch.int64, (H, B)), (torch.int32, (H, B)),
              (torch.int32, (H, B)), (torch.int32, (H, B)),
              (torch.int64, (H, B, PP)), (torch.int64, (H, O)),
              (torch.int32, (H, O)), (torch.int32, (H, O)),
              (torch.int32, (H, O)), (torch.int32, (H, O)),
              (torch.int64, (H, O, PP)), (torch.int32, (H,)))
    bins = tuple(_check(x, dt, sh, f"boxes.{n}") for x, (dt, sh), n in
                 zip(boxes, shapes, Boxes._fields))
    out = RouteOut(boxes=boxes,
                   seq_next=torch.empty(H, dtype=torch.int32, device=dev),
                   stats=torch.empty((H, 3), dtype=torch.int64, device=dev))
    _launch(LOOP_ROUTE, *ins, *bins, out.seq_next.data_ptr(),
            out.stats.data_ptr(), E, H, B, O, PP, win_end, _stream(m))
    return out


# ---------------------------------------------------------------------------
# K6 codel_dequeue
# ---------------------------------------------------------------------------

# CoDel's constants and the packet words it reads (shadow_tpu/net/codel.py,
# shadow_tpu/net/packet.py); net/codel.py and net/packet.py take theirs
# from here
CODEL_TARGET_NS = 10_000_000
CODEL_INTERVAL_NS = 100_000_000
W_PROTO, W_LEN, W_TRAIL = 0, 3, 12
PROTO_TCP = 6
UDP_HEADER_BYTES, TCP_HEADER_BYTES = 28, 40
MTU = 1500


def wire_bytes(payload: torch.Tensor) -> torch.Tensor:
    """[..., P] int32 packet words → int64 wire size (payload + header)."""
    hdr = torch.where(payload[..., W_PROTO] == PROTO_TCP, TCP_HEADER_BYTES,
                      UDP_HEADER_BYTES)
    return (payload[..., W_LEN] + hdr).to(torch.int64)


def control_law(count: torch.Tensor, ts: torch.Tensor) -> torch.Tensor:
    """ts + round(INTERVAL / sqrt(max(count, 1))) in float64, ties to
    even, as ``codel._control_law``."""
    inc = torch.round(CODEL_INTERVAL_NS / torch.sqrt(
        count.clamp(min=1).to(torch.float64)))
    return ts + inc.to(torch.int64)


class DequeueOut(NamedTuple):
    """The router's per-host fields after one dequeue, the per-host CoDel
    drop count, and the packet handed up: ``have`` marks hosts that got
    one; ``payload`` / ``src`` are the ring's head slot elsewhere."""

    q_head: torch.Tensor  # [H] int32
    total_size: torch.Tensor  # [H] int64
    interval_expire: torch.Tensor  # [H] int64
    drop_mode: torch.Tensor  # [H] bool
    next_drop: torch.Tensor  # [H] int64
    drop_count: torch.Tensor  # [H] int32
    drop_count_last: torch.Tensor  # [H] int32
    dropped: torch.Tensor  # [H] int32 CoDel drops this call
    have: torch.Tensor  # [H] bool
    payload: torch.Tensor  # [H, P] int32
    src: torch.Tensor  # [H] int32


def codel_dequeue_plain(q_payload, q_src, q_enq_ts, q_head, q_tail,
                        drop_mode, interval_expire, next_drop, drop_count,
                        drop_count_last, total_size, now, mask,
                        aqm: bool = True) -> DequeueOut:
    """Plain version of ``codel.dequeue`` (with ``DROP_UNROLL`` = 1): a
    sojourn-checked pop; in drop mode, one control-law drop and re-pop;
    in store mode, the transition to drop mode. ``aqm`` False is the
    drop-tail pop alone. The drop-trail registers stay untouched: they
    exist only with packet_trails (payload wider than 12 words)."""
    H, Q = q_src.shape
    rows = torch.arange(H, device=q_src.device)
    st = dict(head=q_head, total=total_size, ie=interval_expire)

    def pop(want):
        nonempty = st["head"] < st["tail"]
        have = want & nonempty
        empty_hit = want & ~nonempty
        slot = (st["head"] % Q).to(torch.int64)
        payload = q_payload[rows, slot]
        src = q_src[rows, slot]
        enq = q_enq_ts[rows, slot]
        size = wire_bytes(payload)
        new_total = torch.where(have, st["total"] - size, st["total"])
        good = ((now - enq) < CODEL_TARGET_NS) | (new_total < MTU)
        ie0 = st["ie"]
        ie = torch.where(have & good, 0, ie0)
        ie = torch.where(have & ~good & (ie0 == 0), now + CODEL_INTERVAL_NS,
                         ie)
        ok = have & ~good & (ie0 != 0) & (now >= ie0)
        st["ie"] = torch.where(empty_hit, 0, ie)
        st["head"] = st["head"] + have.to(torch.int32)
        st["total"] = new_total
        return have, payload, src, ok

    st["tail"] = q_tail
    have, payload, src, ok = pop(mask)
    dropped = torch.zeros(H, dtype=torch.int32, device=q_src.device)
    if aqm:
        dm = torch.where(mask & ~have, False, drop_mode)
        in_drop = mask & have & dm
        dm = torch.where(in_drop & ~ok, False, dm)
        cond = mask & have & dm & (now >= next_drop)
        dropped = dropped + cond.to(torch.int32)
        drop_count = drop_count + cond.to(torch.int32)
        have2, payload2, src2, ok2 = pop(cond)
        have = torch.where(cond, have2, have)
        payload = torch.where(cond[:, None], payload2, payload)
        src = torch.where(cond, src2, src)
        ok = torch.where(cond, ok2, ok)
        next_drop = torch.where(cond & ok2,
                                control_law(drop_count, next_drop),
                                next_drop)
        dm = torch.where(cond & ~ok2, False, dm)
        trans = mask & have & ~dm & ok
        dropped = dropped + trans.to(torch.int32)
        have3, payload3, src3, _ = pop(trans)
        have = torch.where(trans, have3, have)
        payload = torch.where(trans[:, None], payload3, payload)
        src = torch.where(trans, src3, src)
        delta = drop_count - drop_count_last
        recently = now < (next_drop + 16 * CODEL_INTERVAL_NS)
        new_count = torch.where(recently & (delta > 1), delta, 1).to(
            torch.int32)
        drop_mode = torch.where(trans, True, dm)
        drop_count = torch.where(trans, new_count, drop_count)
        next_drop = torch.where(trans, control_law(new_count, now), next_drop)
        drop_count_last = torch.where(trans, new_count, drop_count_last)
    return DequeueOut(
        q_head=st["head"], total_size=st["total"],
        interval_expire=st["ie"], drop_mode=drop_mode, next_drop=next_drop,
        drop_count=drop_count, drop_count_last=drop_count_last,
        dropped=dropped, have=have, payload=payload, src=src,
    )


def codel_dequeue(q_payload, q_src, q_enq_ts, q_head, q_tail, drop_mode,
                  interval_expire, next_drop, drop_count, drop_count_last,
                  total_size, now, mask, aqm: bool = True) -> DequeueOut:
    """CoDel dequeue, one deliverable packet per masked host (see
    ``codel_dequeue_plain``)."""
    args = (q_payload, q_src, q_enq_ts, q_head, q_tail, drop_mode,
            interval_expire, next_drop, drop_count, drop_count_last,
            total_size, now, mask)
    if not _on_card(*args):
        return codel_dequeue_plain(*args, aqm=aqm)
    H, Q, P = q_payload.shape
    if P > W_TRAIL:
        raise ValueError("codel_dequeue: packet trails (P > 12) are not "
                         "ported")
    dev = q_payload.device
    ins = (
        _check(q_payload, torch.int32, (H, Q, P), "q_payload"),
        _check(q_src, torch.int32, (H, Q), "q_src"),
        _check(q_enq_ts, torch.int64, (H, Q), "q_enq_ts"),
        _check(q_head, torch.int32, (H,), "q_head"),
        _check(q_tail, torch.int32, (H,), "q_tail"),
        _check(drop_mode, torch.bool, (H,), "drop_mode"),
        _check(interval_expire, torch.int64, (H,), "interval_expire"),
        _check(next_drop, torch.int64, (H,), "next_drop"),
        _check(drop_count, torch.int32, (H,), "drop_count"),
        _check(drop_count_last, torch.int32, (H,), "drop_count_last"),
        _check(total_size, torch.int64, (H,), "total_size"),
        _check(now, torch.int64, (H,), "now"),
        _check(mask, torch.bool, (H,), "mask"),
    )
    e = lambda dt, *sh: torch.empty(sh, dtype=dt, device=dev)  # noqa: E731
    out = DequeueOut(
        q_head=e(torch.int32, H), total_size=e(torch.int64, H),
        interval_expire=e(torch.int64, H), drop_mode=e(torch.bool, H),
        next_drop=e(torch.int64, H), drop_count=e(torch.int32, H),
        drop_count_last=e(torch.int32, H), dropped=e(torch.int32, H),
        have=e(torch.bool, H), payload=e(torch.int32, H, P),
        src=e(torch.int32, H),
    )
    _launch(CODEL_DEQUEUE, *ins, *(t.data_ptr() for t in out), H, Q, P,
            int(aqm), _stream(q_payload))
    return out


# ---------------------------------------------------------------------------
# K7 ring_append
# ---------------------------------------------------------------------------


class AppendOut(NamedTuple):
    """The ring after a masked append; ``ts`` and ``total_size`` are None
    where the ring has no timestamp column / byte tally. On the card
    ``payload``, ``col`` and ``ts`` are the ring planes the kernel was
    given, written in place; the plain version returns new tensors."""

    payload: torch.Tensor  # [H, Q, P] int32
    col: torch.Tensor  # [H, Q] int32
    ts: torch.Tensor | None  # [H, Q] int64
    tail: torch.Tensor  # [H] int32
    total_size: torch.Tensor | None  # [H] int64
    ok: torch.Tensor  # [H] bool: appended (mask & room)


def ring_append_plain(q_payload, q_col, q_ts, q_head, q_tail, mask, payload,
                      col, ts, total_size) -> AppendOut:
    """Plain version of ``codel.enqueue`` / ``nic.enqueue_send``: where
    masked and the ring has room (tail - head < Q), write the packet at
    slot tail % Q and advance the tail; add the wire size to
    ``total_size`` where given."""
    Q = q_col.shape[1]
    ok = mask & ((q_tail - q_head) < Q)
    slot = (q_tail % Q).to(torch.int64)
    cols = torch.arange(Q, dtype=torch.int64, device=q_col.device)
    hit = ok[:, None] & (cols[None, :] == slot[:, None])
    return AppendOut(
        payload=torch.where(hit[:, :, None], payload[:, None, :], q_payload),
        col=torch.where(hit, col[:, None], q_col),
        ts=None if q_ts is None else torch.where(hit, ts[:, None], q_ts),
        tail=q_tail + ok.to(torch.int32),
        total_size=None if total_size is None else (
            total_size + torch.where(ok, wire_bytes(payload), 0)),
        ok=ok,
    )


def ring_append(q_payload, q_col, q_ts, q_head, q_tail, mask, payload, col,
                ts, total_size) -> AppendOut:
    """Masked per-host ring append (see ``ring_append_plain``). ``q_ts`` /
    ``ts`` and ``total_size`` may be None together for a ring without
    them.

    On the card the kernel writes each appended slot into ``q_payload``,
    ``q_col`` and ``q_ts`` in place and returns those very tensors; the
    rings are ``IN_PLACE`` fields of the NIC's and the router's states,
    which ``SimState.snapshot()`` clones. The tail, byte tally and ``ok``
    are new tensors. To compare the kernel with its plain version, hand
    the kernel clones of the planes."""
    opt = tuple(x for x in (q_ts, ts, total_size) if x is not None)
    args = (q_payload, q_col, q_head, q_tail, mask, payload, col)
    if not _on_card(*args, *opt):
        return ring_append_plain(q_payload, q_col, q_ts, q_head, q_tail,
                                 mask, payload, col, ts, total_size)
    H, Q, P = q_payload.shape
    if (q_ts is None) != (ts is None):
        raise ValueError("ring_append: q_ts and ts go together")
    dev = q_payload.device
    ins = (
        _check(q_payload, torch.int32, (H, Q, P), "q_payload"),
        _check(q_col, torch.int32, (H, Q), "q_col"),
        0 if q_ts is None else _check(q_ts, torch.int64, (H, Q), "q_ts"),
        _check(q_head, torch.int32, (H,), "q_head"),
        _check(q_tail, torch.int32, (H,), "q_tail"),
        _check(mask, torch.bool, (H,), "mask"),
        _check(payload, torch.int32, (H, P), "payload"),
        _check(col, torch.int32, (H,), "col"),
        0 if ts is None else _check(ts, torch.int64, (H,), "ts"),
        0 if total_size is None else _check(total_size, torch.int64, (H,),
                                             "total_size"),
    )
    e = lambda dt, *sh: torch.empty(sh, dtype=dt, device=dev)  # noqa: E731
    out = AppendOut(
        payload=q_payload, col=q_col, ts=q_ts, tail=e(torch.int32, H),
        total_size=None if total_size is None else e(torch.int64, H),
        ok=e(torch.bool, H),
    )
    _launch(RING_APPEND, *ins,
            *(0 if t is None else t.data_ptr() for t in out[3:]), H, Q, P,
            _stream(q_payload))
    return out


# ---------------------------------------------------------------------------
# The TCP stack's kernels: K8 tcp_demux, K9 tcp_ack, K10 tcp_reorder,
# K11 tcp_out
# ---------------------------------------------------------------------------

# TCP states and header flags (the JAX package's net/tcp.py numbering)
TCP_CLOSED, TCP_LISTEN, TCP_SYN_SENT, TCP_SYN_RECEIVED = 0, 1, 2, 3
TCP_ESTABLISHED, TCP_FIN_WAIT_1, TCP_FIN_WAIT_2, TCP_CLOSING = 4, 5, 6, 7
TCP_TIME_WAIT, TCP_CLOSE_WAIT, TCP_LAST_ACK = 8, 9, 10
FLAG_FIN, FLAG_SYN, FLAG_RST, FLAG_ACK = 0x01, 0x02, 0x04, 0x10
RTO_MIN_NS, RTO_MAX_NS = 200_000_000, 60_000_000_000
M32 = 0xFFFFFFFF


def seq_lt(a, b):
    """a before b in int32 sequence space (sign of the wrapped
    difference)."""
    return (b - a).to(torch.int32) > 0


def seq_leq(a, b):
    return (b - a).to(torch.int32) >= 0


def u32(x: torch.Tensor) -> torch.Tensor:
    """The uint32 bit pattern of an integer tensor, held in int64."""
    return x.to(torch.int64) & M32


def i32(u: torch.Tensor) -> torch.Tensor:
    """The int32 whose bit pattern is the uint32 value u (int64)."""
    return (((u & M32) ^ 0x80000000) - 0x80000000).to(torch.int32)


def popcount(x):
    """Set bits of a uint32 (int64 in, int64 out)."""
    x = u32(x)
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & M32) >> 24


def bit_length(x):
    """Position of the highest set bit + 1 of a uint32 (0 for 0), int32."""
    x = u32(x)
    n = torch.zeros_like(x)
    for sh in (16, 8, 4, 2, 1):
        gt = x >= (1 << sh)
        n = n + torch.where(gt, sh, 0)
        x = torch.where(gt, x >> sh, x)
    return (n + (x > 0).to(torch.int64)).to(torch.int32)


def trailing_ones(x):
    """Consecutive set bits from bit 0 of a uint32, int32."""
    y = (~u32(x)) & M32
    lsb = y & (-y)
    return torch.where(y == 0, 32, popcount(lsb - 1)).to(torch.int32)


def pack_sack(om: torch.Tensor) -> torch.Tensor:
    """The first 32 chunks of a [H, W] board as the int32 bit pattern of
    a uint32 bitmap (bit k = chunk k)."""
    n = min(32, om.shape[1])
    w = torch.ones(n, dtype=torch.int64, device=om.device) << torch.arange(
        n, dtype=torch.int64, device=om.device)
    return i32((om[:, :n].to(torch.int64) * w[None, :]).sum(dim=1))


def rtt_sample(r, srtt0, rttvar0):
    """RFC 6298's (srtt, rttvar, rto) after the sample r, int64 ns; srtt0
    == 0 is the first sample. ``//`` floors, as JAX's does."""
    first = srtt0 == 0
    srtt1 = torch.where(first, r, srtt0 + (r - srtt0) // 8)
    rttvar1 = torch.where(first, r // 2,
                          rttvar0 + ((srtt0 - r).abs() - rttvar0) // 4)
    return srtt1, rttvar1, (srtt1 + 4 * rttvar1).clamp(RTO_MIN_NS,
                                                       RTO_MAX_NS)


def slot_gather(arr: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """arr[h, clip(slot[h], 0, S - 1)] of an [H, S] or [H, S, W] array."""
    idx = slot.clamp(0, arr.shape[1] - 1).to(torch.int64)
    if arr.dim() == 2:
        return arr.gather(1, idx[:, None])[:, 0]
    return arr[torch.arange(arr.shape[0], device=arr.device), idx]


def _bits(*masks) -> torch.Tensor:
    """[H] int32 with bit i set where masks[i]."""
    out = masks[0].to(torch.int32)
    for i, m in enumerate(masks[1:], 1):
        out = out | (m.to(torch.int32) << i)
    return out


def _tcp_args(name, fields, names, H, S):
    """The checked pointers of [H, S] TCP table fields."""
    return tuple(_check(f, TCP_DTYPES[n], (H, S), f"{name}.{n}")
                 for f, n in zip(fields, names))


def _own_storage(name: str, written, args) -> None:
    """Raise unless each tensor the kernel writes in place shares its
    storage with no other argument: the kernel reads and writes it through
    one pointer, so another argument that reads the same memory would see
    the kernel's writes, which the plain version never shows it."""
    ptrs = [t.untyped_storage().data_ptr() for t in args
            if t is not None and t.untyped_storage().nbytes()]
    for t in written:
        if t.untyped_storage().nbytes() and ptrs.count(
                t.untyped_storage().data_ptr()) > 1:
            raise ValueError(f"{name}: a field it writes in place shares "
                             f"its storage with another argument")


def _ptr_array(ptrs) -> ctypes.Array:
    """A host array of device pointers for an entry that takes many; the
    caller holds it until the entry has returned (the entry copies the
    pointers into the kernel's arguments)."""
    return (ctypes.c_void_p * len(ptrs))(*ptrs)


# [H, S] field dtypes of the TCP table
TCP_DTYPES = {
    **{n: torch.int32 for n in (
        "local_port", "peer_host", "peer_port", "state", "snd_una",
        "snd_nxt", "snd_max", "snd_wnd", "snd_buf_end", "fin_seq",
        "rcv_nxt", "fin_rcvd_seq", "cwnd", "ssthresh", "dup_acks",
        "sack_bits", "rtx_high", "recover", "rtt_seq", "gen")},
    **{n: torch.int64 for n in (
        "srtt", "rttvar", "rto", "rtt_start", "rtx_expire", "bytes_acked",
        "bytes_received")},
    **{n: torch.bool for n in (
        "used", "fin_pending", "fin_sent", "fin_rcvd", "fast_recovery",
        "rtt_armed", "rtx_armed", "out_pending")},
}


# --- K8 tcp_demux ---


class DemuxOut(NamedTuple):
    slot: torch.Tensor  # [H] int32
    found: torch.Tensor  # [H] bool
    is_listener: torch.Tensor  # [H] bool


def tcp_demux_plain(used, local_port, peer_host, peer_port, state, mask,
                    dport, sport, src) -> DemuxOut:
    """Plain version of ``shadow_tpu/net/tcp.py:demux``: score 2 for a
    4-tuple match of a non-listener, 1 for a listener on the port; the
    lowest slot wins ties (torch's max, like jnp.argmax, returns the
    first maximal index)."""
    port_ok = used & (local_port == dport[:, None])
    conn = (port_ok & (peer_host == src[:, None])
            & (peer_port == sport[:, None]) & (state != TCP_LISTEN))
    listener = port_ok & (state == TCP_LISTEN)
    score = conn.to(torch.int32) * 2 + listener.to(torch.int32)
    best, slot = score.max(dim=1)
    found = mask & (best > 0)
    return DemuxOut(slot.to(torch.int32), found, found & (best == 1))


def tcp_demux(used, local_port, peer_host, peer_port, state, mask, dport,
              sport, src) -> DemuxOut:
    """Match one incoming segment per host to a socket (see
    ``tcp_demux_plain``)."""
    args = (used, local_port, peer_host, peer_port, state, mask, dport,
            sport, src)
    if not _on_card(*args):
        return tcp_demux_plain(*args)
    H, S = used.shape
    dev = used.device
    ins = (
        *_tcp_args("tcp_demux", (used, local_port, peer_host, peer_port,
                                 state),
                   ("used", "local_port", "peer_host", "peer_port", "state"),
                   H, S),
        _check(mask, torch.bool, (H,), "mask"),
        _check(dport, torch.int32, (H,), "dport"),
        _check(sport, torch.int32, (H,), "sport"),
        _check(src, torch.int32, (H,), "src"),
    )
    out = DemuxOut(torch.empty(H, dtype=torch.int32, device=dev),
                   torch.empty(H, dtype=torch.bool, device=dev),
                   torch.empty(H, dtype=torch.bool, device=dev))
    _launch(TCP_DEMUX, *ins, *(t.data_ptr() for t in out), H, S,
            _stream(used))
    return out


# --- K9 tcp_ack ---

# the [H, S] fields tcp_ack reads, and those it writes (on the card in
# place, into the ACK_IN tensors of the same names)
ACK_IN = ("state", "snd_una", "snd_nxt", "snd_max", "snd_wnd",
          "snd_buf_end", "fin_seq", "fin_sent", "cwnd", "ssthresh",
          "dup_acks", "fast_recovery", "recover", "sack_bits", "rtx_high",
          "srtt", "rttvar", "rto", "rtt_armed", "rtt_seq", "rtt_start",
          "rtx_armed", "rtx_expire", "bytes_acked")
ACK_OUT = ("state", "snd_una", "snd_nxt", "snd_wnd", "cwnd", "ssthresh",
           "dup_acks", "fast_recovery", "recover", "sack_bits", "rtx_high",
           "srtt", "rttvar", "rto", "rtt_armed", "rtx_expire", "bytes_acked")
TCP_ACK.writes = {9 + ACK_IN.index(f): ("fields", k)
                  for k, f in enumerate(ACK_OUT)}
# bits of AckOut.flags
(ACK_SR_EST, ACK_NEW_ACKED, ACK_INFLATE, ACK_DATA_RTX, ACK_FIN_RTX,
 ACK_TW_ENTER, ACK_FREE, ACK_DUP, ACK_TRIGGER_FR, ACK_PARTIAL,
 ACK_SACK_RTX) = range(11)


class AckOut(NamedTuple):
    """The ACK block's result: the ``ACK_OUT`` fields after it, and per
    host its decisions (``flags``, bits ``ACK_*``) and the segment of a
    data or FIN retransmission. On the card ``fields`` are the tensors the
    kernel was given, updated in place; the plain version returns new
    tensors."""

    fields: tuple
    flags: torch.Tensor  # [H] int32
    rtx_seq: torch.Tensor  # [H] int32
    rtx_len: torch.Tensor  # [H] int32
    fin_seq: torch.Tensor  # [H] int32


def tcp_ack_plain(mask, slot, flags, seg_ack, seg_len, seg_wnd, seg_sack,
                  st, now, *fields, mss: int) -> AckOut:
    """Plain version of the ACK block of ``shadow_tpu/net/tcp.py:
    Tcp.on_segment`` (SYN_RECEIVED → ESTABLISHED, duplicate ACKs and
    Reno/NewReno, ``bytes_acked``, the snd_nxt >= snd_una drag,
    ``_rtt_update``, ``_push_back_rtx``, the FIN-acked state moves, the
    sender SACK scoreboard and the fast / partial / SACK retransmit
    choice) for the masked hosts' ``slot``; ``st`` is the slot's state
    read before the block."""
    f = dict(zip(ACK_IN, fields))

    def g(name):
        return slot_gather(f[name], slot)

    has_syn = (flags & FLAG_SYN) != 0
    has_fin = (flags & FLAG_FIN) != 0
    una, nxt, smax = g("snd_una"), g("snd_nxt"), g("snd_max")
    m_ack = mask & ((flags & FLAG_ACK) != 0)
    acceptable = m_ack & seq_leq(una, seg_ack) & seq_leq(seg_ack, smax)
    new_acked = acceptable & seq_lt(una, seg_ack)
    m_sr_est = new_acked & (st == TCP_SYN_RECEIVED)
    st_now = torch.where(m_sr_est, TCP_ESTABLISHED, g("state"))

    # duplicate ACKs and Reno/NewReno (before una moves)
    is_dup = (m_ack & (seg_ack == una) & (seg_len == 0) & ~has_syn
              & ~has_fin & seq_lt(una, nxt))
    fr = g("fast_recovery")
    dups0 = g("dup_acks")
    dups1 = torch.where(is_dup & ~fr, dups0 + 1, dups0)
    trigger_fr = is_dup & ~fr & (dups1 == 3)
    flight = (nxt - una).to(torch.int32)
    ssth_on_loss = torch.clamp(flight // 2, min=2 * mss)
    inflate = is_dup & fr
    cwnd0, ssth0 = g("cwnd"), g("ssthresh")
    cwnd1 = torch.where(trigger_fr, ssth_on_loss + 3 * mss,
                        torch.where(inflate, cwnd0 + mss, cwnd0))
    ssth1 = torch.where(trigger_fr, ssth_on_loss, ssth0)
    fr1 = fr | trigger_fr
    rec1 = torch.where(trigger_fr, smax, g("recover"))
    full_ack = new_acked & fr1 & seq_leq(rec1, seg_ack)
    partial_ack = new_acked & fr1 & ~full_ack
    cwnd2 = torch.where(full_ack, ssth1, cwnd1)
    fr2 = fr1 & ~full_ack
    dups2 = torch.where(new_acked, 0, dups1)
    grow = new_acked & ~fr1
    acked_bytes = (seg_ack - una).to(torch.int32)
    in_ss = cwnd2 < ssth1
    cwnd3 = torch.where(
        grow & in_ss, cwnd2 + torch.clamp(acked_bytes, max=mss),
        torch.where(grow & ~in_ss,
                    cwnd2 + torch.clamp((mss * mss)
                                        // torch.clamp(cwnd2, min=1), min=1),
                    cwnd2))

    # bytes_acked without the SYN/FIN phantom bytes; the snd_nxt drag
    fin_seq_g, fin_sent_g = g("fin_seq"), g("fin_sent")
    syn_ph = new_acked & (una == 0)
    fin_acked = (new_acked & fin_sent_g & seq_leq(una, fin_seq_g)
                 & seq_lt(fin_seq_g, seg_ack))
    app_bytes = (acked_bytes - syn_ph.to(torch.int32)
                 - fin_acked.to(torch.int32))
    nxt1 = torch.where(new_acked & seq_lt(nxt, seg_ack), seg_ack, nxt)
    una2 = torch.where(new_acked, seg_ack, una)

    # _rtt_update, then _push_back_rtx with the new rto
    armed0 = g("rtt_armed")
    take = new_acked & seq_leq(g("rtt_seq"), seg_ack) & armed0
    srtt0, rttvar0, rto0 = g("srtt"), g("rttvar"), g("rto")
    srtt1, rttvar1, rto1 = rtt_sample(now - g("rtt_start"), srtt0, rttvar0)
    srtt_n = torch.where(take, srtt1, srtt0)
    rttvar_n = torch.where(take, rttvar1, rttvar0)
    rto_n = torch.where(take, rto1, rto0)
    armed_n = armed0 & ~take
    expire_n = torch.where(new_acked & g("rtx_armed"), now + rto_n,
                           g("rtx_expire"))

    # our FIN acked: FIN_WAIT_1 → FIN_WAIT_2, CLOSING → TIME_WAIT,
    # LAST_ACK → CLOSED
    st_fin = torch.where(
        st_now == TCP_FIN_WAIT_1, TCP_FIN_WAIT_2,
        torch.where(st_now == TCP_CLOSING, TCP_TIME_WAIT,
                    torch.where(st_now == TCP_LAST_ACK, TCP_CLOSED, st_now)))
    st_n = torch.where(fin_acked, st_fin, st_now)
    m_tw_enter = fin_acked & (st_now == TCP_CLOSING)
    m_free = fin_acked & (st_now == TCP_LAST_ACK)

    # sender SACK scoreboard: a pure ACK's bitmap is authoritative; a
    # data-carrying ACK shifts the board by the chunks it acked
    pure_ack = m_ack & (seg_len == 0) & ~has_syn & ~has_fin
    sb0 = u32(g("sack_bits"))
    nch = acked_bytes // mss
    acked_ch = nch.clamp(0, 31).to(torch.int64)
    sb_shift = torch.where(new_acked,
                           torch.where(nch >= 32, 0, sb0 >> acked_ch), sb0)
    sb1 = torch.where(pure_ack & acceptable, u32(seg_sack), sb_shift)

    # fast / partial / SACK retransmission
    rtx_high0 = g("rtx_high")
    rtx_high_eff = torch.where(trigger_fr, una2, rtx_high0)
    done_ch = ((rtx_high_eff - una2).to(torch.int32) // mss).clamp(
        0, 32).to(torch.int64)
    one = torch.ones_like(done_ch)
    done_mask = torch.where(done_ch >= 32, M32, (one << done_ch) - 1)
    fh = trailing_ones(sb1 | done_mask)
    blen = bit_length(sb1)
    newreno_rtx = trigger_fr | partial_ack
    hole_visible = (sb1 != 0) & (fh < blen) & (fh < 32)
    sack_rtx = inflate & hole_visible
    do_rtx = (newreno_rtx & (hole_visible | (fh == 0))) | sack_rtx
    f_eff = torch.where(hole_visible, torch.clamp(fh, max=31), 0)
    rtx_seq = una2 + f_eff * mss
    buf = g("snd_buf_end")
    rtx_len = torch.clamp((buf - rtx_seq).to(torch.int32), max=mss)
    data_rtx = do_rtx & (rtx_len > 0)
    fin_rtx = (newreno_rtx
               & (torch.clamp((buf - una2).to(torch.int32), max=mss) <= 0)
               & fin_sent_g)
    armed_n = armed_n & ~do_rtx  # Karn
    rtx_high_n = torch.where(data_rtx, rtx_seq + rtx_len, rtx_high_eff)

    new = {
        "state": st_n, "snd_una": una2, "snd_nxt": nxt1,
        "snd_wnd": torch.where(acceptable, seg_wnd, g("snd_wnd")),
        "cwnd": cwnd3, "ssthresh": ssth1, "dup_acks": dups2,
        "fast_recovery": fr2, "recover": rec1, "sack_bits": i32(sb1),
        "rtx_high": rtx_high_n, "srtt": srtt_n, "rttvar": rttvar_n,
        "rto": rto_n, "rtt_armed": armed_n, "rtx_expire": expire_n,
        "bytes_acked": g("bytes_acked") + torch.where(
            new_acked, app_bytes, 0).to(torch.int64),
    }
    # every write of the block is under m_ack ⊆ mask: where a narrower
    # condition is off, the slot's old value goes back
    return AckOut(
        fields=tuple(soa.set_at(f[n], mask, slot, new[n]) for n in ACK_OUT),
        flags=_bits(m_sr_est, new_acked, inflate, data_rtx, fin_rtx,
                    m_tw_enter, m_free, is_dup, trigger_fr, partial_ack,
                    sack_rtx),
        rtx_seq=rtx_seq.to(torch.int32), rtx_len=rtx_len.to(torch.int32),
        fin_seq=fin_seq_g,
    )


def tcp_ack(mask, slot, flags, seg_ack, seg_len, seg_wnd, seg_sack, st, now,
            *fields, mss: int) -> AckOut:
    """The ACK block of one incoming segment per host (see
    ``tcp_ack_plain``); ``fields`` are the ``ACK_IN`` fields, [H, S].

    On the card the kernel updates the ``ACK_OUT`` fields in place, at
    each masked host's slot and nowhere else, and returns those very
    tensors in ``fields``; they are ``TcpState.IN_PLACE`` fields
    (``SimState.snapshot()`` clones them). ``flags``, ``rtx_seq``,
    ``rtx_len`` and ``fin_seq`` are new tensors. A written field may
    share its storage with no other argument (raises). To compare the
    kernel with its plain version, hand it clones of the written
    fields."""
    per_host = (mask, slot, flags, seg_ack, seg_len, seg_wnd, seg_sack, st,
                now)
    _own_storage("tcp_ack", (fields[i - 9] for i in TCP_ACK.writes),
                 (*per_host, *fields))
    if not _on_card(*per_host, *fields):
        return tcp_ack_plain(*per_host, *fields, mss=mss)
    H, S = fields[0].shape
    dev = mask.device
    hdt = (torch.bool, *(torch.int32,) * 7, torch.int64)
    ins = (*(_check(t, dt, (H,), n) for t, dt, n in zip(
        per_host, hdt, ("mask", "slot", "flags", "seg_ack", "seg_len",
                        "seg_wnd", "seg_sack", "st", "now"))),
        *_tcp_args("tcp_ack", fields, ACK_IN, H, S))
    per = tuple(torch.empty(H, dtype=torch.int32, device=dev)
                for _ in range(4))
    p_in = _ptr_array(ins)
    p_out = _ptr_array([t.data_ptr() for t in per])
    _launch(TCP_ACK, ctypes.addressof(p_in), ctypes.addressof(p_out), H, S,
            mss, _stream(mask))
    return AckOut(tuple(fields[i - 9] for i in TCP_ACK.writes), *per)


# --- K10 tcp_reorder ---

# bits of ReorderOut.flags
RO_IN_ORDER, RO_OOO, RO_DROP, RO_ABSORB = range(4)


class ReorderOut(NamedTuple):
    """The data-receive block's result: the receive fields after it, and
    per host its decisions (``flags``, bits ``RO_*``), the in-order bytes
    delivered up and the SACK word of the ACK reply. On the card
    ``rcv_nxt``, ``ooo_map`` and ``bytes_received`` are the tensors the
    kernel was given, updated in place; the plain version returns new
    tensors."""

    rcv_nxt: torch.Tensor  # [H, S] int32
    ooo_map: torch.Tensor  # [H, S, W] bool
    bytes_received: torch.Tensor  # [H, S] int64
    flags: torch.Tensor  # [H] int32
    adv: torch.Tensor  # [H] int32
    sack: torch.Tensor  # [H] int32


def tcp_reorder_plain(mask, slot, seg_seq, seg_len, state, rcv_nxt, ooo_map,
                      bytes_received, *, mss: int) -> ReorderOut:
    """Plain version of the data-receive block of ``shadow_tpu/net/tcp.py:
    Tcp.on_segment`` (the reorder board) and ``_pack_sack`` of the
    slot's board after it. Chunk i of the board is [rcv_nxt + i·MSS,
    +MSS); an in-order MSS segment shifts the board one chunk and absorbs
    the run of chunks already held; a short segment clears it; an
    out-of-order MSS-aligned segment within the board sets its chunk, any
    other is dropped."""
    W = ooo_map.shape[2]
    st2 = slot_gather(state, slot)
    can_rcv = ((st2 == TCP_ESTABLISHED) | (st2 == TCP_FIN_WAIT_1)
               | (st2 == TCP_FIN_WAIT_2))
    m_data = mask & (seg_len > 0) & can_rcv
    rn = slot_gather(rcv_nxt, slot)
    d = (seg_seq - rn).to(torch.int32)
    in_order = m_data & (d == 0)
    om = slot_gather(ooo_map, slot)
    full = seg_len == mss
    n_absorb = torch.where(
        full, torch.cumprod(om[:, 1:].to(torch.int32), dim=1).sum(dim=1),
        0).to(torch.int32)
    adv = torch.where(in_order, seg_len + n_absorb * mss, 0).to(torch.int32)
    shift = torch.where(full, 1 + n_absorb, W).to(torch.int64)
    idx = torch.arange(W, device=om.device)[None, :] + shift[:, None]
    om_shifted = torch.cat([om, torch.zeros_like(om)], dim=1).gather(
        1, idx.clamp(0, 2 * W - 1))
    om1 = torch.where(in_order[:, None], om_shifted, om)
    m_ooo = m_data & (d > 0)
    kchunk = d // mss
    aligned = (m_ooo & (d % mss == 0) & full & (kchunk >= 1)
               & (kchunk < W))
    om2 = soa.set_at(om1, aligned, kchunk, True)
    return ReorderOut(
        rcv_nxt=soa.set_at(rcv_nxt, in_order, slot, rn + adv),
        ooo_map=soa.set_at(ooo_map, in_order | aligned, slot, om2),
        bytes_received=soa.add_at(bytes_received, in_order, slot, adv),
        flags=_bits(in_order, aligned, m_ooo & ~aligned,
                    in_order & (n_absorb > 0)),
        adv=adv,
        sack=pack_sack(torch.where((in_order | aligned)[:, None], om2, om)),
    )


def tcp_reorder(mask, slot, seg_seq, seg_len, state, rcv_nxt, ooo_map,
                bytes_received, *, mss: int) -> ReorderOut:
    """The data-receive block of one incoming segment per host (see
    ``tcp_reorder_plain``).

    On the card the kernel updates ``rcv_nxt``, ``ooo_map`` and
    ``bytes_received`` in place, at each masked host's slot and nowhere
    else, and returns those very tensors; they are the state's
    ``TcpState.IN_PLACE`` fields (``SimState.snapshot()`` clones them).
    ``flags``, ``adv`` and ``sack`` are new tensors. The kernel holds a
    board row in 64 bits, so W <= 64. To compare it with its plain version, hand the
    kernel clones of the three fields."""
    args = (mask, slot, seg_seq, seg_len, state, rcv_nxt, ooo_map,
            bytes_received)
    if not _on_card(*args):
        return tcp_reorder_plain(*args, mss=mss)
    H, S, W = ooo_map.shape
    if W > 64:
        raise ValueError(f"tcp_reorder: a board row of W={W} chunks; the "
                         f"kernel takes W <= 64")
    dev = mask.device
    ins = (
        _check(mask, torch.bool, (H,), "mask"),
        _check(slot, torch.int32, (H,), "slot"),
        _check(seg_seq, torch.int32, (H,), "seg_seq"),
        _check(seg_len, torch.int32, (H,), "seg_len"),
        *_tcp_args("tcp_reorder", (state, rcv_nxt, bytes_received),
                   ("state", "rcv_nxt", "bytes_received"), H, S),
        _check(ooo_map, torch.bool, (H, S, W), "ooo_map"),
    )
    e = lambda dt, *sh: torch.empty(sh, dtype=dt, device=dev)  # noqa: E731
    out = ReorderOut(
        rcv_nxt=rcv_nxt, ooo_map=ooo_map, bytes_received=bytes_received,
        flags=e(torch.int32, H), adv=e(torch.int32, H),
        sack=e(torch.int32, H),
    )
    _launch(TCP_REORDER, *ins, *(t.data_ptr() for t in out[3:]), H, S, W,
            mss, _stream(mask))
    return out


# --- K11 tcp_out ---

OUT_IN = ("out_pending", "used", "state", "snd_una", "snd_nxt", "snd_max",
          "snd_buf_end", "cwnd", "snd_wnd", "sack_bits", "fin_pending",
          "fin_sent", "rcv_nxt", "peer_host", "rtt_armed", "rtt_seq",
          "rtt_start", "fin_seq")
OUT_OUT = ("out_pending", "snd_nxt", "snd_max", "fin_seq", "fin_sent",
           "state", "rtt_armed", "rtt_seq", "rtt_start")
TCP_OUT.writes = {3 + OUT_IN.index(f): ("fields", k)
                  for k, f in enumerate(OUT_OUT)}
# bits of OutOut.flags
OUT_SEND_DATA, OUT_SEND_FIN, OUT_SKIP, OUT_RTX, OUT_MORE = range(5)


class OutOut(NamedTuple):
    """The output pump's result: the ``OUT_OUT`` fields after it, and per
    host its decisions (``flags``, bits ``OUT_*``) and the segment. On the
    card ``fields`` are the tensors the kernel was given, updated in
    place; the plain version returns new tensors."""

    fields: tuple
    flags: torch.Tensor  # [H] int32
    seg_len: torch.Tensor  # [H] int32
    seq: torch.Tensor  # [H] int32
    ack: torch.Tensor  # [H] int32
    dst: torch.Tensor  # [H] int32


def tcp_out_plain(mask, slot, now, *fields, mss: int) -> OutOut:
    """Plain version of ``shadow_tpu/net/tcp.py:Tcp.on_out`` without its
    emissions: clear out_pending, then on a usable socket in a sending
    state send one segment of min(MSS, data left, window), skipping
    chunks the peer SACKed while re-walking the flight, or the FIN after
    the data; advance snd_nxt / snd_max, move the state on a FIN, arm an
    RTT sample on fresh data, and decide whether the pump re-arms."""
    f = dict(zip(OUT_IN, fields))

    def g(name):
        return slot_gather(f[name], slot)

    def put(name, cond, val):
        return soa.set_at(f[name], cond, slot, val)

    m = mask & g("used")
    st = g("state")
    can_send = ((st == TCP_ESTABLISHED) | (st == TCP_CLOSE_WAIT)
                | (st == TCP_FIN_WAIT_1) | (st == TCP_CLOSING)
                | (st == TCP_LAST_ACK))
    una, nxt, smax, buf = (g("snd_una"), g("snd_nxt"), g("snd_max"),
                           g("snd_buf_end"))
    wnd = torch.minimum(g("cwnd"), g("snd_wnd"))
    avail_win = (una + wnd - nxt).to(torch.int32)
    have_data = seq_lt(nxt, buf)
    left = torch.clamp((buf - nxt).to(torch.int32), max=mss)
    seg_len = torch.minimum(left, avail_win)
    send_data = m & can_send & have_data & (seg_len > 0)
    ch = (nxt - una).to(torch.int32) // mss
    sb = u32(g("sack_bits"))
    sacked = ((ch >= 0) & (ch < 32)
              & (((sb >> ch.clamp(0, 31).to(torch.int64)) & 1) == 1))
    skip = send_data & seq_lt(nxt, smax) & sacked
    send_data = send_data & ~skip
    fin_p, fin_s = g("fin_pending"), g("fin_sent")
    send_fin = m & can_send & ~have_data & fin_p & ~fin_s
    sent_any = send_data | send_fin
    advanced = sent_any | skip
    nxt1 = torch.where(send_data, nxt + seg_len,
                       torch.where(skip, nxt + left,
                                   torch.where(send_fin, nxt + 1, nxt)))
    is_rtx = sent_any & seq_lt(nxt, smax)
    smax1 = torch.where(seq_lt(smax, nxt1), nxt1, smax)
    arm_rtt = send_data & ~g("rtt_armed") & ~is_rtx
    avail1 = (una + wnd - nxt1).to(torch.int32)
    more = m & can_send & advanced & (
        (seq_lt(nxt1, buf) & (avail1 > 0))
        | (fin_p & ~(fin_s | send_fin) & ~seq_lt(nxt1, buf)))

    new = {
        "out_pending": put("out_pending", mask, False),
        "snd_nxt": put("snd_nxt", advanced, nxt1),
        "snd_max": put("snd_max", sent_any, smax1),
        "fin_seq": put("fin_seq", send_fin, nxt),
        "fin_sent": put("fin_sent", send_fin, True),
        "state": put("state", send_fin, torch.where(
            st == TCP_ESTABLISHED, TCP_FIN_WAIT_1,
            torch.where(st == TCP_CLOSE_WAIT, TCP_LAST_ACK, st))),
        "rtt_armed": put("rtt_armed", arm_rtt, True),
        "rtt_seq": put("rtt_seq", arm_rtt, nxt1),
        "rtt_start": put("rtt_start", arm_rtt, now),
    }
    return OutOut(
        fields=tuple(new[n] for n in OUT_OUT),
        flags=_bits(send_data, send_fin, skip, is_rtx, more),
        seg_len=torch.clamp(seg_len, min=0).to(torch.int32),
        seq=nxt, ack=g("rcv_nxt"), dst=g("peer_host"),
    )


def tcp_out(mask, slot, now, *fields, mss: int) -> OutOut:
    """The output pump of one event per host (see ``tcp_out_plain``);
    ``fields`` are the ``OUT_IN`` fields, [H, S].

    On the card the kernel updates the ``OUT_OUT`` fields in place, at
    each masked host's slot and nowhere else, and returns those very
    tensors in ``fields``; they are ``TcpState.IN_PLACE`` fields
    (``SimState.snapshot()`` clones them). The per-host results are new
    tensors. A written field may share its storage with no other argument
    (raises). To compare the kernel with its plain version, hand it
    clones of the written fields."""
    _own_storage("tcp_out", (fields[i - 3] for i in TCP_OUT.writes),
                 (mask, slot, now, *fields))
    if not _on_card(mask, slot, now, *fields):
        return tcp_out_plain(mask, slot, now, *fields, mss=mss)
    H, S = fields[0].shape
    dev = mask.device
    ins = (_check(mask, torch.bool, (H,), "mask"),
           _check(slot, torch.int32, (H,), "slot"),
           _check(now, torch.int64, (H,), "now"),
           *_tcp_args("tcp_out", fields, OUT_IN, H, S))
    per = tuple(torch.empty(H, dtype=torch.int32, device=dev)
                for _ in range(5))
    p_in = _ptr_array(ins)
    p_out = _ptr_array([t.data_ptr() for t in per])
    _launch(TCP_OUT, ctypes.addressof(p_in), ctypes.addressof(p_out), H, S,
            mss, _stream(mask))
    return OutOut(tuple(fields[i - 3] for i in TCP_OUT.writes), *per)


# ---------------------------------------------------------------------------
# K12 spec_check
# ---------------------------------------------------------------------------


def spec_check_plain(t, dst, src, done_t) -> torch.Tensor:
    """Plain version: the JAX package's exact violation form."""
    H = done_t.shape[0]
    if t.shape[0] == 0:
        return torch.full((), NEVER, dtype=torch.int64, device=t.device)
    last = done_t[dst.to(torch.int64).clamp(0, H - 1)]
    viol = (dst != src) & (t != NEVER) & (t <= last)
    return torch.where(viol, t, NEVER).min()


def spec_check(t, dst, src, done_t) -> torch.Tensor:
    """[] int64: the earliest time t of the emission rows (t, dst, src)
    [N] that cross hosts and land at or behind their destination's
    progress clock ``done_t[clip(dst)]`` [H]; NEVER where none does."""
    if not _on_card(t, dst, src, done_t):
        return spec_check_plain(t, dst, src, done_t)
    N, H = t.shape[0], done_t.shape[0]
    out = torch.empty((), dtype=torch.int64, device=t.device)
    _launch(SPEC_CHECK, _check(t, torch.int64, (N,), "t"),
            _check(dst, torch.int32, (N,), "dst"),
            _check(src, torch.int32, (N,), "src"),
            _check(done_t, torch.int64, (H,), "done_t"), N, H,
            out.data_ptr(), _stream(t))
    return out


def _per_host(t: torch.Tensor, H: int, dtype, name: str):
    """(pointer, stride) of a per-host input that may be one value
    broadcast to every host (a 0-d tensor or a stride-0 expand)."""
    if t.dtype is not dtype or not t.is_cuda:
        raise ValueError(f"{name}: want {dtype} on the card, got {t.dtype} "
                         f"on {t.device}")
    if t.dim() == 0:
        return t.data_ptr(), 0
    if t.shape != (H,) or t.stride(0) > 1:
        t = t.expand(H)
        if t.stride(0) not in (0, 1):
            t = t.contiguous()
    return t.data_ptr(), t.stride(0)


def _ptrs(dtype, *ts: torch.Tensor) -> list:
    """The data pointers of inputs on the card that a kernel reads as flat
    arrays of ``dtype``; raises on another type or device. The NIC's
    admission wrappers check no more: their kernels write only their own
    output, so no input can make them write out of bounds, and each check
    costs host time on every call."""
    ptrs = []
    for t in ts:
        if t.dtype is not dtype or not t.is_cuda:
            raise ValueError(f"want {dtype} on the card, got {t.dtype} on "
                             f"{t.device}")
        ptrs.append(t.data_ptr())
    return ptrs


def _payload(payload: torch.Tensor, H: int):
    """(pointer, row stride) of [H, P] int32 packet words whose length
    word the kernel reads; rows may be strided, words not."""
    if (payload.dtype is not torch.int32 or payload.shape[-1] <= W_LEN
            or not payload.is_cuda):
        raise ValueError(f"payload: want int32 [{H}, > {W_LEN}] on the "
                         f"card, got {payload.dtype} "
                         f"{tuple(payload.shape)} on {payload.device}")
    if payload.stride(1) != 1:
        payload = payload.contiguous()
    return payload.data_ptr(), payload.stride(0)


# ---------------------------------------------------------------------------
# K13 nic_refill
# ---------------------------------------------------------------------------

REFILL_NS = NS_PER_MS  # the token buckets' refill grid


def nic_refill_plain(rem, tick, refill, cap, now, mask=None):
    """Plain version: the JAX package's ``nic.lazy_refill``. Lanes of
    hosts without a real event carry ``now`` = NEVER, where
    ``(now_tick - tick) * refill`` wraps; the select discards them, as in
    the JAX package. ``//`` floors as JAX's does."""
    now_tick = now // REFILL_NS
    new_rem = torch.minimum(cap, rem + (now_tick - tick) * refill)
    new_rem = torch.where(now_tick > tick, new_rem, rem)
    new_tick = torch.maximum(tick, now_tick)
    if mask is not None:
        new_rem = torch.where(mask, new_rem, rem)
        new_tick = torch.where(mask, new_tick, tick)
    return new_rem, new_tick


def nic_refill(rem, tick, refill, cap, now, mask=None):
    """Apply every grid refill since ``tick`` to the buckets ``rem`` [H],
    clamped to ``cap``; returns (rem, tick). ``now`` is [H] or one value
    for every host; ``mask`` (or None: every host) gates the lanes that
    update."""
    args = (rem, tick, refill, cap, now) + (() if mask is None else (mask,))
    if not _on_card(*args):
        return nic_refill_plain(rem, tick, refill, cap, now, mask)
    H = rem.shape[0]
    now_p, now_s = _per_host(now, H, torch.int64, "now")
    ins = (
        _check(rem, torch.int64, (H,), "rem"),
        _check(tick, torch.int64, (H,), "tick"),
        _check(refill, torch.int64, (H,), "refill"),
        _check(cap, torch.int64, (H,), "cap"),
        now_p, now_s,
        0 if mask is None else _check(mask, torch.bool, (H,), "mask"),
    )
    o_rem = torch.empty(H, dtype=torch.int64, device=rem.device)
    o_tick = torch.empty(H, dtype=torch.int64, device=rem.device)
    _launch(NIC_REFILL, *ins, o_rem.data_ptr(), o_tick.data_ptr(), H,
            _stream(rem))
    return o_rem, o_tick


# ---------------------------------------------------------------------------
# K14 send_dequeue
# ---------------------------------------------------------------------------


class SendOut(NamedTuple):
    """One fifo dequeue: the head slot's packet (handed up for every
    host; the caller masks each use with ``sent``) and the new head."""

    payload: torch.Tensor  # [H, P] int32
    dst: torch.Tensor  # [H] int32
    sent: torch.Tensor  # [H] bool: want & ring nonempty
    head: torch.Tensor  # [H] int32


def send_dequeue_plain(q_payload, q_dst, q_head, q_tail, want) -> SendOut:
    """Plain version: ``nic.peek_send`` then ``nic.pop_send``."""
    slot = q_head % q_dst.shape[1]
    sent = want & (q_head < q_tail)
    return SendOut(payload=soa.get_at(q_payload, slot),
                   dst=soa.get_at(q_dst, slot), sent=sent,
                   head=q_head + sent.to(torch.int32))


def send_dequeue(q_payload, q_dst, q_head, q_tail, want) -> SendOut:
    """Dequeue each wanting host's head packet from its NIC send ring
    (``q_payload`` [H, NQ, P], ``q_dst`` [H, NQ])."""
    args = (q_payload, q_dst, q_head, q_tail, want)
    if not _on_card(*args):
        return send_dequeue_plain(*args)
    H, NQ, P = q_payload.shape
    dev = q_payload.device
    ins = (
        _check(q_payload, torch.int32, (H, NQ, P), "q_payload"),
        _check(q_dst, torch.int32, (H, NQ), "q_dst"),
        _check(q_head, torch.int32, (H,), "q_head"),
        _check(q_tail, torch.int32, (H,), "q_tail"),
        _check(want, torch.bool, (H,), "want"),
    )
    out = SendOut(
        payload=torch.empty((H, P), dtype=torch.int32, device=dev),
        dst=torch.empty(H, dtype=torch.int32, device=dev),
        sent=torch.empty(H, dtype=torch.bool, device=dev),
        head=torch.empty(H, dtype=torch.int32, device=dev),
    )
    _launch(SEND_DEQUEUE, *ins, *(t.data_ptr() for t in out), H, NQ, P,
            _stream(q_payload))
    return out


# ---------------------------------------------------------------------------
# K15 link_send
# ---------------------------------------------------------------------------


class LinkOut(NamedTuple):
    """One ``link.send`` over every host, [H] each."""

    deliver: torch.Tensor  # bool: rolled and kept
    drop: torch.Tensor  # bool: rolled and lost
    arrival: torch.Tensor  # int64: now + path latency (wraps if unreachable)
    rng_counter: torch.Tensor  # int64 (uint32 values): advanced where rolled


def link_send_plain(mask, dst, now, control, vertex, vertex_g, latency_vv,
                    reliability_vv, rng_keys, rng_counter, *,
                    bootstrap_end: int) -> LinkOut:
    """Plain version: the JAX package's ``link.send`` up to its emission.
    The destination indexes the vertex table as a JAX gather does: a
    negative index counts from the end, then it is clipped into the
    table (a lane that does not send may carry any destination)."""
    H = mask.shape[0]
    if latency_vv.shape[0] == 1:
        lat = latency_vv[0, 0].expand(H)
        rel = reliability_vv[0, 0].expand(H)
    else:
        table = vertex_g if vertex_g is not None else vertex
        T = table.shape[0]
        d = dst.to(torch.int64)
        d = torch.where(d < 0, d + T, d).clamp(0, T - 1)
        vd = table[d].to(torch.int64)
        vs = vertex.to(torch.int64)
        lat = latency_vv[vs, vd]
        rel = reliability_vv[vs, vd]
    roll = mask & (lat != NEVER)
    u = rng.uniform_per_host(rng_keys, rng_counter)
    kept = (now < bootstrap_end) | control | (u < rel)
    return LinkOut(
        deliver=roll & kept, drop=roll & ~kept, arrival=now + lat,
        rng_counter=torch.where(roll, (rng_counter + 1) & rng.M32,
                                rng_counter),
    )


def link_send(mask, dst, now, control, vertex, vertex_g, latency_vv,
              reliability_vv, rng_keys, rng_counter, *,
              bootstrap_end: int) -> LinkOut:
    """Each masked host's packet to ``dst`` [H] over its path: latency,
    reachability and the loss roll at the host's draw counter (no loss
    during bootstrap or for ``control`` packets). ``now`` and ``control``
    are [H] or one value for every host."""
    args = (mask, dst, now, control, vertex, latency_vv, reliability_vv,
            rng_keys, rng_counter)
    table = vertex_g if vertex_g is not None else vertex
    if not _on_card(*args, table):
        return link_send_plain(mask, dst, now, control, vertex, vertex_g,
                               latency_vv, reliability_vv, rng_keys,
                               rng_counter, bootstrap_end=bootstrap_end)
    H, U = mask.shape[0], latency_vv.shape[0]
    dev = mask.device
    now_p, now_s = _per_host(now, H, torch.int64, "now")
    ctl_p, ctl_s = _per_host(control, H, torch.bool, "control")
    ins = (
        _check(mask, torch.bool, (H,), "mask"),
        _check(dst, torch.int32, (H,), "dst"),
        now_p, now_s, ctl_p, ctl_s,
        _check(vertex, torch.int32, (H,), "vertex"),
        _check(table, torch.int32, (table.shape[0],), "vertex_g"),
        table.shape[0],
        _check(latency_vv, torch.int64, (U, U), "latency_vv"),
        _check(reliability_vv, torch.float32, (U, U), "reliability_vv"),
        U,
        _check(rng_keys, torch.int64, (H, 2), "rng_keys"),
        _check(rng_counter, torch.int64, (H,), "rng_counter"),
        int(bootstrap_end),
    )
    out = LinkOut(
        deliver=torch.empty(H, dtype=torch.bool, device=dev),
        drop=torch.empty(H, dtype=torch.bool, device=dev),
        arrival=torch.empty(H, dtype=torch.int64, device=dev),
        rng_counter=torch.empty(H, dtype=torch.int64, device=dev),
    )
    _launch(LINK_SEND, *ins, *(t.data_ptr() for t in out), H, _stream(mask))
    return out


# ---------------------------------------------------------------------------
# K16 nic_tx, K17 nic_rx, K18 nic_gate: the NIC's admission, each the
# refill (K13's) folded into the launch that consumes it
# ---------------------------------------------------------------------------


class TxOut(NamedTuple):
    """The direct send of every host (``nic_tx``), [H] each but ``counts``.
    On the card every tensor is a view of one allocation."""

    tx_rem: torch.Tensor  # int64
    tx_tick: torch.Tensor  # int64
    tx_packets: torch.Tensor  # int64
    tx_bytes: torch.Tensor  # int64
    arrival: torch.Tensor  # int64: now + path latency (as LinkOut's)
    rng_counter: torch.Tensor  # int64 (uint32 values): advanced where rolled
    # [4] int64: the counters ``TX_COUNTERS`` after the send
    counters: torch.Tensor
    direct: torch.Tensor  # bool: admitted onto the wire or loopback
    deliver: torch.Tensor  # bool: remote, rolled and kept
    drop: torch.Tensor  # bool: remote, rolled and lost
    loopback: torch.Tensor  # bool: admitted to the host itself


# link.send's counters (``SimState.counters`` fields), which nic_tx
# advances by its packets
TX_COUNTERS = ("packets_sent", "packets_dropped_loss",
               "packets_dropped_unreachable", "bytes_sent")


def nic_tx_plain(mask, now, dst, queued, gid, tx_rem, tx_tick, tx_refill,
                 tx_cap, tx_packets, tx_bytes, payload, vertex, vertex_g,
                 latency_vv, reliability_vv, rng_keys, rng_counter, counters,
                 *, bootstrap_end: int) -> TxOut:
    """Plain version: the JAX package's ``NetStack._tx`` up to its
    emissions, as the stack ran it before this kernel: the refill
    (``nic_refill_plain``), admission, charge and tx counters, then
    ``link_send_plain`` on the remote packets and ``link.send``'s sums
    added to ``counters`` (the four 0-d ``TX_COUNTERS``)."""
    tx_rem, tx_tick = nic_refill_plain(tx_rem, tx_tick, tx_refill, tx_cap,
                                       now, mask)
    size = wire_bytes(payload)
    bootstrap = now < bootstrap_end
    direct = mask & ~queued & (bootstrap | (tx_rem >= MTU))
    tx_rem = torch.where(direct & ~bootstrap, tx_rem - size, tx_rem)
    remote = direct & (dst != gid)
    ls = link_send_plain(remote, dst, now, payload[:, W_LEN] == 0, vertex,
                         vertex_g, latency_vv, reliability_vv, rng_keys,
                         rng_counter, bootstrap_end=bootstrap_end)
    sums = (remote.sum(), ls.drop.sum(),
            (remote & ~(ls.deliver | ls.drop)).sum(),
            torch.where(remote, size, 0).sum())
    return TxOut(
        tx_rem=tx_rem, tx_tick=tx_tick,
        tx_packets=tx_packets + direct.to(torch.int64),
        tx_bytes=tx_bytes + torch.where(direct, size, 0),
        arrival=ls.arrival, rng_counter=ls.rng_counter,
        counters=torch.stack([c + n for c, n in zip(counters, sums)]),
        direct=direct, deliver=ls.deliver, drop=ls.drop,
        loopback=direct & (dst == gid))


def _packed(H: int, n64: int, n_extra: int, nbool: int, device):
    """One int64 allocation for ``n64`` int64 rows [H], ``n_extra`` int64
    values and ``nbool`` bool rows [H], in that order."""
    return torch.empty(n64 * H + n_extra + (nbool * H + 7) // 8,
                       dtype=torch.int64, device=device)


def _rows(buf: torch.Tensor, H: int, n64: int, n_extra: int, nbool: int):
    """The views of ``_packed``'s parts: (int64 rows, extra values, bool
    rows)."""
    tail = buf.numel() - n64 * H - n_extra
    *rows, extra, rest = buf.split_with_sizes([H] * n64 + [n_extra, tail])
    flags = rest.view(torch.bool).split_with_sizes(
        [H] * nbool + [8 * tail - nbool * H])
    return rows, extra, flags[:nbool]


def nic_tx(mask, now, dst, queued, gid, tx_rem, tx_tick, tx_refill, tx_cap,
           tx_packets, tx_bytes, payload, vertex, vertex_g, latency_vv,
           reliability_vv, rng_keys, rng_counter, counters, *,
           bootstrap_end: int) -> TxOut:
    """The direct send of each masked host's packet (``payload`` [H, P],
    to ``dst``): when its NIC queue is empty (``queued`` false) and its
    refilled tx bucket holds an MTU (or in bootstrap), charge it, count
    it, and roll the remote ones over their path as ``link_send`` does,
    advancing ``counters`` (the four 0-d ``TX_COUNTERS``). ``now`` and
    ``dst`` are [H] or one value for every host."""
    if not mask.is_cuda:
        return nic_tx_plain(mask, now, dst, queued, gid, tx_rem, tx_tick,
                            tx_refill, tx_cap, tx_packets, tx_bytes, payload,
                            vertex, vertex_g, latency_vv, reliability_vv,
                            rng_keys, rng_counter, counters,
                            bootstrap_end=bootstrap_end)
    H, U = mask.shape[0], latency_vv.shape[0]
    table = vertex if vertex_g is None else vertex_g
    I64, I32, B = torch.int64, torch.int32, torch.bool
    out = _packed(H, 6, 4, 4, mask.device)
    _launch(NIC_TX, _PACK["nic_tx"].pack(
        *_ptrs(B, mask), *_per_host(now, H, I64, "now"),
        *_per_host(dst, H, I32, "dst"), *_ptrs(B, queued),
        *_ptrs(I32, gid),
        *_ptrs(I64, tx_rem, tx_tick, tx_refill, tx_cap, tx_packets,
               tx_bytes),
        *_payload(payload, H), *_ptrs(I32, vertex, table), table.numel(),
        *_ptrs(I64, latency_vv), *_ptrs(torch.float32, reliability_vv), U,
        *_ptrs(I64, rng_keys, rng_counter, *counters), int(bootstrap_end),
        out.data_ptr(), H), _stream(mask))
    rows, totals, flags = _rows(out, H, 6, 4, 4)
    return TxOut(*rows, totals, *flags)


class RxOut(NamedTuple):
    """The admission of every host's arrival (``nic_rx``), [H] each. On
    the card every tensor is a view of one allocation."""

    rx_rem: torch.Tensor  # int64
    rx_tick: torch.Tensor  # int64
    interval_expire: torch.Tensor  # int64: 0 where delivered directly
    drop_mode: torch.Tensor  # bool: false where delivered directly
    queued: torch.Tensor  # bool: remote, not direct: to the router ring
    no_room: torch.Tensor  # bool: queued to a full ring
    local: torch.Tensor  # bool: delivered now (loopback or direct)


def nic_rx_plain(mask, src, gid, now, rx_rem, rx_tick, rx_refill, rx_cap,
                 q_head, q_tail, payload, interval_expire, drop_mode, *,
                 slots: int, bootstrap_end: int) -> RxOut:
    """Plain version: the JAX package's ``NetStack.on_pkt_deliver`` ahead
    of its enqueue and delivery, as the stack ran it before this kernel:
    the refill (``nic_refill_plain``) of the remote arrivals, the direct
    test against the router ring (``slots`` deep), the charge and the
    zero-sojourn CoDel reset."""
    loopback = mask & (src == gid)
    remote = mask & (src != gid)
    rx_rem, rx_tick = nic_refill_plain(rx_rem, rx_tick, rx_refill, rx_cap,
                                       now, remote)
    bootstrap = now < bootstrap_end
    direct = (remote & ~(q_head < q_tail)
              & (bootstrap | (rx_rem >= MTU)))
    rx_rem = torch.where(direct & ~bootstrap, rx_rem - wire_bytes(payload),
                         rx_rem)
    queued = remote & ~direct
    return RxOut(
        rx_rem=rx_rem, rx_tick=rx_tick,
        interval_expire=torch.where(direct, 0, interval_expire),
        drop_mode=torch.where(direct, False, drop_mode), queued=queued,
        no_room=queued & ~((q_tail - q_head) < slots),
        local=loopback | direct)


def nic_rx(mask, src, gid, now, rx_rem, rx_tick, rx_refill, rx_cap, q_head,
           q_tail, payload, interval_expire, drop_mode, *, slots: int,
           bootstrap_end: int) -> RxOut:
    """Each masked host's arrival from ``src``: loopback is delivered; a
    remote packet is delivered now when the router ring (``q_head``,
    ``q_tail``, ``slots`` deep) is empty and the refilled rx bucket holds
    an MTU (or in bootstrap), and is charged; else it is queued. ``now``
    is [H] or one value for every host."""
    if not mask.is_cuda:
        return nic_rx_plain(mask, src, gid, now, rx_rem, rx_tick, rx_refill,
                            rx_cap, q_head, q_tail, payload, interval_expire,
                            drop_mode, slots=slots,
                            bootstrap_end=bootstrap_end)
    H = mask.shape[0]
    I64, I32 = torch.int64, torch.int32
    out = _packed(H, 3, 0, 4, mask.device)
    _launch(NIC_RX, _PACK["nic_rx"].pack(
        *_ptrs(torch.bool, mask), *_ptrs(I32, src, gid),
        *_per_host(now, H, I64, "now"),
        *_ptrs(I64, rx_rem, rx_tick, rx_refill, rx_cap),
        *_ptrs(I32, q_head, q_tail), int(slots), *_payload(payload, H),
        *_ptrs(I64, interval_expire), *_ptrs(torch.bool, drop_mode),
        int(bootstrap_end), out.data_ptr(), H), _stream(mask))
    rows, _, flags = _rows(out, H, 3, 0, 4)
    return RxOut(*rows, *flags)


def nic_gate_plain(rx_rem, rx_tick, rx_refill, rx_cap, tx_rem, tx_tick,
                   tx_refill, tx_cap, r_head, r_tail, queued, recv_pending,
                   send_pending, *, win_start: int, free: bool,
                   G: int) -> torch.Tensor:
    """Plain version: the JAX package's ``NetStack.bulk_gate``, as the
    stack ran it before this kernel (two ``nic_refill_plain`` calls to the
    window start). ``//`` floors on token debt, as JAX's does."""
    ws = torch.tensor(int(win_start), dtype=torch.int64,
                      device=rx_rem.device)
    rx, _ = nic_refill_plain(rx_rem, rx_tick, rx_refill, rx_cap, ws)
    tx, _ = nic_refill_plain(tx_rem, tx_tick, tx_refill, tx_cap, ws)
    if free:
        # the whole window inside bootstrap: tokens are not charged
        rx_ev, tx_ev = torch.full_like(rx, G), torch.full_like(tx, G)
    else:
        rx_ev, tx_ev = rx // MTU, tx // MTU
    quiet = ~(r_head < r_tail) & ~queued & ~recv_pending & ~send_pending
    cap = torch.minimum(rx_ev, tx_ev) - 1  # the head uses one budget
    return torch.where(quiet, cap.clamp(0, G - 1), 0).to(torch.int32)


def nic_gate(rx_rem, rx_tick, rx_refill, rx_cap, tx_rem, tx_tick, tx_refill,
             tx_cap, r_head, r_tail, queued, recv_pending, send_pending, *,
             win_start: int, free: bool, G: int) -> torch.Tensor:
    """[H] int32: how many extra consecutive arrivals each host may batch
    in a micro-step from ``win_start``: both buckets refilled to it (and
    not written back), each arrival and reply budgeted an MTU (``G`` each
    where the window is ``free``, wholly inside bootstrap), capped at
    ``G - 1``; 0 wherever the router ring is nonempty, the NIC queue
    holds packets (``queued``) or a pump is armed."""
    args = (rx_rem, rx_tick, rx_refill, rx_cap, tx_rem, tx_tick, tx_refill,
            tx_cap, r_head, r_tail, queued, recv_pending, send_pending)
    if not rx_rem.is_cuda:
        return nic_gate_plain(*args, win_start=win_start, free=free, G=G)
    H = rx_rem.shape[0]
    out = torch.empty(H, dtype=torch.int32, device=rx_rem.device)
    _launch(NIC_GATE, _PACK["nic_gate"].pack(
        *_ptrs(torch.int64, *args[:8]), *_ptrs(torch.int32, r_head, r_tail),
        *_ptrs(torch.bool, *args[10:]), int(win_start), int(bool(free)),
        int(G), out.data_ptr(), H), _stream(rx_rem))
    return out


# ---------------------------------------------------------------------------
# K22 qdisc_enqueue, K23 qdisc_dequeue
# ---------------------------------------------------------------------------

# the fields of the device-queue disciplines' sub-state, in the order of
# the pointers the two C entries take (the JAX package's dict keys): the
# common ones, then pifo's q_len, then eiffel's q_valid, q_bucket and
# cur_bucket; a discipline's state has the common ones and its own
QDISC_FIELDS = (
    "q_payload", "q_dst", "q_rank", "q_seq", "q_enq_ts", "q_bytes", "seq",
    "cls", "vtime", "finish", "shape_next", "drop_mode", "interval_expire",
    "next_drop", "drop_count", "drop_count_last", "red_avg", "red_count",
    "enqueues", "dequeues", "drops_overflow", "drops_red", "drops_codel",
    "sojourn_sum", "depth_peak", "q_len", "q_valid", "q_bucket",
    "cur_bucket")
_QDISC_DTYPES = dict.fromkeys(QDISC_FIELDS, torch.int64) | {
    "q_payload": torch.int32, "q_dst": torch.int32, "cls": torch.int32,
    "drop_mode": torch.bool, "drop_count": torch.int32,
    "drop_count_last": torch.int32, "q_len": torch.int32,
    "q_valid": torch.bool}
_RANKS = ("fifo", "prio", "wfq")
_DROPS = ("none", "red", "codel")


@dataclass(frozen=True, eq=False)
class QdiscSpec:
    """A device-queue discipline's build-time configuration, which both
    kernels and their plain versions take: the sub-state's field
    ``names``; pifo or ``eiffel``; the ranker (``rank``, ``classes``,
    the [C] int64 tables ``inv_w`` and ``ns_per_byte`` on the state's
    device, ``shaped``); the drop policy (``drop``, and ``red``, a
    ``net.qdisc.drops.RedConfig`` where RED runs); Eiffel's ``buckets``
    and ``bucket_width``."""

    names: tuple
    eiffel: bool
    rank: str
    classes: int
    inv_w: torch.Tensor
    ns_per_byte: torch.Tensor
    shaped: bool
    drop: str
    red: object = None
    buckets: int = 0
    bucket_width: int = 1


class QdiscEnqueueOut(NamedTuple):
    """The sub-state after one enqueue, its fields in ``spec.names``
    order (on the card the tensors it was given, written in place), and
    ``ok``: the packets admitted."""

    fields: tuple
    ok: torch.Tensor  # [H] bool


class QdiscDequeueOut(NamedTuple):
    """The sub-state after one dequeue (on the card written in place)
    and the packet handed up: ``have`` marks hosts that got one;
    ``payload`` and ``dst`` are the slot the last pop read elsewhere."""

    fields: tuple
    have: torch.Tensor  # [H] bool
    payload: torch.Tensor  # [H, P] int32
    dst: torch.Tensor  # [H] int32


def qdisc_enqueue_plain(fields, mask, dst, payload, now, *,
                        spec: QdiscSpec) -> QdiscEnqueueOut:
    """Plain version: the JAX package's ``DeviceQueueDiscipline.enqueue``
    (``net/qdisc/pifo.py:enqueue_plain``)."""
    from shadow_tpu_torch.net.qdisc import pifo

    return pifo.enqueue_plain(fields, mask, dst, payload, now, spec)


def qdisc_dequeue_plain(fields, now, want, *,
                        spec: QdiscSpec) -> QdiscDequeueOut:
    """Plain version: the JAX package's ``DeviceQueueDiscipline.dequeue``
    (``net/qdisc/pifo.py:dequeue_plain``)."""
    from shadow_tpu_torch.net.qdisc import pifo

    return pifo.dequeue_plain(fields, now, want, spec)


def _qdisc_fields(fields, spec: QdiscSpec, H: int):
    """(Q, P, C, the pointer of every field of QDISC_FIELDS or 0) of a
    sub-state on the card; raises on a field of the wrong type, shape or
    layout (the kernels write every one but cls in place)."""
    if len(fields) != len(spec.names):
        raise ValueError(f"qdisc: {len(fields)} fields for "
                         f"{len(spec.names)} names")
    by = dict(zip(spec.names, fields))
    H_, Q, P = by["q_payload"].shape
    C = by["finish"].shape[1] if by["finish"].dim() == 2 else -1
    if H_ != H or P > W_TRAIL:
        raise ValueError(f"qdisc: q_payload {tuple(by['q_payload'].shape)} "
                         f"for {H} hosts (packet trails, P > 12, are not "
                         f"ported)")
    if C != spec.classes or spec.inv_w.shape != (C,) or (
            spec.ns_per_byte.shape != (C,)):
        raise ValueError("qdisc: the class tables do not match finish")
    shapes = {"q_payload": (H, Q, P), "finish": (H, C),
              "shape_next": (H, C)}
    ptrs = []
    for name in QDISC_FIELDS:
        t = by.get(name)
        if t is None:
            ptrs.append(0)
            continue
        plane = name.startswith("q_") and name not in ("q_bytes", "q_len")
        shape = shapes.get(name, (H, Q) if plane else (H,))
        ptrs.append(_check(t, _QDISC_DTYPES[name], shape, name))
    return Q, P, C, ptrs


_PACK["qdisc_enqueue"] = struct.Struct(f"<{len(QDISC_FIELDS) + 23}q")
_PACK["qdisc_dequeue"] = struct.Struct(f"<{len(QDISC_FIELDS) + 12}q")


def _f64_bits(x: float) -> int:
    return struct.unpack("<q", struct.pack("<d", x))[0]


def qdisc_enqueue(fields, mask, dst, payload, now, *,
                  spec: QdiscSpec) -> QdiscEnqueueOut:
    """Each masked host's packet (``payload`` [H, P] to ``dst``, at
    ``now``; ``dst`` and ``now`` may be one value for every host) into
    its discipline's queue: admission, RED, the rank and the insert (see
    ``qdisc_enqueue_plain``).

    On the card the kernel writes the sub-state's tensors (``fields``,
    in ``spec.names`` order) in place and returns those very tensors;
    the discipline's state class lists them in ``IN_PLACE``, which
    ``SimState.snapshot()`` clones. To compare the kernel with its plain
    version, hand the kernel clones."""
    if not _on_card(*fields, mask, dst, payload, now, spec.inv_w,
                    spec.ns_per_byte):
        return qdisc_enqueue_plain(fields, mask, dst, payload, now,
                                   spec=spec)
    H = mask.shape[0]
    Q, P, C, ptrs = _qdisc_fields(fields, spec, H)
    red = spec.red
    ok = torch.empty(H, dtype=torch.bool, device=mask.device)
    _launch(QDISC_ENQUEUE, _PACK["qdisc_enqueue"].pack(
        *ptrs, _check(mask, torch.bool, (H,), "mask"),
        *_per_host(dst, H, torch.int32, "dst"), *_payload(payload, H),
        *_per_host(now, H, torch.int64, "now"),
        *_ptrs(torch.int64, spec.inv_w, spec.ns_per_byte), ok.data_ptr(),
        H, Q, P, C, int(spec.eiffel), _RANKS.index(spec.rank),
        int(spec.shaped), _DROPS.index(spec.drop), spec.buckets,
        spec.bucket_width, 0 if red is None else red.min_fp,
        0 if red is None else red.max_fp,
        _f64_bits(0.0 if red is None else red.scale)), _stream(mask))
    return QdiscEnqueueOut(tuple(fields), ok)


def qdisc_dequeue(fields, now, want, *, spec: QdiscSpec) -> QdiscDequeueOut:
    """One packet from each wanting host's discipline queue, under the
    CoDel hook where ``spec.drop`` is codel (see ``qdisc_dequeue_plain``);
    ``now`` may be one value for every host. On the card the kernel
    writes ``fields`` in place, as ``qdisc_enqueue``'s does."""
    if not _on_card(*fields, now, want):
        return qdisc_dequeue_plain(fields, now, want, spec=spec)
    H = want.shape[0]
    Q, P, _, ptrs = _qdisc_fields(fields, spec, H)
    dev = want.device
    out = QdiscDequeueOut(
        tuple(fields), torch.empty(H, dtype=torch.bool, device=dev),
        torch.empty((H, P), dtype=torch.int32, device=dev),
        torch.empty(H, dtype=torch.int32, device=dev))
    _launch(QDISC_DEQUEUE, _PACK["qdisc_dequeue"].pack(
        *ptrs, *_per_host(now, H, torch.int64, "now"),
        _check(want, torch.bool, (H,), "want"), out.have.data_ptr(),
        out.payload.data_ptr(), out.dst.data_ptr(), H, Q, P,
        int(spec.eiffel), int(spec.drop == "codel"), spec.buckets),
        _stream(want))
    return out


class WindowOps(NamedTuple):
    """The window-step functions the engine and the network stack call."""

    window_sort: object
    pool_merge: object
    extract_slots: object
    phold_forward: object
    audit_commit: object
    loop_select: object
    loop_route: object
    codel_dequeue: object
    ring_append: object
    tcp_demux: object
    tcp_ack: object
    tcp_reorder: object
    tcp_out: object
    spec_check: object
    nic_refill: object
    send_dequeue: object
    link_send: object
    nic_tx: object
    nic_rx: object
    nic_gate: object
    cpu_serialize: object
    qdisc_enqueue: object
    qdisc_dequeue: object


# the wrappers: the kernels on the card, the plain versions on the CPU
KERNEL_OPS = WindowOps(window_sort, pool_merge, extract_slots,
                       phold_forward, audit_commit,
                       loop_select, loop_route, codel_dequeue, ring_append,
                       tcp_demux, tcp_ack, tcp_reorder, tcp_out, spec_check,
                       nic_refill, send_dequeue, link_send, nic_tx, nic_rx,
                       nic_gate, cpu_serialize, qdisc_enqueue, qdisc_dequeue)
# the plain versions on any device (the on-card comparison run)
PLAIN_OPS = WindowOps(window_sort_plain, pool_merge_plain,
                      extract_slots_plain, phold_forward_plain,
                      audit_commit_plain, loop_select_plain, loop_route_plain,
                      codel_dequeue_plain, ring_append_plain,
                      tcp_demux_plain, tcp_ack_plain, tcp_reorder_plain,
                      tcp_out_plain, spec_check_plain, nic_refill_plain,
                      send_dequeue_plain, link_send_plain, nic_tx_plain,
                      nic_rx_plain, nic_gate_plain, cpu_serialize_plain,
                      qdisc_enqueue_plain, qdisc_dequeue_plain)
