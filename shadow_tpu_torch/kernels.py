"""The window step's hand-written CUDA kernels, their plain PyTorch
versions, and the build and ctypes binding.

Three kernels carry the PHOLD window step on the card (sources under
``csrc/``, one shared library each):

* ``extract_slots`` (K3): dense slot of each row of the sorted window
  keys — the rank scan of ``shadow_tpu/core/engine.py:_dense_extract``.
* ``phold_forward`` (K1): PHOLD's forwarding over the ``[H, K]`` window —
  ``shadow_tpu/net/apps.py:PholdApp.handle_msg_matrix`` with its threefry
  draws, plus the per-source seq numbering of ``run_matrix``.
* ``audit_commit`` (K2): the per-host commit of the window — the audit
  fold (``shadow_tpu/obs/audit.py:fold``, column by column) and the
  per-host event count and frontier updates of ``run_matrix``.

Each wrapper runs its plain version for tensors on the CPU and launches
its kernel for tensors on the card; there is no fallback from one to the
other. A wrapper adds one to its kernel's ``launches`` where it launches
the kernel and nowhere else.

The kernels are built with nvcc for ``sm_90a`` at first use, into
``_build/`` beside this file, and loaded with ctypes; every pointer and
the stream pass as ``c_void_p``. Each C entry returns
``cudaGetLastError()`` after its launch and the wrapper raises if it is not
0. ``--fmad=false`` keeps every float32 multiply and add separately
rounded, as XLA and the plain versions compute them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from dataclasses import dataclass
from typing import NamedTuple

import torch

from shadow_tpu_torch.core import rng
from shadow_tpu_torch.core.simtime import NEVER

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


@dataclass
class Kernel:
    """One CUDA kernel: its source, C entry and argument types, and the
    count of its launches."""

    name: str
    argtypes: tuple
    launches: int = 0

    @property
    def source(self) -> str:
        return os.path.join(CSRC, f"{self.name}.cu")


EXTRACT_SLOTS = Kernel("extract_slots", (_P, _P, _L, _I, _I, _P))
PHOLD_FORWARD = Kernel(
    "phold_forward",
    (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,  # inputs
     _P, _P, _P, _P, _P, _P, _P, _P, _P,  # outputs
     _I, _I, _I, _I, _I, _L, _L, _L, _I, _P),
)
AUDIT_COMMIT = Kernel(
    "audit_commit",
    (_P, _P, _P, _P, _P, _P, _P, _P,  # inputs
     _P, _P, _P, _P, _P,  # outputs
     _I, _I, _P),
)
KERNELS = (EXTRACT_SLOTS, PHOLD_FORWARD, AUDIT_COMMIT)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


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
    with open(k.source, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode())
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


def _lib(k: Kernel):
    lib = _libs.get(k.name)
    if lib is None:
        path = _lib_path(k)
        if not os.path.exists(path):
            build((k,))
        lib = ctypes.CDLL(path)
        fn = getattr(lib, k.name)
        fn.argtypes = list(k.argtypes)
        fn.restype = ctypes.c_int
        _libs[k.name] = lib
    return getattr(lib, k.name)


def _launch(k: Kernel, *args) -> None:
    rc = _lib(k)(*args)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {k.name} failed to launch: "
                           f"cudaError {rc}")
    k.launches += 1


def _on_card(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU tensors; raises on a mix or on
    another device type."""
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
    return torch.cuda.current_stream(t.device).cuda_stream


# ---------------------------------------------------------------------------
# K3 extract_slots
# ---------------------------------------------------------------------------


def extract_slots_plain(s_k1: torch.Tensor, H: int, Kc: int) -> torch.Tensor:
    """Plain version: the JAX package's boundary + cummax rank scan."""
    N = s_k1.shape[0]
    s_key = s_k1 >> DT_BITS
    iota = torch.arange(N, dtype=torch.int64, device=s_k1.device)
    boundary = torch.ones(N, dtype=torch.bool, device=s_k1.device)
    boundary[1:] = s_key[1:] != s_key[:-1]
    run_start = torch.cummax(torch.where(boundary, iota, -1), dim=0).values
    rank = iota - run_start
    extract = (s_key < H) & (rank < Kc)
    return torch.where(extract, s_key * Kc + rank, N).to(torch.int32)


def extract_slots(s_k1: torch.Tensor, H: int, Kc: int) -> torch.Tensor:
    """[N] int32 dense slot of each sorted window row: key * Kc + rank for
    the first Kc rows of each host run, N for every other row."""
    if not _on_card(s_k1):
        return extract_slots_plain(s_k1, H, Kc)
    N = s_k1.shape[0]
    slot = torch.empty(N, dtype=torch.int32, device=s_k1.device)
    _launch(EXTRACT_SLOTS, _check(s_k1, torch.int64, (N,), "s_k1"),
            slot.data_ptr(), N, H, Kc, _stream(s_k1))
    return slot


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


def pick_dst(u: torch.Tensor, my_id: torch.Tensor, num_hosts: int):
    """PHOLD's uniform destination: skip self, in float32 like the JAX
    package (``floor(u * (H - 1))``, clipped to [0, H - 2])."""
    if num_hosts <= 1:
        return my_id.expand(u.shape).to(torch.int32)
    d = torch.floor(u * float(num_hosts - 1)).to(torch.int32)
    d = d.clamp(0, num_hosts - 2)
    return d + (d >= my_id).to(torch.int32)


def phold_forward_plain(d_t, d_p, rng_keys, rng_counter, seq_next, gid,
                        vertex, latency_vv, reliability_vv, vertex_g, *,
                        num_hosts: int, stop_sending: int,
                        bootstrap_end: int, win_end: int,
                        kind: int) -> ForwardOut:
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
    dst = pick_dst(u1, my_id, num_hosts)
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
                  kind: int) -> ForwardOut:
    """PHOLD forward over one window's [H, K] dense events: draws, the
    destination pick, latency and loss, and the numbered emission rows."""
    args = (d_t, d_p, rng_keys, rng_counter, seq_next, gid, vertex,
            latency_vv, reliability_vv)
    if not _on_card(*args, *(() if vertex_g is None else (vertex_g,))):
        return phold_forward_plain(
            *args, vertex_g, num_hosts=num_hosts, stop_sending=stop_sending,
            bootstrap_end=bootstrap_end, win_end=win_end, kind=kind,
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
    _launch(PHOLD_FORWARD, *ins, *(t.data_ptr() for t in out),
            H, K, PP, U, num_hosts, stop_sending, bootstrap_end, win_end,
            kind, _stream(d_t))
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


def audit_commit_plain(d_t, d_s, d_k, gid, host_digest, host_events,
                       host_last_t, done_t) -> CommitOut:
    """Plain version: the JAX package's fold over the K columns in order."""
    from shadow_tpu_torch.obs import audit

    valid = d_t != NEVER
    hd = host_digest
    for j in range(d_t.shape[1]):
        hd = audit.fold(hd, valid[:, j], d_t[:, j], d_s[:, j], gid,
                        d_k[:, j])
    n = valid.sum(dim=1)
    last_t = torch.where(valid, d_t, -1).amax(dim=1)
    return CommitOut(
        host_digest=hd,
        host_events=host_events + n,
        host_last_t=torch.where(n > 0, last_t, host_last_t),
        done_t=torch.where(n > 0, last_t, done_t),
        n_valid=n,
    )


def audit_commit(d_t, d_s, d_k, gid, host_digest, host_events, host_last_t,
                 done_t) -> CommitOut:
    """Commit one window's [H, K] dense events per host: fold each event
    into the audit chain in column order, count it, advance the frontier."""
    args = (d_t, d_s, d_k, gid, host_digest, host_events, host_last_t,
            done_t)
    if not _on_card(*args):
        return audit_commit_plain(*args)
    H, K = d_t.shape
    dev = d_t.device
    ins = (
        _check(d_t, torch.int64, (H, K), "d_t"),
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


class WindowOps(NamedTuple):
    """The three window-step functions the engine calls."""

    extract_slots: object
    phold_forward: object
    audit_commit: object


# the wrappers: the kernels on the card, the plain versions on the CPU
KERNEL_OPS = WindowOps(extract_slots, phold_forward, audit_commit)
# the plain versions on any device (the on-card comparison run)
PLAIN_OPS = WindowOps(extract_slots_plain, phold_forward_plain,
                      audit_commit_plain)
