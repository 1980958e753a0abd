"""The window step's hand-written CUDA kernels, their plain PyTorch
versions, and the build and ctypes binding.

Seven kernels carry the window step on the card (sources under
``csrc/``, one shared library each). The PHOLD matrix path runs the
first three:

* ``extract_slots`` (K3): dense slot of each row of the sorted window
  keys — the rank scan of ``shadow_tpu/core/engine.py:_dense_extract``.
* ``phold_forward`` (K1): PHOLD's forwarding over the ``[H, K]`` window —
  ``shadow_tpu/net/apps.py:PholdApp.handle_msg_matrix`` with its threefry
  draws, plus the per-source seq numbering of ``run_matrix``.
* ``audit_commit`` (K2): the per-host commit of the window — the audit
  fold (``shadow_tpu/obs/audit.py:fold``, column by column) and the
  per-host event count and frontier updates of ``run_matrix``. The
  micro-step loop path reuses it on each micro-step's taken events.

The micro-step loop path and the network stack run the other four:

* ``loop_select`` (K4): each host's event for one micro-step — the
  candidate choice, bulk batch plan, outbox and pool-headroom gates of
  ``shadow_tpu/core/engine.py:make_loop_fns.body``.
* ``loop_route`` (K5): the routing of one micro-step's emissions into the
  per-host inbox and outbox, in emit order (the same ``body``).
* ``codel_dequeue`` (K6): the CoDel router's dequeue,
  ``shadow_tpu/net/codel.py:dequeue``.
* ``ring_append`` (K7): a masked append to a per-host ring, for the
  router's ``codel.enqueue`` and the NIC's ``nic.enqueue_send``.

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
LOOP_SELECT = Kernel(
    "loop_select",
    (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,  # inputs
     _P, _P, _P, _P, _P, _P, _P, _P, _P,  # outputs
     _I, _I, _I, _I, _I, _I, _I, _L, _L, _I, _I, _I, _P),
)
LOOP_ROUTE = Kernel(
    "loop_route",
    (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,  # records, seq_next, keys
     _P, _P, _P, _P, _P,  # inbox
     _P, _P, _P, _P, _P, _P, _P,  # outbox
     _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,  # outputs
     _I, _I, _I, _I, _I, _L, _P),
)
CODEL_DEQUEUE = Kernel(
    "codel_dequeue",
    (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,  # inputs
     _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,  # outputs
     _I, _I, _I, _I, _P),
)
RING_APPEND = Kernel(
    "ring_append",
    (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,  # inputs
     _P, _P, _P, _P, _P, _P,  # outputs
     _I, _I, _I, _P),
)
KERNELS = (EXTRACT_SLOTS, PHOLD_FORWARD, AUDIT_COMMIT, LOOP_SELECT,
           LOOP_ROUTE, CODEL_DEQUEUE, RING_APPEND)


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
    keys = audit.event_key(d_t, d_s, gid[:, None], d_k)
    hd = host_digest
    for j in range(d_t.shape[1]):
        hd = torch.where(valid[:, j], hd * audit.CHAIN_MULT + keys[:, j],
                         hd)
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


# ---------------------------------------------------------------------------
# K4 loop_select
# ---------------------------------------------------------------------------

# the largest inbox the kernel's tournament holds in registers
MAX_INBOX = 32


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
    ``loop_select_plain``); one block scans the headroom gate over all
    hosts."""
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
    if not (0 < B <= MAX_INBOX) or K >= Kc or G < 1:
        raise ValueError(f"loop_select: want 0 < B <= {MAX_INBOX}, K < Kc "
                         f"and G >= 1, got B={B} K={K} Kc={Kc} G={G}")
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
    _launch(LOOP_SELECT, *ins, *(t.data_ptr() for t in out), H, Kc, B, PP,
            NK, K, G, win_end, pool_budget, O, bulk_kind,
            int(self_excluded), _stream(d_t))
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
    [E, H, PP] packed), into the boxes (see ``loop_route_plain``)."""
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
    obox = Boxes(*(torch.empty(sh, dtype=dt, device=dev)
                   for dt, sh in shapes))
    out = RouteOut(boxes=obox,
                   seq_next=torch.empty(H, dtype=torch.int32, device=dev),
                   stats=torch.empty((H, 3), dtype=torch.int64, device=dev))
    _launch(LOOP_ROUTE, *ins, *bins, *(x.data_ptr() for x in obox),
            out.seq_next.data_ptr(), out.stats.data_ptr(), E, H, B, O, PP,
            win_end, _stream(m))
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
    where the ring has no timestamp column / byte tally."""

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
    them."""
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
        payload=e(torch.int32, H, Q, P), col=e(torch.int32, H, Q),
        ts=None if q_ts is None else e(torch.int64, H, Q),
        tail=e(torch.int32, H),
        total_size=None if total_size is None else e(torch.int64, H),
        ok=e(torch.bool, H),
    )
    _launch(RING_APPEND, *ins,
            *(0 if t is None else t.data_ptr() for t in out), H, Q, P,
            _stream(q_payload))
    return out


class WindowOps(NamedTuple):
    """The window-step functions the engine and the network stack call."""

    extract_slots: object
    phold_forward: object
    audit_commit: object
    loop_select: object
    loop_route: object
    codel_dequeue: object
    ring_append: object


# the wrappers: the kernels on the card, the plain versions on the CPU
KERNEL_OPS = WindowOps(extract_slots, phold_forward, audit_commit,
                       loop_select, loop_route, codel_dequeue, ring_append)
# the plain versions on any device (the on-card comparison run)
PLAIN_OPS = WindowOps(extract_slots_plain, phold_forward_plain,
                      audit_commit_plain, loop_select_plain, loop_route_plain,
                      codel_dequeue_plain, ring_append_plain)
