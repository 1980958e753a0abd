"""Deterministic seeded randomness, bit-exact with the JAX package.

The hierarchy is the JAX package's (``shadow_tpu/core/rng.py``):

    root  = PRNGKey(config seed)
    host  = fold_in(root, host_id)
    draw  = fold_in(host, per-host draw counter)

so every random decision is a pure function of (seed, host_id, counter).
This module reproduces JAX's threefry2x32 generator bit for bit in the form
``jax_threefry_partitionable=True`` gives (the jax 0.9 default):

* ``fold_in(key, d)`` is ``threefry2x32(key, (0, d))``;
* a 32-bit draw from ``key`` is ``y0 ^ y1`` of ``threefry2x32(key, (0, 0))``;
* a float32 uniform is ``bitcast((bits >> 9) | 0x3F800000) - 1``.

torch's ``uint32`` lacks most operators, so every 32-bit word is held in an
int64 tensor and masked with ``& 0xFFFFFFFF`` after each add and shift.
The CUDA kernel ``csrc/phold_forward.cu`` carries the same generator in
native uint32 arithmetic.
"""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds (Salmon et al., SC'11), as in
    ``jax._src.prng.threefry2x32``. All arguments are int64 tensors (or
    ints) holding uint32 values; returns the two output words likewise.
    CPU arguments go through numpy's native uint32 arithmetic, where each
    of the ~120 elementwise steps costs far less at the engine's small
    widths; card tensors through ``threefry2x32_torch``. Both give the same
    bits (``tests/test_torch_rng.py``)."""
    args = (k0, k1, x0, x1)
    if all(not isinstance(a, torch.Tensor) or a.device.type == "cpu"
           for a in args):
        return _threefry2x32_numpy(*args)
    return threefry2x32_torch(*args)


def _threefry2x32_numpy(k0, k1, x0, x1):
    def u32(a):
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        return a.astype(np.uint32)

    k0, k1, x0, x1 = np.broadcast_arrays(*(u32(a) for a in (k0, k1, x0, x1)))
    with np.errstate(over="ignore"):
        ks = (k0, k1, k0 ^ k1 ^ np.uint32(_PARITY))
        x0 = x0 + ks[0]
        x1 = x1 + ks[1]
        for i in range(5):
            for r in _ROT[i % 2]:
                x0 = x0 + x1
                x1 = ((x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return (torch.from_numpy(np.array(x0, dtype=np.int64)),
            torch.from_numpy(np.array(x1, dtype=np.int64)))


def threefry2x32_torch(k0, k1, x0, x1):
    """``threefry2x32`` in torch int64 arithmetic masked to 32 bits, for
    tensors on any device."""
    k0 = torch.as_tensor(k0, dtype=torch.int64)
    k1 = torch.as_tensor(k1, dtype=torch.int64)
    ks = (k0, k1, (k0 ^ k1 ^ _PARITY) & M32)
    x0 = (torch.as_tensor(x0, dtype=torch.int64) + ks[0]) & M32
    x1 = (torch.as_tensor(x1, dtype=torch.int64) + ks[1]) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            # x0 is masked once per four rounds (it stays below 2**35);
            # only its low 32 bits reach x1, which is masked every round
            x0 = x0 + x1
            x1 = (((x1 << r) | (x1 >> (32 - r))) ^ x0) & M32
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def root_key(seed: int, device=None) -> torch.Tensor:
    """[2] int64: ``jax.random.PRNGKey(seed)`` = (seed >> 32, seed & M)."""
    seed = int(seed)
    return torch.tensor(
        [(seed >> 32) & M32, seed & M32], dtype=torch.int64, device=device
    )


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` over a batch: key [..., 2], data broadcastable
    to key[..., 0] (uint32 values in int64). Returns [..., 2]."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device) & M32
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                          data)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def random_bits32(key: torch.Tensor) -> torch.Tensor:
    """One uint32 draw per key (``jax.random.bits(key, dtype=uint32)``)."""
    z = torch.zeros_like(key[..., 0])
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], z, z)
    return y0 ^ y1


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """JAX's float32 uniform in [0, 1) from 32 random bits."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def host_keys(seed: int, num_hosts: int, device=None) -> torch.Tensor:
    """[H, 2] int64 key array: one independent stream root per host."""
    root = root_key(seed, device)
    ids = torch.arange(num_hosts, dtype=torch.int64, device=device)
    return fold_in(root.expand(num_hosts, 2), ids)


def uniform_per_host(hkeys: torch.Tensor, counters: torch.Tensor):
    """[H] float32: one draw per host at counters [H]."""
    return bits_to_uniform(random_bits32(fold_in(hkeys, counters)))


def uniform_matrix(hkeys: torch.Tensor, counters: torch.Tensor):
    """[H, K] float32: element (h, k) is host h's draw at counters[h, k]."""
    keys = hkeys[:, None, :].expand(counters.shape + (2,))
    return bits_to_uniform(random_bits32(fold_in(keys, counters)))


def bits_per_host(hkeys: torch.Tensor, counters: torch.Tensor):
    """[H] uint32 values in int64: one 32-bit draw per host at counters."""
    return random_bits32(fold_in(hkeys, counters))
