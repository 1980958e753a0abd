"""Determinism audit chain: per-host digests of committed events.

The same chain as the JAX package's ``obs/audit.py``: every committed
event's key (time, src, dst, kind) is mixed into one int64, and each host
folds its keys in commit order as ``digest * MULT + key`` in wrapping
int64 arithmetic. ``combine`` collapses the per-host digests into one
order-independent value on the host. Two runs that committed the same
history report the same chain.

torch's ``>>`` on int64 is arithmetic; the logical shift of the original
is ``(k >> 31) & (2**33 - 1)``. int64 multiplies wrap two's-complement on
both the CPU and the card, as XLA's do.
"""

from __future__ import annotations

import numpy as np
import torch

_MASK = (1 << 64) - 1


def _i64(x: int) -> int:
    """A 64-bit constant as the python int whose int64 pattern matches."""
    x &= _MASK
    return x - (1 << 64) if x >= (1 << 63) else x


_K_TIME = _i64(0xBF58476D1CE4E5B9)
_K_SRC = _i64(0x94D049BB133111EB)
_K_DST = _i64(0x2545F4914F6CDD1D)
_K_KIND = _i64(0xFF51AFD7ED558CCD)
CHAIN_MULT = _i64(0x5851F42D4C957F2D)
_COMBINE_MULT = 0x9E3779B97F4A7C15
_LOW33 = (1 << 33) - 1


def event_key(time, src, dst, kind) -> torch.Tensor:
    """Mix one committed event's key into a single int64."""
    k = time.to(torch.int64) * _K_TIME
    k = k ^ ((src.to(torch.int64) + 1) * _K_SRC)
    k = k ^ ((dst.to(torch.int64) + 1) * _K_DST)
    k = k ^ ((kind.to(torch.int64) + 1) * _K_KIND)
    return k ^ ((k >> 31) & _LOW33)


def fold(digest, mask, time, src, dst, kind) -> torch.Tensor:
    """One chain step per masked host: digest * MULT + key(event)."""
    nd = digest * CHAIN_MULT + event_key(time, src, dst, kind)
    return torch.where(mask, nd, digest)


def combine(host_digests) -> int:
    """Collapse per-host digests into one unsigned 64-bit chain value with
    a commutative reduction (wrapping sum, xor). Host-side numpy."""
    d = np.asarray(host_digests).astype(np.uint64).reshape(-1)
    if d.size == 0:
        return 0
    s = int(np.sum(d, dtype=np.uint64))
    x = int(np.bitwise_xor.reduce(d))
    return ((s * _COMBINE_MULT) ^ x) & _MASK
