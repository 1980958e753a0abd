"""Payload word packing (the JAX package's ``core/soa.py`` pack helpers).

Events carry P int32 payload words stored as ceil(P/2) int64 columns,
pairs packed as ``(word 2w+1) << 32 | (word 2w, zero-extended)``; odd P
pads the last high word with zero. PHOLD carries P = 2 words, which pack
into one int64 column. The packed layout is part of the pool state that
the parity tests compare with the JAX package.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


def pack_words(payload: torch.Tensor) -> torch.Tensor:
    """[..., P] int32 → [..., ceil(P/2)] int64."""
    P = payload.shape[-1]
    if P % 2:
        pad = torch.zeros(payload.shape[:-1] + (1,), dtype=payload.dtype,
                          device=payload.device)
        payload = torch.cat([payload, pad], dim=-1)
    lo = payload[..., 0::2].to(torch.int64) & _M32
    hi = payload[..., 1::2].to(torch.int64)
    return (hi << 32) | lo


def unpack_words(packed: torch.Tensor, P: int) -> torch.Tensor:
    """Inverse of pack_words: [..., PP] int64 → [..., P] int32."""
    lo = (packed & _M32).to(torch.int32)
    hi = (packed >> 32).to(torch.int32)
    out = torch.stack([lo, hi], dim=-1).reshape(packed.shape[:-1] + (-1,))
    return out[..., :P]


def packed_words(P: int) -> int:
    return (P + 1) // 2
