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


# ---------------------------------------------------------------------------
# Masked per-row slot access (the JAX package's get_at / set_at / add_at)
# ---------------------------------------------------------------------------
#
# ``arr`` is [H, S] or [H, S, P]; ``col`` is [H] (one slot per host);
# ``mask`` is [H]; ``val`` is a scalar, [H] or [H, P]. A slot outside
# [0, S) reads as 0 and is never written, as in the JAX package: a bare
# gather would raise there instead.


def _hit(arr: torch.Tensor, mask, col: torch.Tensor) -> torch.Tensor:
    cols = torch.arange(arr.shape[1], dtype=col.dtype, device=arr.device)
    hit = cols[None, :] == col[:, None]
    return hit if mask is None else hit & mask[:, None]


def _val(arr: torch.Tensor, val) -> torch.Tensor:
    val = torch.as_tensor(val, dtype=arr.dtype, device=arr.device)
    if arr.dim() == 3 and val.dim() == 2:
        return val[:, None, :]
    if arr.dim() == 2 and val.dim() == 1:
        return val[:, None]
    return val


def get_at(arr: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """arr[h, col[h]]; 0 where col[h] is outside [0, S)."""
    hit = _hit(arr, None, col)
    if arr.dim() == 3:
        hit = hit[:, :, None]
    return torch.where(hit, arr, 0).sum(dim=1, dtype=arr.dtype)


def set_at(arr: torch.Tensor, mask, col: torch.Tensor, val) -> torch.Tensor:
    """arr[h, col[h]] = val[h] where mask[h]."""
    hit = _hit(arr, mask, col)
    if arr.dim() == 3:
        hit = hit[:, :, None]
    return torch.where(hit, _val(arr, val), arr)


def add_at(arr: torch.Tensor, mask, col: torch.Tensor, val) -> torch.Tensor:
    """arr[h, col[h]] += val[h] where mask[h]."""
    hit = _hit(arr, mask, col)
    if arr.dim() == 3:
        hit = hit[:, :, None]
    return arr + torch.where(hit, _val(arr, val), 0)
