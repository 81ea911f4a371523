"""Ternary weights: TWN ternarization and 2-bit packing (4 trits a byte).

Digit i of a byte sits at bits 2i..2i+1 and trit = digit - 1, packed
along the FIRST (contraction) axis — the layout of `repro.core.ternary`
and of the `ternary_matmul` kernel.
"""
from __future__ import annotations

import torch

TRITS_PER_BYTE_2B = 4


def ternarize(w: torch.Tensor, dim: int = 0):
    """TWN: t = sign(w) * 1{|w| > 0.7 E|w|}, scale = mean |w| over kept
    entries, both reduced over `dim`. Returns (t int8, scale f32)."""
    w = w.float()
    aw = w.abs()
    delta = 0.7 * aw.mean(dim=dim, keepdim=True)
    mask = aw > delta
    t = torch.sign(w) * mask
    denom = mask.sum(dim=dim, keepdim=True).clamp_min(1)
    scale = (aw * mask).sum(dim=dim, keepdim=True) / denom
    return t.to(torch.int8), scale.float()


def ternary_dequant(t: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.bfloat16) -> torch.Tensor:
    return (t.float() * scale).to(dtype)


def pack_ternary_2bit(t: torch.Tensor) -> torch.Tensor:
    """(K, ...) trits in {-1,0,1}, K % 4 == 0 -> (K//4, ...) uint8."""
    k = t.shape[0]
    if k % TRITS_PER_BYTE_2B:
        raise ValueError(f"leading dim {k} not a multiple of 4")
    u = (t + 1).to(torch.uint8).reshape(
        (k // TRITS_PER_BYTE_2B, TRITS_PER_BYTE_2B) + tuple(t.shape[1:]))
    out = torch.zeros(u.shape[:1] + u.shape[2:], dtype=torch.uint8,
                      device=t.device)
    for i in range(TRITS_PER_BYTE_2B):
        out |= u[:, i] << (2 * i)
    return out


def unpack_ternary_2bit(packed: torch.Tensor, k: int) -> torch.Tensor:
    """(K//4, ...) uint8 -> (K, ...) int8 trits."""
    digs = [((packed >> (2 * i)) & 0x3).to(torch.int8) - 1
            for i in range(TRITS_PER_BYTE_2B)]
    return torch.stack(digs, dim=1).reshape((k,) + tuple(packed.shape[1:]))
