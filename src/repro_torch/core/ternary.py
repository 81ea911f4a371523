"""Ternary weights: TWN ternarization, the straight-through estimator of
error-aware training, and the two packings of the 7T cell's trits.

2-bit packing (4 trits a byte): digit i of a byte sits at bits 2i..2i+1
and trit = digit - 1, packed along the FIRST (contraction) axis, the
layout of `repro.core.ternary` and of the `ternary_matmul` kernel.
Base-3 packing (5 trits a byte, 1.6 bits a trit, since 3^5 = 243 <= 255):
byte = sum_i (trit_i + 1) * 3^i over 5 consecutive rows, the densest
form (the store's default `ternary_fmt="base3"` in the JAX package).
"""
from __future__ import annotations

import torch

TRITS_PER_BYTE_2B = 4
TRITS_PER_BYTE_B3 = 5
_POW3 = (1, 3, 9, 27, 81)


def ternarize(w: torch.Tensor, dim: int = 0):
    """TWN: t = sign(w) * 1{|w| > 0.7 E|w|}, scale = mean |w| over kept
    entries, both reduced over `dim`. Returns (t int8, scale f32). A bf16
    w is ternarized in bf16 as the JAX package computes it op by op (each
    sum rounded to float32, then to bf16; the count divided as a bf16
    value); any other dtype in float32. The bf16 sums run in float64, so
    they are exact and the same on every device; JAX's float32 sums agree
    wherever they are exact too (a short reduction of bf16 values)."""
    if w.dtype == torch.bfloat16:
        return _ternarize_bf16(w, dim)
    w = w.float()
    aw = w.abs()
    delta = 0.7 * aw.mean(dim=dim, keepdim=True)
    mask = aw > delta
    t = torch.sign(w) * mask
    denom = mask.sum(dim=dim, keepdim=True).clamp_min(1)
    scale = (aw * mask).sum(dim=dim, keepdim=True) / denom
    return t.to(torch.int8), scale.float()


def _ternarize_bf16(w: torch.Tensor, dim: int):
    bf = torch.bfloat16
    aw = w.abs()
    mean = (aw.double().sum(dim=dim, keepdim=True).float()
            / w.shape[dim]).to(bf)
    seven = torch.tensor(0.7, dtype=bf).item()    # the weak-typed 0.7
    delta = (mean.float() * seven).to(bf)
    mask = aw > delta
    t = torch.sign(w) * mask
    denom = mask.sum(dim=dim, keepdim=True).clamp_min(1).to(bf)
    kept = (aw * mask).double().sum(dim=dim, keepdim=True).float().to(bf)
    scale = (kept.float() / denom.float()).to(bf)
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


class _TernarizeSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w):
        t, scale = ternarize(w)
        return ternary_dequant(t, scale, dtype=w.dtype)

    @staticmethod
    def backward(ctx, g):
        return g


def ternarize_ste(w: torch.Tensor) -> torch.Tensor:
    """Forward: the dequantized ternary weights (TWN over dim 0). Backward:
    the identity (straight-through estimator)."""
    return _TernarizeSTE.apply(w)


def pack_ternary_base3(t: torch.Tensor) -> torch.Tensor:
    """(K, ...) trits in {-1,0,1}, K % 5 == 0 -> (K//5, ...) uint8, 5 a
    byte along the first axis."""
    k = t.shape[0]
    if k % TRITS_PER_BYTE_B3:
        raise ValueError(f"leading dim {k} not a multiple of 5")
    u = (t + 1).to(torch.uint8).reshape(
        (k // TRITS_PER_BYTE_B3, TRITS_PER_BYTE_B3) + tuple(t.shape[1:]))
    out = torch.zeros(u.shape[:1] + u.shape[2:], dtype=torch.uint8,
                      device=t.device)
    for i, p in enumerate(_POW3):
        out = out + u[:, i] * p
    return out


def unpack_ternary_base3(packed: torch.Tensor, k: int) -> torch.Tensor:
    """Inverse of `pack_ternary_base3`: (K//5, ...) uint8 -> (K, ...) int8."""
    rem = packed.to(torch.int32)
    digs = []
    for _ in range(TRITS_PER_BYTE_B3):
        digs.append((rem % 3).to(torch.int8) - 1)
        rem = rem // 3
    return torch.stack(digs, dim=1).reshape((k,) + tuple(packed.shape[1:]))


def bits_per_value(fmt: str) -> float:
    return {"base3": 1.6, "2bit": 2.0, "bf16": 16.0, "int8": 8.0,
            "int4": 4.0}[fmt]
