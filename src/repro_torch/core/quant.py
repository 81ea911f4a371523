"""Symmetric integer quantization and int4 nibble packing.

Bit-exact with `repro.core.quant` on bf16 and float32 inputs: JAX
evaluates the bf16 arithmetic of `quantize_int4` / `quantize_int8` as
float32 ops rounded to bf16 after each step, and `quantize_rows` spells
those roundings out (they are no-ops on float32).
"""
from __future__ import annotations

import torch

INT4_MAX = 7        # symmetric int4: [-7, 7] (-8 reserved, keeps negation closed)
INT8_MAX = 127
EPS = 1e-8


def quantize_rows(x: torch.Tensor, qmax: int, dim: int = -1):
    """Symmetric quantization of a bf16 or float32 tensor along `dim`
    (the KV packs: bf16, last axis; the dual weight pack: float32, the
    contraction axis).

    Returns (q int8 in [-qmax, qmax], scale of x's dtype, size 1 along
    `dim`) with scale = max(amax, eps) / qmax and
    q = clip(round_half_even(x / scale), +-qmax), each op rounded to x's
    dtype as JAX computes it."""
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"quantize_rows takes bf16 or float32, got {x.dtype}")
    dt = x.dtype
    amax = x.abs().amax(dim=dim, keepdim=True).float()
    eps = torch.tensor(EPS, dtype=dt).float()
    scale = (torch.maximum(amax, eps) / qmax).to(dt)
    y = (x.float() / scale.float()).to(dt)
    q = torch.round(y.float()).clamp(-qmax, qmax).to(torch.int8)
    return q, scale


def quantize_int4(x: torch.Tensor, dim: int = -1):
    return quantize_rows(x, INT4_MAX, dim)


def quantize_int8(x: torch.Tensor, dim: int = -1):
    return quantize_rows(x, INT8_MAX, dim)


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               dtype=torch.bfloat16) -> torch.Tensor:
    return (q.float() * scale.float()).to(dtype)


def pack_int4_pair(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Two int4 tensors (int8 storage) -> one uint8, `hi` in the high
    nibble, `lo` in the low nibble."""
    hi_u = hi.to(torch.uint8) & 0x0F
    lo_u = lo.to(torch.uint8) & 0x0F
    return (hi_u << 4) | lo_u


def unpack_int4_hi(packed: torch.Tensor) -> torch.Tensor:
    """High nibble as sign-extended int8 (arithmetic shift of the byte)."""
    return packed.view(torch.int8) >> 4


def unpack_int4_lo(packed: torch.Tensor) -> torch.Tensor:
    """Low nibble as sign-extended int8."""
    return (packed.view(torch.uint8) << 4).view(torch.int8) >> 4
