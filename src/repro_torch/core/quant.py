"""Symmetric integer quantization and int4 nibble packing.

Bit-exact with `repro.core.quant` on bf16 and float32 inputs: JAX
evaluates the bf16 arithmetic of `quantize_int4` / `quantize_int8` as
float32 ops rounded to bf16 after each step, and `quantize_rows` spells
those roundings out (they are no-ops on float32).

Stochastic rounding (the paper's word-line boosting: a weak write lands
on the right level in expectation) draws its noise from a
`torch.Generator` where JAX takes a PRNG key, so its draws are not JAX's;
it keeps JAX's arithmetic, floor(y + 0.5 + (u - 0.5)) in x's dtype.
"""
from __future__ import annotations

from typing import Optional

import torch

INT4_MAX = 7        # symmetric int4: [-7, 7] (-8 reserved, keeps negation closed)
INT8_MAX = 127
EPS = 1e-8


def quantize_rows(x: torch.Tensor, qmax: int, dim: int = -1,
                  stochastic: bool = False,
                  generator: Optional[torch.Generator] = None):
    """Symmetric quantization of a bf16 or float32 tensor along `dim`
    (the KV packs: bf16, last axis; the dual weight pack: float32, the
    contraction axis).

    Returns (q int8 in [-qmax, qmax], scale of x's dtype, size 1 along
    `dim`) with scale = max(amax, eps) / qmax and
    q = clip(round_half_even(x / scale), +-qmax), each op rounded to x's
    dtype as JAX computes it. With `stochastic`, q = clip(floor(y + 0.5 +
    (u - 0.5))) for u uniform in [0, 1) of x's dtype drawn from
    `generator` (on x's device)."""
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"quantize_rows takes bf16 or float32, got {x.dtype}")
    dt = x.dtype
    amax = x.abs().amax(dim=dim, keepdim=True).float()
    eps = torch.tensor(EPS, dtype=dt).float()
    # a divisor on x's device (filled there, so a CUDA graph can capture
    # it): CUDA divides by a host scalar as a multiply by its reciprocal,
    # an ulp off IEEE division now and then
    scale = (torch.maximum(amax, eps)
             / torch.full_like(amax, float(qmax))).to(dt)
    y = (x.float() / scale.float()).to(dt)
    if stochastic:
        if generator is None:
            raise ValueError("stochastic rounding requires a torch.Generator")
        u = torch.rand(y.shape, generator=generator, device=y.device,
                       dtype=dt)
        noise = (u.float() - 0.5).to(dt)
        t = ((y.float() + 0.5).to(dt).float() + noise.float()).to(dt)
        q = torch.floor(t.float())
    else:
        q = torch.round(y.float())
    return q.clamp(-qmax, qmax).to(torch.int8), scale


def quantize_int4(x: torch.Tensor, dim: int = -1, stochastic: bool = False,
                  generator: Optional[torch.Generator] = None):
    return quantize_rows(x, INT4_MAX, dim, stochastic, generator)


def quantize_int8(x: torch.Tensor, dim: int = -1, stochastic: bool = False,
                  generator: Optional[torch.Generator] = None):
    return quantize_rows(x, INT8_MAX, dim, stochastic, generator)


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
