"""Dual-plane storage: the 8T dual-bit augmented cell.

One physical uint8 buffer stores two logical int4 tensors:
  * the STATIC plane (high nibble): written rarely, long-lived (the
    paper's SRAM bit), e.g. int4 weights;
  * the DYNAMIC plane (low nibble): streamed, short-lived, lossy (the
    DRAM bit on the dynamic node), e.g. streamed activations or KV.

The paper's hazard is kept: the SRAM access path runs through the dynamic
node, so a static-plane (re)write CLOBBERS the dynamic plane.
`write_static` zeroes the low nibble, and `core.amc.AugmentedStore`
enforces the FILO discipline around it.

The port of `repro.core.dual_plane`, on the port's `pack_int4_pair` /
`unpack_int4_hi` / `unpack_int4_lo`; the bytes and scales equal JAX's bit
for bit. The static plane is quantized along axis 0 by default, the
dynamic plane along the last axis, as in JAX.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import quant


class DualPlane(NamedTuple):
    """The physical buffer and each plane's scale."""
    buf: torch.Tensor            # uint8
    static_scale: torch.Tensor   # broadcastable to buf
    dynamic_scale: torch.Tensor  # broadcastable to buf

    @property
    def shape(self):
        return self.buf.shape


def alloc(shape, static_scale=None, dynamic_scale=None,
          device=None) -> DualPlane:
    """A zeroed buffer of `shape` on `device` (the CPU when None), unit
    scales unless given."""
    one = torch.ones((), dtype=torch.float32, device=device)
    return DualPlane(
        buf=torch.zeros(shape, dtype=torch.uint8, device=device),
        static_scale=one if static_scale is None else static_scale,
        dynamic_scale=one if dynamic_scale is None else dynamic_scale)


def write_static(dp: DualPlane, x: torch.Tensor, axis: int = 0) -> DualPlane:
    """Quantize `x` to int4 and write the static plane. DESTROYS the
    dynamic plane (the low nibble is zeroed), as the SRAM write drives
    the bit lines through the dynamic node."""
    q, scale = quant.quantize_int4(x, dim=axis)
    buf = quant.pack_int4_pair(q, torch.zeros_like(q))
    return DualPlane(buf, scale, dp.dynamic_scale)


def write_dynamic(dp: DualPlane, x: torch.Tensor, axis: int = -1,
                  stochastic: bool = False,
                  generator: Optional[torch.Generator] = None) -> DualPlane:
    """Quantize `x` to int4 and write the dynamic plane, keeping the
    static one."""
    q, scale = quant.quantize_int4(x, dim=axis, stochastic=stochastic,
                                   generator=generator)
    buf = (dp.buf & 0xF0) | (q.to(torch.uint8) & 0x0F)
    return DualPlane(buf, dp.static_scale, scale)


def read_static(dp: DualPlane, dtype=torch.bfloat16) -> torch.Tensor:
    return quant.dequantize(quant.unpack_int4_hi(dp.buf), dp.static_scale,
                            dtype)


def read_dynamic(dp: DualPlane, dtype=torch.bfloat16) -> torch.Tensor:
    return quant.dequantize(quant.unpack_int4_lo(dp.buf), dp.dynamic_scale,
                            dtype)


def read_static_q(dp: DualPlane) -> torch.Tensor:
    """The static plane's raw int4 levels (int8), for packed compute."""
    return quant.unpack_int4_hi(dp.buf)


def read_dynamic_q(dp: DualPlane) -> torch.Tensor:
    return quant.unpack_int4_lo(dp.buf)
