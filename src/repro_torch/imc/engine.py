"""Bit-serial IMC engine: an array object that owns packed augmented
weights and evaluates dot products in place, logging array events per
call.

`BitSerialArray` is the eager, host-driven view of one IMC sub-array. It
pairs the `imc_dot` kernels (`kernels.ops.imc_dot` / `imc_dual_dot`: the
CUDA kernels on CUDA tensors, their plain versions on CPU tensors) with
an `energy.ImcEventLedger`, so every `dot()` logs its wordline / bitline
/ ADC events. Inside the model's steps the ops are called directly and
`ServeEngine` accounts analytically (`energy.decode_matmul_events`).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import quant, ternary
from repro_torch.imc import energy
from repro_torch.kernels import ops as kops
from repro_torch.kernels.imc_dot import IMC_FORMATS, k_pack


class BitSerialArray:
    """One IMC sub-array: packed weights resident, activations streamed
    bit-serially at `abits` precision (reconfigurable per call)."""

    def __init__(self, wp: torch.Tensor, scale: torch.Tensor, *, fmt: str,
                 lo_scale: Optional[torch.Tensor] = None, abits: int = 8,
                 ledger: Optional[energy.ImcEventLedger] = None):
        if fmt not in IMC_FORMATS:
            raise ValueError(f"unknown IMC weight format {fmt!r}")
        self.fmt, self.abits = fmt, abits
        self.wp, self.scale, self.lo_scale = wp, scale, lo_scale
        self.ledger = ledger if ledger is not None else energy.ImcEventLedger()
        self.K = wp.shape[0] * k_pack(fmt)
        self.N = wp.shape[1]

    # -- constructors (the write drivers) -----------------------------------

    @classmethod
    def from_dense(cls, w: torch.Tensor, *, fmt: str = "ternary",
                   abits: int = 8, ledger=None) -> "BitSerialArray":
        """Pack a dense (K, N) weight into the array's resident format."""
        w = w.float()
        if fmt == "ternary":
            t, scale = ternary.ternarize(w, dim=0)
            return cls(ternary.pack_ternary_2bit(t), scale, fmt=fmt,
                       abits=abits, ledger=ledger)
        if fmt == "int8":
            q, scale = quant.quantize_int8(w, dim=0)
            return cls(q, scale, fmt=fmt, abits=abits, ledger=ledger)
        if fmt == "int4":
            q, scale = quant.quantize_int4(w, dim=0)
            return cls(quant.pack_int4_pair(q[0::2], q[1::2]), scale,
                       fmt=fmt, abits=abits, ledger=ledger)
        raise ValueError("use from_dense_pair for the dual format")

    @classmethod
    def from_dense_pair(cls, w_hi: torch.Tensor, w_lo: torch.Tensor, *,
                        abits: int = 8, ledger=None) -> "BitSerialArray":
        """Two dense (K, N) weights into ONE dual-plane uint8 array."""
        qh, sh = quant.quantize_int4(w_hi.float(), dim=0)
        ql, sl = quant.quantize_int4(w_lo.float(), dim=0)
        return cls(quant.pack_int4_pair(qh, ql), sh, fmt="dual",
                   lo_scale=sl, abits=abits, ledger=ledger)

    # -- compute ------------------------------------------------------------

    def dot(self, x: torch.Tensor, *, abits: Optional[int] = None):
        """x (M, K) bf16 -> (M, N) bf16 (dual: ((M, N), (M, N))). Logs the
        call's wordline/bitline/ADC events to the ledger."""
        a = self.abits if abits is None else abits
        M = x.shape[0]
        self.ledger.add(
            energy.imc_dot_events(M, self.K, self.N, abits=a,
                                  planes=2 if self.fmt == "dual" else 1),
            group="imc_dot")
        if self.fmt == "dual":
            return kops.imc_dual_dot(x, self.wp, self.scale, self.lo_scale,
                                     abits=a)
        return kops.imc_dot(x, self.wp, self.scale, fmt=self.fmt, abits=a)

    def physical_bytes(self) -> int:
        scales = [s for s in (self.scale, self.lo_scale) if s is not None]
        return int(self.wp.nbytes) + sum(int(s.nbytes) for s in scales)
