"""Ternary (error-aware-trained) layers: the 7T cell's end application.

The paper motivates the 7T ternary cell with TNN accelerators and notes
(SS.IV) that error-aware training of the network lets the application
tolerate the augmented storage. `ternary_dense` is that co-design: the
forward pass uses the ternarized weights (what the augmented memory
holds at serving time), the backward pass flows straight through to the
float master, so the network learns to be accurate under the augmented
representation. The port of `repro.core.ternary_layers`.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import ternary
from repro_torch.device import resolve_device


class TernaryDenseParams(NamedTuple):
    w: torch.Tensor                 # float master weights (in_dim, out_dim)
    b: Optional[torch.Tensor]


def init_ternary_dense(in_dim: int, out_dim: int, bias: bool = True,
                       dtype=torch.float32, *, seed: int = 0,
                       device=None) -> TernaryDenseParams:
    """N(0, 1) / sqrt(in_dim) weights from a generator seeded with `seed`,
    zero bias, on the card unless `device` names another."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randn((in_dim, out_dim), generator=gen, device=dev,
                    dtype=torch.float32).to(dtype) / in_dim ** 0.5
    b = torch.zeros((out_dim,), dtype=dtype, device=dev) if bias else None
    return TernaryDenseParams(w, b)


def ternary_dense(params: TernaryDenseParams, x: torch.Tensor,
                  train: bool = True) -> torch.Tensor:
    """y = x @ ternarize(w) + b, with straight-through gradients to the
    master in training."""
    if train:
        wq = ternary.ternarize_ste(params.w)
    else:
        t, scale = ternary.ternarize(params.w)
        wq = ternary.ternary_dequant(t, scale, dtype=params.w.dtype)
    y = x @ wq.to(x.dtype)
    if params.b is not None:
        y = y + params.b.to(x.dtype)
    return y


class FrozenTernaryDense(NamedTuple):
    """Serving-time form: weights live packed in augmented memory."""
    packed: torch.Tensor   # uint8 (in_dim//5, out_dim) base-3 (or //4 2-bit)
    scale: torch.Tensor    # (1, out_dim)
    b: Optional[torch.Tensor]
    in_dim: int


def freeze_ternary_dense(params: TernaryDenseParams,
                         fmt: str = "base3") -> FrozenTernaryDense:
    t, scale = ternary.ternarize(params.w)
    pack = (ternary.pack_ternary_base3 if fmt == "base3"
            else ternary.pack_ternary_2bit)
    return FrozenTernaryDense(pack(t), scale, params.b, params.w.shape[0])


def frozen_ternary_dense_ref(fr: FrozenTernaryDense, x: torch.Tensor,
                             fmt: str = "base3") -> torch.Tensor:
    """The plain serving path: unpack, dequantize, x @ w (+ b)."""
    unpack = (ternary.unpack_ternary_base3 if fmt == "base3"
              else ternary.unpack_ternary_2bit)
    t = unpack(fr.packed, fr.in_dim)
    w = ternary.ternary_dequant(t, fr.scale, dtype=x.dtype)
    y = x @ w
    if fr.b is not None:
        y = y + fr.b.to(x.dtype)
    return y
