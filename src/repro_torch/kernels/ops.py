"""Device dispatch for the port's kernels.

A tensor on the CPU takes the kernel's plain PyTorch version; a CUDA
tensor launches the hand-written kernel, whose wrapper raises on what it
cannot take. There is no fallback from one to the other. The explicit
``plain=True`` of the reference routes (the JAX package's ``use_ref``)
is a caller's choice, never a recovery from a failed launch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.paged_kv_attention import (
    paged_kv_attention_cuda, paged_kv_attention_plain)
from repro_torch.kernels.quantize_pack_kv import (quantize_pack_kv_cuda,
                                                  quantize_pack_kv_plain)
from repro_torch.kernels.ternary_matmul import (ternary_matmul_cuda,
                                                ternary_matmul_plain)

KERNELS = {"ternary_matmul": ternary_matmul_cuda,
           "paged_kv_attention": paged_kv_attention_cuda,
           "quantize_pack_kv": quantize_pack_kv_cuda}


def _cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def ternary_matmul(x, w_packed, scale, *, plain: bool = False):
    """y = x @ unpack(w_packed) * scale, weights 2 bits a value. ``plain``
    takes the plain version on any device (matmul_impl="dense")."""
    fn = ternary_matmul_plain if plain or _cpu(x) else ternary_matmul_cuda
    return fn(x, w_packed, scale)


def paged_kv_attention(q, kn, vn, kp, vp, k_scale, v_scale, lengths,
                       page_table, page_modes, *, kv_bits: int = 4):
    """Flash-decode of one query per row over the paged two-plane pool."""
    fn = paged_kv_attention_plain if _cpu(q) else paged_kv_attention_cuda
    return fn(q, kn, vn, kp, vp, k_scale, v_scale, lengths, page_table,
              page_modes, kv_bits=kv_bits)


def quantize_pack_kv(kv: torch.Tensor, *, plain: bool = False):
    """kv (..., D) bf16 -> (packed (..., D//2) uint8, scale (..., 1) bf16),
    the layout `models.layers.pack_kv_int4` produces. ``plain`` takes the
    plain version on any device (the dequant reference path)."""
    lead, D = kv.shape[:-1], kv.shape[-1]
    flat = kv.reshape(-1, D)
    fn = quantize_pack_kv_plain if plain or _cpu(kv) \
        else quantize_pack_kv_cuda
    p, s = fn(flat)
    return (p.reshape(*lead, D // 2),
            s.reshape(*lead, 1).to(torch.bfloat16))
