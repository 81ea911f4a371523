"""Fused int4 quantize-and-pack of KV rows (the Augmented plane's write
driver).

Replaces `repro/kernels/quantize_pack_kv.py:quantize_pack_kv_pallas`
(plain body `_qpack_kernel`). CUDA source: `csrc/quantize_pack_kv.cu`.

What bounds it on an H100: bytes — each bf16 row is read once and only
the packed nibbles and a scale are written. The kernel gives each row to
one warp (shuffle-reduced amax, coalesced reads) and is bit-exact with the
JAX package: both roundings to bf16 of its bf16 arithmetic are explicit.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import check, library
from repro_torch.models.layers import pack_kv_int4


def quantize_pack_kv_plain(kv: torch.Tensor):
    """kv (N, D) bf16 -> (packed (N, D//2) uint8, scale (N, 1) f32) — the
    oracle `repro.kernels.ref.quantize_pack_kv_ref` computes."""
    packed, scale = pack_kv_int4(kv)
    return packed, scale.float()


def quantize_pack_kv_cuda(kv: torch.Tensor):
    """Launch the CUDA kernel; same contract as `quantize_pack_kv_plain`."""
    if not kv.is_cuda:
        raise ValueError("quantize_pack_kv_cuda takes a CUDA tensor")
    if kv.dtype != torch.bfloat16 or kv.ndim != 2 or kv.shape[1] % 2:
        raise ValueError(f"want (N, D) bf16 with D even, got "
                         f"{tuple(kv.shape)} {kv.dtype}")
    N, D = kv.shape
    kv = kv.contiguous()
    packed = torch.empty((N, D // 2), dtype=torch.uint8, device=kv.device)
    scale = torch.empty((N, 1), dtype=torch.float32, device=kv.device)
    if N == 0:
        return packed, scale
    err = library().quantize_pack_kv(
        kv.data_ptr(), packed.data_ptr(), scale.data_ptr(), N, D,
        torch.cuda.current_stream(kv.device).cuda_stream)
    check(err, "quantize_pack_kv")
    quantize_pack_kv_cuda.launches += 1
    return packed, scale


quantize_pack_kv_cuda.launches = 0
