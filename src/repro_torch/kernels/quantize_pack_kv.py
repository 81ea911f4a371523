"""Fused int4 quantize-and-pack of KV rows (the Augmented plane's write
driver): unmasked, masked, and with fused integrity words.

Replaces `repro/kernels/quantize_pack_kv.py:quantize_pack_kv_pallas`:
the plain body `_qpack_kernel`, the masked body `_qpack_masked_kernel`
(the speculative store-back: rows with valid == 0 are written as zero
bytes and a scale of exactly 1.0) and the integrity body
`_qpack_integrity_kernel` (`with_integrity=True`: the pack plus each
row's word sum_j (j + 1) * byte_j mod 2**32). CUDA source:
`csrc/quantize_pack_kv.cu`, one kernel with three C entry points, counted
apart as `quantize_pack_kv`, `quantize_pack_kv_masked` and
`quantize_pack_kv_integrity`. Like the JAX package, no serving path calls
the integrity entry yet (the fault-aware stores, once ported, may stamp
their words with it).

What bounds it on an H100: bytes — each bf16 row is read once and only
the packed nibbles and a scale are written. The kernel gives each row to
one warp (shuffle-reduced amax, coalesced reads) and is bit-exact with the
JAX package: both roundings to bf16 of its bf16 arithmetic are explicit.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.build import check, library
from repro_torch.models.layers import pack_kv_int4


def quantize_pack_kv_plain(kv: torch.Tensor,
                           valid: Optional[torch.Tensor] = None):
    """kv (N, D) bf16 -> (packed (N, D//2) uint8, scale (N, 1) f32) — the
    oracle `repro.kernels.ref.quantize_pack_kv_ref` computes; with
    `valid` (N,) rows where valid == 0 give zero bytes and scale 1.0."""
    packed, scale = pack_kv_int4(kv)
    scale = scale.float()
    if valid is not None:
        keep = (valid != 0).reshape(-1, 1)
        packed = torch.where(keep, packed, torch.zeros_like(packed))
        scale = torch.where(keep, scale, torch.ones_like(scale))
    return packed, scale


def integrity_words_plain(packed: torch.Tensor) -> torch.Tensor:
    """Per-row integrity word of packed rows (N, Dp) uint8: sum_j (j + 1)
    * byte_j mod 2**32, as (N, 1) int64 (the oracle
    `repro.kernels.ref.integrity_words_ref`, and
    `repro.core.faults.integrity_word` of each row)."""
    lanes = torch.arange(1, packed.shape[-1] + 1, dtype=torch.int64,
                         device=packed.device)
    word = (packed.to(torch.int64) * lanes).sum(dim=-1, keepdim=True)
    return word & 0xFFFFFFFF


def quantize_pack_kv_integrity_plain(kv: torch.Tensor):
    """kv (N, D) bf16 -> (packed, scale, words): the plain pack and the
    integrity word of each packed row."""
    packed, scale = quantize_pack_kv_plain(kv)
    return packed, scale, integrity_words_plain(packed)


def _launch(kv: torch.Tensor, valid: Optional[torch.Tensor],
            words: Optional[torch.Tensor] = None):
    if not kv.is_cuda or (valid is not None and not valid.is_cuda):
        raise ValueError("quantize_pack_kv_cuda takes CUDA tensors")
    if kv.dtype != torch.bfloat16 or kv.ndim != 2 or kv.shape[1] % 2:
        raise ValueError(f"want (N, D) bf16 with D even, got "
                         f"{tuple(kv.shape)} {kv.dtype}")
    N, D = kv.shape
    if valid is not None and valid.numel() != N:
        raise ValueError(f"valid has {valid.numel()} rows, kv {N}")
    kv = kv.contiguous()
    packed = torch.empty((N, D // 2), dtype=torch.uint8, device=kv.device)
    scale = torch.empty((N, 1), dtype=torch.float32, device=kv.device)
    if N == 0:
        return packed, scale, False
    stream = torch.cuda.current_stream(kv.device).cuda_stream
    if words is not None:
        err = library().quantize_pack_kv_integrity(
            kv.data_ptr(), packed.data_ptr(), scale.data_ptr(),
            words.data_ptr(), N, D, stream)
        check(err, "quantize_pack_kv_integrity")
    elif valid is None:
        err = library().quantize_pack_kv(
            kv.data_ptr(), packed.data_ptr(), scale.data_ptr(), N, D, stream)
        check(err, "quantize_pack_kv")
    else:
        valid = valid.reshape(-1).to(torch.int32).contiguous()
        err = library().quantize_pack_kv_masked(
            kv.data_ptr(), valid.data_ptr(), packed.data_ptr(),
            scale.data_ptr(), N, D, stream)
        check(err, "quantize_pack_kv_masked")
    return packed, scale, True


def quantize_pack_kv_cuda(kv: torch.Tensor):
    """Launch the CUDA kernel; same contract as `quantize_pack_kv_plain`
    without a mask."""
    packed, scale, launched = _launch(kv, None)
    quantize_pack_kv_cuda.launches += launched
    return packed, scale


def quantize_pack_kv_masked_cuda(kv: torch.Tensor, valid: torch.Tensor):
    """Launch the masked entry point; same contract as
    `quantize_pack_kv_plain(kv, valid)`."""
    packed, scale, launched = _launch(kv, valid)
    quantize_pack_kv_masked_cuda.launches += launched
    return packed, scale


def quantize_pack_kv_integrity_cuda(kv: torch.Tensor):
    """Launch the integrity entry point; same contract as
    `quantize_pack_kv_integrity_plain`."""
    if not kv.is_cuda:
        raise ValueError("quantize_pack_kv_integrity_cuda takes CUDA tensors")
    words = torch.empty((kv.shape[0], 1), dtype=torch.int64,
                        device=kv.device)
    packed, scale, launched = _launch(kv, None, words)
    quantize_pack_kv_integrity_cuda.launches += launched
    return packed, scale, words


quantize_pack_kv_cuda.launches = 0
quantize_pack_kv_masked_cuda.launches = 0
quantize_pack_kv_integrity_cuda.launches = 0
