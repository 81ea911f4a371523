"""Packed-ternary weight matmul: y = x @ trits * scale[n].

Replaces `repro/kernels/ternary_matmul.py:ternary_matmul_pallas`.
CUDA source: `csrc/ternary_matmul.cu`.

What bounds it on an H100: at decode (M = batch) the packed weight bytes
(K*N/4), at prefill (M = batch * chunk) the multiply-adds. The weight
stays 2 bits a value in device memory. For M <= 8 a GEMV kernel gives
each block 32 columns and splits K across its warps (enough blocks to
spread the weight read over the card); above that a tensor-core kernel
unpacks each K step's trits into shared memory as bf16 and multiplies
64 x 64 tiles exactly. The per-channel scale is applied in the epilogue.
"""
from __future__ import annotations

import torch

from repro_torch.core.ternary import unpack_ternary_2bit
from repro_torch.kernels.build import check, library

BK, BN = 128, 64     # K step and column tile of the kernels (csrc constants)


def ternary_matmul_plain(x: torch.Tensor, w_packed: torch.Tensor,
                         scale: torch.Tensor) -> torch.Tensor:
    """x (M, K) @ unpack(w_packed (K//4, N)) * scale (1, N) -> (M, N) bf16,
    float32 accumulation (the oracle `repro.kernels.ref.ternary_matmul_ref`
    computes)."""
    t = unpack_ternary_2bit(w_packed, x.shape[1])
    acc = x.float() @ t.float()
    return (acc * scale.float()).to(torch.bfloat16)


def ternary_matmul_cuda(x: torch.Tensor, w_packed: torch.Tensor,
                        scale: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel; same contract as `ternary_matmul_plain`."""
    if not (x.is_cuda and w_packed.is_cuda and scale.is_cuda):
        raise ValueError("ternary_matmul_cuda takes CUDA tensors")
    M, K = x.shape
    Kp, N = w_packed.shape
    if x.dtype != torch.bfloat16 or w_packed.dtype != torch.uint8 \
            or scale.dtype != torch.float32:
        raise TypeError(f"want bf16 x, uint8 w, f32 scale; got {x.dtype}, "
                        f"{w_packed.dtype}, {scale.dtype}")
    if Kp * 4 != K or K % BK or N % BN or scale.numel() != N:
        raise ValueError(f"unsupported shapes x {tuple(x.shape)}, w "
                         f"{tuple(w_packed.shape)}, scale "
                         f"{tuple(scale.shape)}: need K == 4 * w.shape[0], "
                         f"K % {BK} == 0, N % {BN} == 0")
    x, w_packed, scale = (x.contiguous(), w_packed.contiguous(),
                          scale.contiguous())
    if x.data_ptr() % 16:          # the kernels read activations as vectors
        x = x.clone()
    if w_packed.data_ptr() % 4:    # and packed weights as 32-bit words
        w_packed = w_packed.clone()
    y = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    if M == 0:
        return y
    err = library().ternary_matmul(
        x.data_ptr(), w_packed.data_ptr(), scale.data_ptr(), y.data_ptr(),
        M, K, N, torch.cuda.current_stream(x.device).cuda_stream)
    check(err, "ternary_matmul")
    ternary_matmul_cuda.launches += 1
    return y


ternary_matmul_cuda.launches = 0
