"""Dual-plane matmul: two int4 weight matrices in ONE uint8 buffer (the 8T
dual-bit cell), two products from one read of each byte.

Replaces `repro/kernels/dual_plane_matmul.py:dual_plane_matmul_pallas`.
CUDA source: `csrc/dual_plane_matmul.cu`.

    y_hi = bf16(f32(x @ hi(buf)) * hi_scale),  hi = arithmetic buf >> 4
    y_lo = bf16(f32(x @ lo(buf)) * lo_scale),  lo = (int8)(buf << 4) >> 4

The sums are exact (float64 accumulation of bf16 x int4 products, which
have at most 12 significant bits), so the kernel and its plain version
agree bit for bit on the card, and a row's result does not depend on M:
decode (M = batch), verify (M = batch x window) and prefill (M = batch x
chunk) rows are the same bits. f32 sums in another order move ~0.3% of
the outputs by a bf16 ulp, which granite's int4 KV cache amplifies past
the logit tolerance (`csrc` header).

What bounds it on an H100: at decode and verify the buffer's K*N bytes;
at prefill the multiply-adds, here on the float64 CUDA cores. Each block
owns 64 columns and up to 16 rows (staged as float64 in shared memory)
and splits K across its warps; each byte is read from device memory
once per 16 rows.
"""
from __future__ import annotations

import torch

from repro_torch.core.quant import unpack_int4_hi, unpack_int4_lo
from repro_torch.kernels.build import check, library

COLS = 64            # output columns of one block (csrc constant)


def dual_plane_matmul_plain(x: torch.Tensor, buf: torch.Tensor,
                            hi_scale: torch.Tensor, lo_scale: torch.Tensor):
    """x (M, K) bf16, buf (K, N) uint8, scales (1, N) f32 -> (y_hi, y_lo)
    (M, N) bf16: what the oracle `repro.kernels.ref.dual_plane_matmul_ref`
    computes, with the sums taken exactly (float64) and rounded to f32
    before the scale."""
    xd = x.double()
    y_hi = (xd @ unpack_int4_hi(buf).double()).float() * hi_scale.float()
    y_lo = (xd @ unpack_int4_lo(buf).double()).float() * lo_scale.float()
    return y_hi.to(torch.bfloat16), y_lo.to(torch.bfloat16)


def dual_plane_matmul_cuda(x: torch.Tensor, buf: torch.Tensor,
                           hi_scale: torch.Tensor, lo_scale: torch.Tensor):
    """Launch the CUDA kernel; same contract as `dual_plane_matmul_plain`."""
    ts = (x, buf, hi_scale, lo_scale)
    if not all(t.is_cuda for t in ts):
        raise ValueError("dual_plane_matmul_cuda takes CUDA tensors")
    M, K = x.shape
    K2, N = buf.shape
    if x.dtype != torch.bfloat16 or buf.dtype != torch.uint8 \
            or hi_scale.dtype != torch.float32 \
            or lo_scale.dtype != torch.float32:
        raise TypeError(f"want bf16 x, uint8 buf, f32 scales; got {x.dtype}, "
                        f"{buf.dtype}, {hi_scale.dtype}, {lo_scale.dtype}")
    if K2 != K or K % 2 or N % COLS or hi_scale.numel() != N \
            or lo_scale.numel() != N:
        raise ValueError(f"unsupported shapes x {tuple(x.shape)}, buf "
                         f"{tuple(buf.shape)}, scales {tuple(hi_scale.shape)}"
                         f" {tuple(lo_scale.shape)}: need K == buf.shape[0], "
                         f"K even, N % {COLS} == 0")
    x, buf, hi_scale, lo_scale = (t.contiguous() for t in ts)
    if x.data_ptr() % 4:           # the kernel reads activations in pairs
        x = x.clone()
    y_hi = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    y_lo = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    if M == 0:
        return y_hi, y_lo
    err = library().dual_plane_matmul(
        x.data_ptr(), buf.data_ptr(), hi_scale.data_ptr(),
        lo_scale.data_ptr(), y_hi.data_ptr(), y_lo.data_ptr(), M, K, N,
        torch.cuda.current_stream(x.device).cuda_stream)
    check(err, "dual_plane_matmul")
    dual_plane_matmul_cuda.launches += 1
    return y_hi, y_lo


dual_plane_matmul_cuda.launches = 0
