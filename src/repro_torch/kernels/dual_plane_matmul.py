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

What bounds it on an H100: at decode (M <= 4) the buffer's K*N bytes;
above it the float64 multiply-adds. Decode keeps a GEMV on the CUDA
cores (each block owns 64 columns and the M rows, staged as float64 in
shared memory, and splits K across its warps). Verify (4 < M <= 16) and
prefill (M > 16) run float64 tensor-core tiles (DMMA) of 16 x 64 and
128 x 64 outputs over K slices staged with cp.async: each byte
is read once per tile and feeds both planes' products. Where the tiles
do not fill the card, K is split across CTAs too (`k_split`); exact
partial sums make that cost no bits.
"""
from __future__ import annotations

import torch

from repro_torch.core.quant import unpack_int4_hi, unpack_int4_lo
from repro_torch.kernels.build import check, library

COLS = 64            # output columns of one block (csrc constant)
SLICE = {16: 128, 128: 64}   # K depth of a staged slice, by tile rows
SMS = 132            # streaming multiprocessors of an H100 SXM
GEMV_ROWS = 4        # rows the GEMV route takes; the tiles above


def k_split(M: int, K: int, N: int) -> tuple[int, int]:
    """How many CTAs split K on the tile routes (M > 4; enough to fill the
    card's SMs where the output tiles alone do not), and the bytes of
    float64 scratch their partial sums need. The GEMV route takes (1, 0)."""
    if M <= GEMV_ROWS:
        return 1, 0
    bm = 16 if M <= 16 else 128
    tiles = (N // COLS) * -(-M // bm)
    slices = -(-K // SLICE[bm])
    per = -(-slices // max(1, min(slices, SMS // tiles)))
    ksplit = -(-slices // per)
    return ksplit, 8 * ksplit * 2 * M * N if ksplit > 1 else 0


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
    """Launch the CUDA kernel; same contract as `dual_plane_matmul_plain`,
    bit for bit on every route. One call is one launch in the count, with
    the K-split's finishing kernel where `k_split` splits K."""
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
    if buf.data_ptr() % 16:        # the tiles copy 16-byte pieces of it
        buf = buf.clone()
    y_hi = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    y_lo = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    if M == 0:
        return y_hi, y_lo
    ksplit, n_scratch = k_split(M, K, N)
    part = (torch.empty(n_scratch, dtype=torch.uint8, device=x.device)
            if n_scratch else None)
    err = library().dual_plane_matmul(
        x.data_ptr(), buf.data_ptr(), hi_scale.data_ptr(),
        lo_scale.data_ptr(), y_hi.data_ptr(), y_lo.data_ptr(),
        None if part is None else part.data_ptr(), M, K, N, ksplit,
        torch.cuda.current_stream(x.device).cuda_stream)
    check(err, "dual_plane_matmul")
    dual_plane_matmul_cuda.launches += 1
    return y_hi, y_lo


dual_plane_matmul_cuda.launches = 0
