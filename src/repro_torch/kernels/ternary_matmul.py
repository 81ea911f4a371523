"""Fixed-order tensor-core GEMMs: packed-ternary weights (kernel 1) and
the port's own bf16 GEMM for the weights that stay dense.

`ternary_matmul` replaces `repro/kernels/ternary_matmul.py:
ternary_matmul_pallas`: y = bf16(x @ trits * scale[n]). `dense_matmul` has
no TPU kernel (the JAX package leaves those products to XLA): y = bf16(x @
w), for dual mode's unpaired projections and the tied LM head, which it
reads in the embedding's own (V_pad, d) layout, so no transposed copy of
the head exists. Both are one CUDA kernel template,
`csrc/ternary_matmul.cu`, with two C entry points, counted apart.

What bounds them on an H100: at decode (M = batch) the weight bytes, at
prefill the multiply-adds. What the design is for: a row's bits do not
depend on M. Every output is one chain of bf16 m16n8k16 tensor-core
steps over its K split in increasing k; `split_plan` takes the split
count from (K, N) alone, and the split CTAs of a tile, one thread-block
cluster, add their partials in split order through each other's shared
memory. So a verify window (M = 4 x spec_k rows) and a
decode step (M = 4) give each row the same bits, and speculative decode
emits the stepwise tokens. The split also spreads a layer's columns over
about 132 CTAs at every M.

The (K, N) weights (wq, wo, w_down) are read in place by a second loader
(ldmatrix.trans), not transposed at load: the plain version and the
parameter tree stay as they are.
"""
from __future__ import annotations

import torch

from repro_torch.core.ternary import unpack_ternary_2bit
from repro_torch.kernels.build import check, library

BK, BN = 64, 64      # K stage (the unit of the split) and column tile
SM_TARGET = 132      # CTAs a call aims at (an H100 SXM's SMs)
MAX_SPLITS = 8       # a tile's splits are one cluster (the portable limit)


def split_plan(K: int, N: int) -> int:
    """The K split of both kernels: enough splits that the N // 64 column
    tiles fill about SM_TARGET CTAs, at most one per 64-deep stage and
    MAX_SPLITS a tile. It reads (K, N) only, never M: that is what keeps
    a row's bits the same at every M (a constant, not the card's SM
    count, so the bits are the same on every card too)."""
    return max(1, min(K // BK, MAX_SPLITS,
                      -(-SM_TARGET // max(N // BN, 1))))


def _launch(name: str, x: torch.Tensor, w: torch.Tensor, N: int,
            pre: tuple = (), post: tuple = ()) -> torch.Tensor:
    """Check x, make the output and launch C entry point `name` (w
    already checked); `pre` are the entry's arguments between w and y,
    `post` those between S and the stream."""
    M, K = x.shape
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name}_cuda wants bf16 x, got {x.dtype}")
    if K % BK or N % BN:
        raise ValueError(f"{name}_cuda: K={K} and N={N} must be multiples "
                         f"of {BK} and {BN}")
    x = x.contiguous()
    if x.data_ptr() % 16:            # A is read as 16-byte vectors
        x = x.clone()
    y = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    if M == 0:
        return y
    err = getattr(library(), name)(
        x.data_ptr(), w.data_ptr(), *pre, y.data_ptr(), M, K, N,
        split_plan(K, N), *post,
        torch.cuda.current_stream(x.device).cuda_stream)
    check(err, name)
    return y


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


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
    Kp, N = w_packed.shape
    if w_packed.dtype != torch.uint8 or scale.dtype != torch.float32:
        raise TypeError(f"want uint8 w, f32 scale; got {w_packed.dtype}, "
                        f"{scale.dtype}")
    if Kp * 4 != x.shape[1] or scale.numel() != N:
        raise ValueError(f"unsupported shapes x {tuple(x.shape)}, w "
                         f"{tuple(w_packed.shape)}, scale "
                         f"{tuple(scale.shape)}: need K == 4 * w.shape[0]")
    scale = scale.contiguous()
    y = _launch("ternary_matmul", x, _aligned(w_packed), N,
                pre=(scale.data_ptr(),))
    if x.shape[0]:
        ternary_matmul_cuda.launches += 1
    return y


def dense_matmul_plain(x: torch.Tensor, w: torch.Tensor,
                       layout: str = "kn") -> torch.Tensor:
    """x @ w for w (K, N) ("kn"), x @ w.T for w (N, K) ("nk", the tied
    head's embedding): the products the port computed with torch.matmul
    before it owned this GEMM, bit for bit."""
    return x @ (w.T if layout == "nk" else w)


def dense_matmul_cuda(x: torch.Tensor, w: torch.Tensor,
                      layout: str = "kn") -> torch.Tensor:
    """Launch the CUDA kernel on x (M, K); same contract as
    `dense_matmul_plain`."""
    if not (x.is_cuda and w.is_cuda):
        raise ValueError("dense_matmul_cuda takes CUDA tensors")
    if layout not in ("kn", "nk"):
        raise ValueError(f"unknown layout {layout!r} (kn | nk)")
    if w.dtype != torch.bfloat16:
        raise TypeError(f"dense_matmul_cuda wants bf16 w, got {w.dtype}")
    K, N = w.shape if layout == "kn" else w.shape[::-1]
    if x.shape[1] != K:
        raise ValueError(f"x {tuple(x.shape)} against w {tuple(w.shape)} "
                         f"({layout})")
    y = _launch("dense_matmul", x, _aligned(w), N,
                post=(int(layout == "nk"),))
    if x.shape[0]:
        dense_matmul_cuda.launches += 1
    return y


ternary_matmul_cuda.launches = 0
dense_matmul_cuda.launches = 0
