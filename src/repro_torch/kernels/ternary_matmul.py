"""Fixed-order tensor-core GEMMs: packed-ternary weights (kernel 1), the
port's own bf16 GEMM for the weights that stay dense, and both over a
bank of experts in one launch.

`ternary_matmul` replaces `repro/kernels/ternary_matmul.py:
ternary_matmul_pallas`: y = bf16(x @ trits * scale[n]). `dense_matmul` has
no TPU kernel (the JAX package leaves those products to XLA): y = bf16(x @
w), for dual mode's unpaired projections and the tied LM head, which it
reads in the embedding's own (V_pad, d) layout, so no transposed copy of
the head exists. `expert_matmul` has no TPU kernel either: y[e] = x[e] @
w[e] over a MoE layer's E experts, w a bf16 bank (E, K, N) or a 2-bit one
(E, K/4, N) with scales (E, N) (the JAX package's einsum, and its
`lax.map` of kernel 1 over a ternary bank). All three are one CUDA kernel
template, `csrc/ternary_matmul.cu`, with three C entry points, counted
apart; `dense_matmul` and `expert_matmul` can return the float32
accumulators (the MoE router's logits) instead of bf16.

What bounds them on an H100: at decode (M = batch) the weight bytes, at
prefill the multiply-adds. What the design is for: a row's bits do not
depend on M. Every output is one chain of bf16 m16n8k16 tensor-core
steps over its K split in increasing k; `split_plan` takes the split
count from (K, N) alone, and the split CTAs of a tile, one thread-block
cluster, add their partials in split order through each other's shared
memory. So a verify window (M = 4 x spec_k rows) and a
decode step (M = 4) give each row the same bits, and speculative decode
emits the stepwise tokens. An expert's rows get the bits of a
one-expert `dense_matmul` / `ternary_matmul` call on that expert alone.
The split also spreads a layer's columns over about 132 CTAs at every
M.

The (K, N) weights (wq, wo, w_down) are read in place by a second loader
(ldmatrix.trans), not transposed at load: the plain version and the
parameter tree stay as they are.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.distributed.sharding import is_dtensor, sharded_matmul

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
            pre: tuple = (), post: tuple = (),
            out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Check x ((M, K), or (E, M, K) for the expert entry), make the
    output and launch C entry point `name` (w already checked); `pre` are
    the entry's arguments between w and y, `post` those between S and
    the stream."""
    *lead, M, K = x.shape
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name}_cuda wants bf16 x, got {x.dtype}")
    if K % BK or N % BN:
        raise ValueError(f"{name}_cuda: K={K} and N={N} must be multiples "
                         f"of {BK} and {BN}")
    x = x.contiguous()
    if x.data_ptr() % 16:            # A is read as 16-byte vectors
        x = x.clone()
    y = torch.empty((*lead, M, N), dtype=out_dtype, device=x.device)
    if y.numel() == 0:
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


def _out_f32(out_dtype: torch.dtype) -> int:
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"out_dtype must be bf16 or f32, got {out_dtype}")
    return int(out_dtype == torch.float32)


def dense_matmul_plain(x: torch.Tensor, w: torch.Tensor,
                       layout: str = "kn",
                       out_dtype: torch.dtype = torch.bfloat16
                       ) -> torch.Tensor:
    """x @ w for w (K, N) ("kn"), x @ w.T for w (N, K) ("nk", the tied
    head's embedding): the products the port computed with torch.matmul
    before it owned this GEMM, bit for bit. With a float32 `out_dtype`,
    x.float() @ w.float() (the MoE router's logits, as JAX routes). A
    bf16 x against float32 weights (a float32 master tree) multiplies in
    float32, as JAX promotes them."""
    w = w.T if layout == "nk" else w
    if _out_f32(out_dtype):
        return x.float() @ w.float()
    if is_dtensor(w):
        return sharded_matmul(x, w)
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    return x @ w


def dense_matmul_cuda(x: torch.Tensor, w: torch.Tensor,
                      layout: str = "kn",
                      out_dtype: torch.dtype = torch.bfloat16
                      ) -> torch.Tensor:
    """Launch the CUDA kernel on x (M, K); same contract as
    `dense_matmul_plain` (float32 out: the f32 accumulators, stored
    unrounded)."""
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
    f32 = _out_f32(out_dtype)
    y = _launch("dense_matmul", x, _aligned(w), N, pre=(f32,),
                post=(int(layout == "nk"),), out_dtype=out_dtype)
    if x.shape[0]:
        dense_matmul_cuda.launches += 1
    return y


def expert_matmul_plain(x: torch.Tensor, w: torch.Tensor,
                        scale: Optional[torch.Tensor] = None,
                        out_dtype: torch.dtype = torch.bfloat16
                        ) -> torch.Tensor:
    """x (E, M, K) @ w[e] for each expert e, one expert at a time in
    float32: w (E, K, N) bf16, or (E, K/4, N) uint8 packed trits with
    `scale` (E, N) / (E, 1, N) f32 (the dequantized trits times the
    scale, as `ternary_matmul_plain`). Returns (E, M, N) in `out_dtype`."""
    E, M, K = x.shape
    N = w.shape[-1]
    _out_f32(out_dtype)
    y = torch.empty((E, M, N), dtype=out_dtype, device=x.device)
    for e in range(E):
        if scale is None:
            acc = x[e].float() @ w[e].float()
        else:
            t = unpack_ternary_2bit(w[e], K)
            acc = (x[e].float() @ t.float()) * scale[e].reshape(1, N).float()
        y[e] = acc.to(out_dtype)
    return y


def expert_matmul_cuda(x: torch.Tensor, w: torch.Tensor,
                       scale: Optional[torch.Tensor] = None,
                       out_dtype: torch.dtype = torch.bfloat16
                       ) -> torch.Tensor:
    """Launch the CUDA kernel on x (E, M, K): one launch for every
    expert; same contract as `expert_matmul_plain`."""
    if not (x.is_cuda and w.is_cuda
            and (scale is None or scale.is_cuda)):
        raise ValueError("expert_matmul_cuda takes CUDA tensors")
    if x.dim() != 3 or w.dim() != 3 or w.shape[0] != x.shape[0]:
        raise ValueError(f"x {tuple(x.shape)} against w {tuple(w.shape)}: "
                         f"need (E, M, K) and (E, K | K/4, N)")
    E, M, K = x.shape
    N = w.shape[2]
    ternary = scale is not None
    if ternary:
        if w.dtype != torch.uint8 or scale.dtype != torch.float32:
            raise TypeError(f"want uint8 w, f32 scale; got {w.dtype}, "
                            f"{scale.dtype}")
        if w.shape[1] * 4 != K or scale.numel() != E * N:
            raise ValueError(f"unsupported shapes x {tuple(x.shape)}, w "
                             f"{tuple(w.shape)}, scale "
                             f"{tuple(scale.shape)}")
        scale = scale.contiguous()
    elif w.dtype != torch.bfloat16 or w.shape[1] != K:
        raise ValueError(f"want a bf16 (E, {K}, N) bank, got {w.dtype} "
                         f"{tuple(w.shape)}")
    mt = -(-M // (16 if M <= 16 else 64))
    if E * mt > 65535:
        raise ValueError(f"expert_matmul_cuda: {E} experts x {mt} row "
                         f"tiles exceed the grid's 65535")
    y = _launch("expert_matmul", x, _aligned(w), N,
                pre=(scale.data_ptr() if ternary else 0,),
                post=(E, int(ternary), _out_f32(out_dtype)),
                out_dtype=out_dtype)
    if y.numel():
        expert_matmul_cuda.launches += 1
    return y


ternary_matmul_cuda.launches = 0
dense_matmul_cuda.launches = 0
expert_matmul_cuda.launches = 0
