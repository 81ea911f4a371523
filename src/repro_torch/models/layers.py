"""Shared layers: norms, RoPE, embedding, the head's logits, KV packing
and cache writes, and the plain attention used by prefill and by the
dequant reference paths.

Each function keeps the JAX package's layouts and dtype behaviour
(`repro.models.layers`): attention scores and softmax in float32, bf16
activations between ops. Attention here is plain einsum + softmax; the
decode hot path streams pages through `kernels.ops.paged_kv_attention`
(dense family) or the ring cache through `kernels.ops.packed_kv_attention`
(hybrid family).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core import quant

NEG_INF = -1e30


def _mean_sq(xf: torch.Tensor, fixed_order: bool = True) -> torch.Tensor:
    """The mean of xf * xf over the last dim, keepdim. On the card, with
    `fixed_order`, a fixed pairwise tree of elementwise adds (zeros pad
    the width to a power of two): torch's CUDA reductions split a row's
    sum by the tensor's shape, so a row's sum, and now and then its bf16
    norm, would depend on how many rows the call has, and a verify
    window's rows must keep the decode steps' bits (speculative decode
    emits the stepwise tokens). On the CPU, and without `fixed_order`,
    torch's mean (the parity tests were set against it on the CPU)."""
    sq = xf * xf
    n = sq.shape[-1]
    if sq.device.type == "cpu" or not fixed_order:
        return sq.mean(dim=-1, keepdim=True)
    width = 1 << (n - 1).bit_length()
    if width != n:
        sq = torch.nn.functional.pad(sq, (0, width - n))
    while sq.shape[-1] > 1:
        half = sq.shape[-1] // 2
        sq = sq[..., :half] + sq[..., half:]
    return sq / n


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6, *,
             fixed_order: bool = True) -> torch.Tensor:
    """`fixed_order=False` for the slab families' own norms: their verify
    replays a window as single-token steps, so a row never meets a second
    row count and need not pay the tree's ~10 launches."""
    xf = x.float()
    out = xf * torch.rsqrt(_mean_sq(xf, fixed_order) + eps)
    return (out * (1.0 + w.float())).to(x.dtype)


def sinusoidal_positions(positions: torch.Tensor, dim: int,
                         base: float = 10000.0) -> torch.Tensor:
    """positions (...,) -> (..., dim) float32 sinusoidal embedding
    (whisper-style): sin of every angle, then cos, the frequencies
    exp(-log(base) * i / half) computed in float32 as the JAX package
    computes them."""
    half = dim // 2
    # log(base) in float32 on the host (a device scalar would be a copy)
    neg_log = -torch.log(torch.tensor(base, dtype=torch.float32)).item()
    freqs = torch.exp(neg_log * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) or (S,). Rotate-half RoPE."""
    if theta <= 0:
        return x
    half = x.shape[-1] // 2
    base = torch.full((), theta, dtype=torch.float32, device=x.device)
    freqs = torch.pow(base, -torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half)
    if positions.ndim == 1:
        positions = positions[None, :]
    ang = positions.float()[:, :, None, None] * freqs      # (B,S,1,half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """1 / (1 + e^-x), rounded to x's dtype after each op: the sequence
    `jax.nn.sigmoid` lowers to (`torch.sigmoid` rounds a bf16 input once,
    which differs from it in about a third of the values)."""
    return 1 / (1 + torch.exp(-x))


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x) with `sigmoid`'s roundings, as the compiled
    `jax.nn.silu` runs it (`torch.nn.functional.silu` rounds once)."""
    return x * sigmoid(x)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """The tanh GELU as the compiled `jax.nn.gelu(approximate=True)` runs
    it: x * (0.5 * (1 + tanh(c2 * (x + c1 * x^3)))), its constants and
    every op rounded to x's dtype (`torch.nn.functional.gelu` rounds
    once)."""
    # the constants rounded on the host: a scalar exact in x's dtype
    # multiplies as the rounded constant would (and makes no device copy)
    c1 = torch.tensor(0.044715, dtype=x.dtype).item()
    c2 = torch.tensor(math.sqrt(2 / math.pi), dtype=x.dtype).item()
    return x * (0.5 * (1 + torch.tanh(c2 * (x + c1 * (x * x * x)))))


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with JAX's type promotion: a bf16 activation against float32
    weights (a float32 master tree) multiplies in float32, as `x @ w` does
    in the JAX package; equal dtypes take `x @ w` as it is."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    return x @ w


def mlp(x: torch.Tensor, w_gate: Optional[torch.Tensor], w_up: torch.Tensor,
        w_down: torch.Tensor, act: str) -> torch.Tensor:
    """The dense MLP on a normed x: silu(x @ w_gate) * (x @ w_up) @ w_down
    (swiglu) or gelu_tanh(x @ w_up) @ w_down, each activation op rounded
    as the compiled JAX MLP rounds it (`silu`, `gelu_tanh`)."""
    if act == "swiglu":
        h = silu(matmul(x, w_gate)) * matmul(x, w_up)
    else:
        h = gelu_tanh(matmul(x, w_up))
    return matmul(h, w_down)


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens]


def lm_head(y: torch.Tensor, vocab_real: int) -> torch.Tensor:
    """y: (B,S,V) the head product x @ head -> float32 logits, padded vocab
    slots -> -1e30."""
    logits = y.float()
    if vocab_real < y.shape[-1]:
        logits[..., vocab_real:] = NEG_INF
    return logits


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              q_chunk: int = 1024, q_offset: int = 0) -> torch.Tensor:
    """Exact full-sequence attention, chunked over the query axis to bound
    live memory (each chunk is computed alone, so chunking never changes
    a bit). q: (B, Sq, H, D); k, v: (B, Sk, KV, D), H % KV == 0 (GQA).
    Returns (B, Sq, H, D). Scores and softmax in float32, p cast to v's
    dtype for the PV product, as `repro.models.layers.attention`."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, D)
    kf = k.float()
    kpos = torch.arange(Sk, device=q.device)

    def one_chunk(qc: torch.Tensor, start: int) -> torch.Tensor:
        s = torch.einsum("bqkhd,bskd->bkhqs", qc.float(), kf)
        s = s * (1.0 / (D ** 0.5))
        if causal or window is not None:
            cq = qc.shape[1]
            qpos = start + q_offset + torch.arange(cq, device=q.device)
            m = torch.ones((cq, Sk), dtype=torch.bool, device=q.device)
            if causal:
                m &= kpos[None, :] <= qpos[:, None]
            if window is not None:
                m &= kpos[None, :] > qpos[:, None] - window
            s = s.masked_fill(~m, NEG_INF)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bkhqs,bskd->bqkhd", p.to(v.dtype), v)
        return o.reshape(B, qc.shape[1], H, D)

    if Sq <= q_chunk:
        return one_chunk(qg, 0)
    if Sq % q_chunk:
        raise ValueError(f"{Sq} queries do not split into chunks of "
                         f"{q_chunk}")
    return torch.cat([one_chunk(qg[:, i:i + q_chunk], i)
                      for i in range(0, Sq, q_chunk)], dim=1)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, positions: torch.Tensor, *,
                     window: Optional[int] = None) -> torch.Tensor:
    """Single-token attention against a seq-major (possibly ring) cache
    (B, S, KV, D). q: (B, 1, H, D); positions: (B,) index of the token
    being decoded (== valid cache slots - 1). A ring cache (`window`
    given, S == window) holds slot i once it is written, so slots
    <= min(position, S - 1) are valid: softmax does not depend on slot
    order. Scores and softmax in float32, p cast to the cache dtype for
    the PV product, as `repro.models.layers.decode_attention`."""
    B, _, H, D = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(B, 1, KV, H // KV, D)
    s = torch.einsum("bqkhd,bskd->bkhqs", qg.float(), k_cache.float())
    s = s * (1.0 / (D ** 0.5))
    slot = torch.arange(S, device=q.device)
    last = positions if window is None else positions.clamp(max=S - 1)
    valid = slot[None, :] <= last[:, None]                   # (B, S)
    s = s.masked_fill(~valid[:, None, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkhqs,bskd->bqkhd", p.to(v_cache.dtype), v_cache)
    return o.reshape(B, 1, H, D)


def decode_attention_kvmajor(q: torch.Tensor, k_cache: torch.Tensor,
                             v_cache: torch.Tensor, positions: torch.Tensor,
                             *, window: Optional[int] = None
                             ) -> torch.Tensor:
    """`decode_attention` over head-major caches (B, KV, S, D): the
    dequant reference of the packed layouts."""
    if window is None:
        return prefill_attention_kvmajor(q, k_cache, v_cache, positions)
    return decode_attention(q, k_cache.transpose(1, 2),
                            v_cache.transpose(1, 2), positions,
                            window=window)


def prefill_attention(q: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, starts: torch.Tensor
                      ) -> torch.Tensor:
    """`prefill_attention_kvmajor` over seq-major caches (B, S, KV, D):
    the chunked prefill of a Normal (bf16) contiguous cache."""
    return prefill_attention_kvmajor(q, k_cache.transpose(1, 2),
                                     v_cache.transpose(1, 2), starts)


def prefill_attention_kvmajor(q: torch.Tensor, k_cache: torch.Tensor,
                              v_cache: torch.Tensor, starts: torch.Tensor
                              ) -> torch.Tensor:
    """Chunk-vs-cache attention: q (B, C, H, D) whose token i sits at
    position starts[b] + i attends cache slots [0, starts[b] + i] of the
    head-major caches (B, KV, S, D). Scores and softmax in float32."""
    B, C, H, D = q.shape
    KV, S = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(B, C, KV, H // KV, D)
    s = torch.einsum("bqkhd,bksd->bkhqs", qg.float(), k_cache.float())
    s = s * (1.0 / (D ** 0.5))
    qpos = starts[:, None] + torch.arange(C, device=q.device)[None, :]
    kpos = torch.arange(S, device=q.device)
    m = kpos[None, None, :] <= qpos[:, :, None]              # (B, C, S)
    s = s.masked_fill(~m[:, None, None, :, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkhqs,bksd->bqkhd", p.to(v_cache.dtype), v_cache)
    return o.reshape(B, C, H, D)


def to_kvmajor(x: torch.Tensor) -> torch.Tensor:
    """Seq-major (..., S, KV, d) -> head-major (..., KV, S, d): the packed
    ring-cache layout `kernels.ops.packed_kv_attention` streams."""
    return x.transpose(-3, -2)


def update_cache_chunk(cache: torch.Tensor, new: torch.Tensor,
                       starts: torch.Tensor,
                       write_mask: Optional[torch.Tensor] = None, *,
                       axis: int = 0) -> torch.Tensor:
    """Write a C-line chunk per row: cache (B, ...) with the sequence at
    `axis` once the batch dim is stripped (0: seq-major (B, S, ...), 1:
    head-major (B, KV, S, ...)); new has C lines there; starts (B,) the
    first line of each row, clamped to [0, S - C] as
    `jax.lax.dynamic_update_slice` clamps it. Rows where `write_mask`
    (B,) is False keep their lines. Returns a new tensor, as the JAX
    package's functional update."""
    if axis not in (0, 1):
        raise ValueError(f"axis must be 0 or 1, got {axis}")
    S, C = cache.shape[1 + axis], new.shape[1 + axis]
    lines = (starts.long().clamp(0, S - C)[:, None]
             + torch.arange(C, device=cache.device)[None, :])   # (B, C)
    rows = torch.arange(cache.shape[0], device=cache.device)[:, None]
    out = cache.clone()
    if axis == 0:
        out[rows, lines] = new.to(cache.dtype)
    else:
        # the advanced indices (rows, lines) come first: (B, C, KV, ...)
        out[rows, :, lines] = new.transpose(1, 2).to(cache.dtype)
    if write_mask is None:
        return out
    keep = write_mask.reshape((-1,) + (1,) * (cache.ndim - 1))
    return torch.where(keep, out, cache)


def update_cache_line(cache: torch.Tensor, new: torch.Tensor,
                      positions: torch.Tensor, *, axis: int = 0
                      ) -> torch.Tensor:
    """Write one line per row: cache (B, ...) with the sequence at `axis`
    once the batch dim is stripped (0 for seq-major (B, S, ...), 1 for
    head-major (B, KV, S, ...)); new has size 1 there; positions (B,).
    Returns a new tensor, as the JAX package's functional update."""
    out = cache.clone()
    rows = torch.arange(cache.shape[0], device=cache.device)
    pos = positions.long()
    if axis == 0:
        out[rows, pos] = new[:, 0].to(cache.dtype)
    elif axis == 1:
        out[rows, :, pos] = new[:, :, 0].to(cache.dtype)
    else:
        raise ValueError(f"axis must be 0 or 1, got {axis}")
    return out


def pack_kv_int4(kv: torch.Tensor):
    """kv: (..., D) bf16 -> (uint8 (..., D//2), scale (..., 1) bf16);
    even lanes in the high nibble."""
    q, scale = quant.quantize_int4(kv)
    return quant.pack_int4_pair(q[..., 0::2], q[..., 1::2]), scale


def unpack_int4_pairs(packed: torch.Tensor) -> torch.Tensor:
    """(..., D//2) uint8 -> (..., D) int8 levels, interleaved pairs."""
    hi = quant.unpack_int4_hi(packed)
    lo = quant.unpack_int4_lo(packed)
    return torch.stack([hi, lo], dim=-1).reshape(
        *packed.shape[:-1], packed.shape[-1] * 2)


def unpack_kv_int4(packed: torch.Tensor, scale: torch.Tensor,
                   dtype=torch.bfloat16) -> torch.Tensor:
    return (unpack_int4_pairs(packed).float() * scale.float()).to(dtype)


def pack_kv_int8(kv: torch.Tensor):
    return quant.quantize_int8(kv)


def unpack_kv_int8(q: torch.Tensor, scale: torch.Tensor,
                   dtype=torch.bfloat16) -> torch.Tensor:
    return (q.float() * scale.float()).to(dtype)
