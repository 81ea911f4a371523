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

from typing import Optional

import torch

from repro_torch.core import quant

NEG_INF = -1e30


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + w.float())).to(x.dtype)


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


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens]


def lm_head(y: torch.Tensor, vocab_real: int) -> torch.Tensor:
    """y: (B,S,V) the head product x @ head -> float32 logits, padded vocab
    slots -> -1e30."""
    logits = y.float()
    if vocab_real < y.shape[-1]:
        logits[..., vocab_real:] = NEG_INF
    return logits


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
