"""Whisper-style encoder-decoder: the decode side the serving path runs.

Ports `repro.models.encdec`'s `abstract_params`, `abstract_cache`,
`cross_block_decode_paged` and `paged_decode_step`. The cross-attention
KV (computed once per utterance) is the STATIC plane: it lives in the
paged pool's prefix band (rows [B, 2B) of the page table), allocated
and zeroed at admission, and is read at the fixed length `n_frames`
every decode step through kernel 2 (`ops.paged_prefix_attention`). The
decoder's self KV is the DYNAMIC plane, on the decode band. Positions
are sinusoidal, computed in float32 and added in bf16.

The encoder (`encode`, `forward`, `cross_block`, `_enc_kv`) and the
contiguous `decode_step` are the full-sequence side, which the serving
path never calls: the engine serves with the band as admission leaves
it, as the JAX engine does (the frames are a stub in both packages).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as K
from repro_torch.kernels.paged_kv_attention import paged_gather_kv
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.params import PSpec, attn_pspecs, mlp_pspecs


def abstract_params(cfg: ModelConfig) -> dict:
    e = cfg.encdec
    n, ne, d, V = (cfg.n_layers, e.n_encoder_layers, cfg.d_model,
                   cfg.vocab_padded)
    return {
        "embed": PSpec((V, d)),
        "final_norm": PSpec((d,), init="zeros"),
        "enc_final_norm": PSpec((d,), init="zeros"),
        "frame_proj": PSpec((e.frame_dim, d)),
        "encoder": {"attn": attn_pspecs(cfg, ne),
                    "mlp": mlp_pspecs(cfg, ne)},
        "layers": {"attn": attn_pspecs(cfg, n),
                   "cross": attn_pspecs(cfg, n),
                   "mlp": mlp_pspecs(cfg, n)},
        "head": PSpec((d, V)),
    }


def abstract_cache(cfg: ModelConfig, batch: int, seq: int) -> dict:
    """The decoder's bf16 self KV at `seq` tokens and the cross KV over
    the `n_frames` frames, every layer: the logical size of what the
    pool's two bands hold."""
    n, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    self_kv = (n, batch, seq, KV, hd)
    cross = (n, batch, cfg.encdec.n_frames, KV, hd)
    return {"k": PSpec(self_kv, init="zeros"),
            "v": PSpec(self_kv, init="zeros"),
            "cross_k": PSpec(cross, init="zeros"),
            "cross_v": PSpec(cross, init="zeros")}


def cross_block_decode_paged(cfg: ModelConfig, p: dict, x: torch.Tensor,
                             arena_layer: dict, meta: dict) -> torch.Tensor:
    """Single-token cross attention against the pool's static prefix
    band: no RoPE on q, no causal mask, each row's length pinned to the
    prefix length (`meta["cross_lengths"]`, 0 on an idle slot, whose
    output is finite and ignored). kv_impl="kernel" walks the band's own
    (cross_table, cross_modes) with kernel 2; "dequant" gathers the band
    densely and masks by length, the JAX package's reference."""
    B = x.shape[0]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    h = L.rms_norm(x, p["norm"], cfg.norm_eps)
    q = (h @ p["wq"]).reshape(B, H, hd)
    if cfg.amc.kv_impl == "kernel":
        o = K.paged_prefix_attention(
            q.reshape(B, KV, H // KV, hd), arena_layer["kn"],
            arena_layer["vn"], arena_layer["kp"], arena_layer["vp"],
            arena_layer["ks"], arena_layer["vs"], meta["cross_lengths"],
            meta["cross_table"], meta["cross_modes"],
            kv_bits=cfg.amc.aug_bits)
        o = o.reshape(B, 1, H, hd)
    elif cfg.amc.kv_impl == "dequant":
        kd, vd = paged_gather_kv(
            arena_layer["kn"], arena_layer["vn"], arena_layer["kp"],
            arena_layer["vp"], arena_layer["ks"], arena_layer["vs"],
            meta["cross_table"], meta["cross_modes"],
            kv_bits=cfg.amc.aug_bits)
        o = L.decode_attention_kvmajor(
            q[:, None], kd.to(torch.bfloat16), vd.to(torch.bfloat16),
            meta["cross_lengths"] - 1)
    else:
        raise ValueError(f"unknown kv_impl {cfg.amc.kv_impl!r}")
    return (o.reshape(B, 1, -1) @ p["wo"]).to(x.dtype)


def paged_decode_step(cfg: ModelConfig, params: dict, arenas: dict,
                      tokens: torch.Tensor, positions: torch.Tensor,
                      meta: dict):
    """One decode step against the paged pool: self attention walks the
    decode band (writing the new token's KV in place), cross attention
    the static prefix band. tokens (B, 1), positions (B,); `meta` the
    pool's device tables (decode and cross bands) plus write_mask (B,).
    Returns (logits (B, 1, V), arenas)."""
    x = L.embed_lookup(params["embed"], tokens).to(torch.bfloat16)
    x = x + L.sinusoidal_positions(positions, cfg.d_model)[:, None].to(
        x.dtype)
    layers = params["layers"]
    for i in range(cfg.n_layers):
        lp = T._layer_groups(layers, i)
        arena = T._layer(arenas, i)
        x = x + T.attn_block_decode_paged(cfg, lp["attn"], x, arena,
                                          positions, meta)
        x = x + cross_block_decode_paged(cfg, lp["cross"], x, arena, meta)
        x = x + T.mlp_block(cfg, lp["mlp"], x)
    return T._logits_head(cfg, params, x), arenas
