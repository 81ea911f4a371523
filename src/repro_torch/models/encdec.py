"""Whisper-style encoder-decoder.

Ports `repro.models.encdec`: `abstract_params`, `abstract_cache`, the
full-sequence side (`encode`, `cross_block`, `_enc_kv`, `forward`), the
contiguous `decode_step`, and the serving path's
`cross_block_decode_paged` and `paged_decode_step`. The cross-attention
KV (computed once per utterance) is the STATIC plane: it lives in the
paged pool's prefix band (rows [B, 2B) of the page table), allocated
and zeroed at admission, and is read at the fixed length `n_frames`
every decode step through kernel 2 (`ops.paged_prefix_attention`). The
decoder's self KV is the DYNAMIC plane, on the decode band. Positions
are sinusoidal, computed in float32 and added in bf16.

The full-sequence side encodes the frames (a stub frontend in both
packages: precomputed frame embeddings) under a full checkpoint, as JAX's
`jax.checkpoint`, then runs the teacher-forced decoder, each layer under
the remat policy; every product is a plain torch op (XLA in the JAX
package), so it is differentiable. `forward(return_cache=True)` returns
the self KV packed as `transformer._pack_prefill_cache` packs it (the
plain packs, as in JAX) and the cross KV in bf16 (the static plane); the
contiguous `decode_step` reads the self KV through kernel 6 at int4 /
int8. The serving path never calls this side: the engine serves with
the band as admission leaves it, as the JAX engine does.
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
    """The contiguous decode cache: the decoder's self KV at `seq` tokens
    as `transformer.abstract_cache` lays it out (bf16 seq-major at
    kv_mode "normal", packed head-major with scales at int4 / int8) and
    the bf16 cross KV over the `n_frames` frames, every layer."""
    n, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    c = T.abstract_cache(cfg, batch, seq)
    cross = (n, batch, cfg.encdec.n_frames, KV, hd)
    c["cross_k"] = PSpec(cross, init="zeros")
    c["cross_v"] = PSpec(cross, init="zeros")
    return c


def encode(cfg: ModelConfig, params: dict,
           frames: torch.Tensor) -> torch.Tensor:
    """frames (B, F, frame_dim) -> the encoder states (B, F, d): the frame
    projection, sinusoidal positions, bidirectional layers (each
    recomputed in the backward pass) and the final norm."""
    F_ = frames.shape[1]
    x = L.matmul(frames, params["frame_proj"]).to(torch.bfloat16)
    positions = torch.arange(F_, device=x.device)
    x = x + L.sinusoidal_positions(positions, cfg.d_model)[None].to(x.dtype)
    q_chunk = min(F_, 1024) if F_ % 1024 == 0 or F_ < 1024 else F_

    def body(x, lp):
        a, _ = T.attn_block(cfg, lp["attn"], x, positions, causal=False,
                            q_chunk=q_chunk)
        x = x + a
        return x + T.mlp_block(cfg, lp["mlp"], x, fixed_order=False,
                               norm_fixed=False)

    run = T._remat(body, "nothing")
    for i in range(cfg.encdec.n_encoder_layers):
        x = run(x, T._layer_groups(params["encoder"], i))
    return L.rms_norm(x, params["enc_final_norm"], cfg.norm_eps,
                      fixed_order=False)


def cross_block(cfg: ModelConfig, p: dict, x: torch.Tensor,
                enc_k: torch.Tensor, enc_v: torch.Tensor, *,
                norm_fixed: bool = False) -> torch.Tensor:
    """Cross attention of x (B, S, d) over the precomputed encoder K / V
    (B, F, KV, hd), the static plane: no RoPE, no mask. `norm_fixed` as
    `transformer.mlp_block`'s (the decode step's norm takes the fixed
    tree on the card)."""
    B, S, _ = x.shape
    h = L.rms_norm(x, p["norm"], cfg.norm_eps, fixed_order=norm_fixed)
    q = L.matmul(h, p["wq"]).reshape(B, S, cfg.n_heads, cfg.hd)
    o = L.attention(q, enc_k, enc_v, causal=False,
                    q_chunk=1024 if S % 1024 == 0 else S)
    return L.matmul(o.reshape(B, S, -1), p["wo"]).to(x.dtype)


def _enc_kv(cfg: ModelConfig, p: dict, enc: torch.Tensor):
    """A decoder layer's cross K / V (B, F, KV, hd) from the encoder
    states."""
    B, F_, _ = enc.shape
    KV, hd = cfg.n_kv_heads, cfg.hd
    return (L.matmul(enc, p["wk"]).reshape(B, F_, KV, hd),
            L.matmul(enc, p["wv"]).reshape(B, F_, KV, hd))


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            frames: torch.Tensor, *, return_cache: bool = False,
            remat_policy: str = "dots", q_chunk: int = 1024):
    """The teacher-forced decoder over the encoded frames: tokens (B, S),
    frames (B, F, frame_dim) -> float32 logits (B, S, V) [+ the decode
    cache: the packed self KV of the S tokens and the bf16 cross KV]."""
    enc = encode(cfg, params, frames)
    S = tokens.shape[1]
    x = L.embed_lookup(params["embed"], tokens).to(torch.bfloat16)
    positions = torch.arange(S, device=x.device)
    x = x + L.sinusoidal_positions(positions, cfg.d_model)[None].to(x.dtype)

    def body(x, lp):
        a, kv = T.attn_block(cfg, lp["attn"], x, positions, q_chunk=q_chunk)
        x = x + a
        ek, ev = _enc_kv(cfg, lp["cross"], enc)
        x = x + cross_block(cfg, lp["cross"], x, ek, ev)
        x = x + T.mlp_block(cfg, lp["mlp"], x, fixed_order=False,
                            norm_fixed=False)
        return x, ((kv, (ek, ev)) if return_cache else None)

    run = T._remat(body, remat_policy)
    kvs = []
    for i in range(cfg.n_layers):
        x, kv = run(x, T._layer_groups(params["layers"], i))
        kvs.append(kv)
    logits = T._logits_head(cfg, params, x, fixed_order=False,
                            norm_fixed=False)
    if not return_cache:
        return logits
    cache = T._pack_prefill_cache(cfg, tuple(
        torch.stack([kv[0][j] for kv in kvs]) for j in range(2)))
    # the static plane stays bf16
    cache["cross_k"] = torch.stack([kv[1][0] for kv in kvs])
    cache["cross_v"] = torch.stack([kv[1][1] for kv in kvs])
    return logits, cache


def decode_step(cfg: ModelConfig, params: dict, cache: dict,
                tokens: torch.Tensor, positions: torch.Tensor):
    """One decode step over the contiguous cache: tokens (B, 1), positions
    (B,). The self attention writes the new token's KV and reads the
    cache through kernel 6 at int4 / int8 (`transformer.
    attn_block_decode`); the cross attention reads the bf16 cross KV.
    Returns (logits (B, 1, V), new cache)."""
    x = L.embed_lookup(params["embed"], tokens).to(torch.bfloat16)
    x = x + L.sinusoidal_positions(positions, cfg.d_model)[:, None].to(
        x.dtype)
    cross_k, cross_v = cache["cross_k"], cache["cross_v"]
    selfc = {k: v for k, v in cache.items() if not k.startswith("cross_")}
    new = []
    for i in range(cfg.n_layers):
        lp = T._layer_groups(params["layers"], i)
        a, c = T.attn_block_decode(cfg, lp["attn"], x, T._layer(selfc, i),
                                   positions)
        x = x + a
        x = x + cross_block(cfg, lp["cross"], x, cross_k[i], cross_v[i],
                            norm_fixed=True)
        x = x + T.mlp_block(cfg, lp["mlp"], x)
        new.append(c)
    out = T._stack_layers(new)
    out["cross_k"], out["cross_v"] = cross_k, cross_v
    return T._logits_head(cfg, params, x), out


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
