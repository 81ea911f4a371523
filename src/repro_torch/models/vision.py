"""Llama-3.2-Vision backbone: 8 macro-blocks of (4 self-attention + 1
gated cross-attention) = 40 layers.

Ports `repro.models.vision`: `N_SELF_PER_BLOCK`, `_n_blocks`,
`abstract_params`, `_patch_kv`, `_cross_attn`, `forward`, the contiguous
`decode_step`, `abstract_cache`, `prefix_state_specs` and
`paged_decode_step`. The patch-embedding cross
KV (computed once per image) is the STATIC plane: the engine keeps it in
a static `AugmentedStatePool` slab beside the paged pool (a
`CompositeStore`) and hands it to the step as dense `patch_k` /
`patch_v`; the self KV is the DYNAMIC plane, on the paged pool, whose
arenas carry the nb * 4 self-attention layers flat (layer b * 4 + i of
block b). The gated cross attention is plain attention over the dense
patch KV, as in the JAX package (XLA, no Pallas kernel there).

The full-sequence side projects the patches (a stub vision tower in both
packages: precomputed patch embeddings), then runs each macro-block: its
4 self layers, each under the remat policy, and the gated cross layer;
the macro-block itself runs under the policy too, as in JAX (without the
outer remat the cross attention's probabilities would be kept for the
backward pass). `forward(return_cache=True)` returns the nb * 4 self
layers' KV packed as `transformer._pack_prefill_cache` packs it and the
bf16 patch KV; the contiguous `decode_step` reads the self KV through
kernel 6 at int4 / int8. The serving path never calls this side: the
slab stays as admission leaves it, as in the JAX engine.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import constrain, gather_weights
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.params import PSpec, attn_pspecs, mlp_pspecs

N_SELF_PER_BLOCK = 4


def _n_blocks(cfg: ModelConfig) -> int:
    return cfg.n_layers // (N_SELF_PER_BLOCK + 1)


def abstract_params(cfg: ModelConfig) -> dict:
    """The self layers' leaves are (nb, 4, ...), the cross layers' (nb,
    ...), with a zero-initialised tanh gate per cross layer on its
    attention and on its MLP."""
    nb = _n_blocks(cfg)
    d, V = cfg.d_model, cfg.vocab_padded

    def per_block(specs: dict) -> dict:
        return {k: PSpec((nb,) + s.shape, (None,) + s.axes, s.dtype,
                         s.init)
                for k, s in specs.items()}
    cross = attn_pspecs(cfg, nb)
    cross["gate_attn"] = PSpec((nb,), (None,), init="zeros")
    cross["gate_ffn"] = PSpec((nb,), (None,), init="zeros")
    return {
        "embed": PSpec((V, d), ("vocab", "embed")),
        "patch_proj": PSpec((cfg.vision.vision_dim, d), (None, "embed")),
        "final_norm": PSpec((d,), (None,), init="zeros"),
        "blocks": {"self_attn": per_block(attn_pspecs(cfg, N_SELF_PER_BLOCK)),
                   "self_mlp": per_block(mlp_pspecs(cfg, N_SELF_PER_BLOCK)),
                   "cross": cross, "cross_mlp": mlp_pspecs(cfg, nb)},
        "head": PSpec((d, V), ("embed", "vocab")),
    }


def prefix_state_specs(cfg: ModelConfig, batch: int) -> dict:
    """The STATIC per-row decode state (the patch KV of every cross
    layer): the slab the engine keeps in an `AugmentedStatePool` against
    the same byte budget as the KV pages."""
    shape = (_n_blocks(cfg), batch, cfg.vision.n_patches, cfg.n_kv_heads,
             cfg.hd)
    ax = (None, "cache_batch", "frames", "kv_heads", None)
    return {"patch_k": PSpec(shape, ax, init="zeros"),
            "patch_v": PSpec(shape, ax, init="zeros")}


def abstract_cache(cfg: ModelConfig, batch: int, seq: int) -> dict:
    """The contiguous decode cache: the nb * 4 self layers' KV at `seq`
    tokens as `transformer.abstract_cache` lays it out (packed head-major
    at int4 / int8) and the bf16 patch KV."""
    flat = dataclasses.replace(cfg, n_layers=_n_blocks(cfg)
                               * N_SELF_PER_BLOCK)
    return {**T.abstract_cache(flat, batch, seq),
            **prefix_state_specs(cfg, batch)}


def _patch_kv(cfg: ModelConfig, p: dict, patches: torch.Tensor):
    """A cross layer's K / V (B, Np, KV, hd) from the projected
    patches."""
    B, Np, _ = patches.shape
    KV, hd = cfg.n_kv_heads, cfg.hd
    return (L.matmul(patches, p["wk"]).reshape(B, Np, KV, hd),
            L.matmul(patches, p["wv"]).reshape(B, Np, KV, hd))


def _cross_attn(cfg: ModelConfig, p: dict, x: torch.Tensor,
                pk: torch.Tensor, pv: torch.Tensor, *,
                norm_fixed: bool = True) -> torch.Tensor:
    """tanh(gate_attn) x the cross attention of x (B, S, d) over the dense
    patch KV pk / pv (B, Np, KV, hd): no mask, no RoPE. `norm_fixed` as
    `transformer.mlp_block`'s (False in the full-sequence forward)."""
    B, S, _ = x.shape
    H, hd = cfg.n_heads, cfg.hd
    h = L.rms_norm(x, p["norm"], cfg.norm_eps, fixed_order=norm_fixed)
    q = L.matmul(h, p["wq"]).reshape(B, S, H, hd)
    o = L.attention(q, pk, pv, causal=False,
                    q_chunk=1024 if S % 1024 == 0 else S)
    a = L.matmul(o.reshape(B, S, -1), p["wo"]).to(x.dtype)
    return torch.tanh(p["gate_attn"]).to(x.dtype) * a


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            patches: torch.Tensor, *, rules=None, return_cache: bool = False,
            remat_policy: str = "dots", q_chunk: int = 1024):
    """tokens (B, S), patches (B, Np, vision_dim) -> float32 logits (B, S,
    V) [+ the decode cache: the packed KV of the nb * 4 self layers and
    the bf16 patch KV]. With `rules`, the residual stream is
    sequence-parallel between the blocks, as in the JAX forward."""
    S = tokens.shape[1]
    top = gather_weights(params, rules, skip=("blocks",))
    x = L.embed_lookup(top["embed"], tokens).to(torch.bfloat16)
    x = constrain(x, rules, "batch", "seq_sp", None)
    px = L.matmul(patches, top["patch_proj"]).to(torch.bfloat16)
    px = constrain(px, rules, "batch", None, None)
    positions = torch.arange(S, device=x.device)

    def self_body(x, lp):
        x = constrain(x, rules, "batch", "seq_sp", None)
        a, kv = T.attn_block(cfg, lp["attn"], x, positions, q_chunk=q_chunk,
                             rules=rules)
        x = constrain(x + a, rules, "batch", "seq_sp", None)
        x = x + T.mlp_block(cfg, lp["mlp"], x, fixed_order=False,
                            norm_fixed=False)
        return x, (kv if return_cache else None)

    run_self = T._remat(self_body, remat_policy)

    def block_body(x, bp):
        bp = gather_weights(bp, rules)
        kvs = []
        for i in range(N_SELF_PER_BLOCK):
            x, kv = run_self(x, {"attn": T._layer(bp["self_attn"], i),
                                 "mlp": T._layer(bp["self_mlp"], i)})
            kvs.append(kv)
        pk, pv = _patch_kv(cfg, bp["cross"], px)
        x = constrain(x, rules, "batch", "seq_sp", None)
        x = x + _cross_attn(cfg, bp["cross"], x, pk, pv, norm_fixed=False)
        g = torch.tanh(bp["cross"]["gate_ffn"]).to(x.dtype)
        x = x + g * T.mlp_block(cfg, bp["cross_mlp"], x, fixed_order=False,
                                norm_fixed=False)
        return (constrain(x, rules, "batch", "seq_sp", None),
                (kvs, pk, pv) if return_cache else None)

    # remat at the macro-block level too: without it the cross
    # attention's probabilities (B, KV, Hg, S, Np) are kept for backward
    run = T._remat(block_body, remat_policy)
    outs = []
    for b in range(_n_blocks(cfg)):
        x, o = run(x, T._layer_groups(params["blocks"], b))
        outs.append(o)
    logits = T._logits_head(cfg, top, x, fixed_order=False,
                            norm_fixed=False)
    if not return_cache:
        return logits
    kvs = [kv for kvs, _, _ in outs for kv in kvs]
    cache = T._pack_prefill_cache(cfg, tuple(
        torch.stack([kv[j] for kv in kvs]) for j in range(2)))
    cache["patch_k"] = torch.stack([pk for _, pk, _ in outs])
    cache["patch_v"] = torch.stack([pv for _, _, pv in outs])
    return logits, cache


def decode_step(cfg: ModelConfig, params: dict, cache: dict,
                tokens: torch.Tensor, positions: torch.Tensor, *,
                rules=None):
    """One decode step over the contiguous cache: tokens (B, 1), positions
    (B,). The nb * 4 self layers write the new token's KV and read the
    cache (layer b * 4 + i) through kernel 6 at int4 / int8; each block's
    gated cross attention reads the bf16 patch KV. Returns (logits (B, 1,
    V), new cache). With `rules`, kernel 6 reads each rank's local cache
    shard."""
    pk, pv = cache["patch_k"], cache["patch_v"]
    selfc = {k: v for k, v in cache.items() if not k.startswith("patch_")}
    top = gather_weights(params, rules, skip=("blocks",))
    x = L.embed_lookup(top["embed"], tokens).to(torch.bfloat16)
    new = []
    for b in range(_n_blocks(cfg)):
        bp = gather_weights(T._layer_groups(params["blocks"], b), rules)
        for i in range(N_SELF_PER_BLOCK):
            a, c = T.attn_block_decode(
                cfg, T._layer(bp["self_attn"], i), x,
                T._layer(selfc, b * N_SELF_PER_BLOCK + i), positions,
                rules=rules)
            x = x + a
            x = x + T.mlp_block(cfg, T._layer(bp["self_mlp"], i), x)
            new.append(c)
        x = x + _cross_attn(cfg, bp["cross"], x, pk[b], pv[b])
        g = torch.tanh(bp["cross"]["gate_ffn"]).to(x.dtype)
        x = x + g * T.mlp_block(cfg, bp["cross_mlp"], x)
    out = T._stack_layers(new)
    out["patch_k"], out["patch_v"] = pk, pv
    return T._logits_head(cfg, top, x), out


def paged_decode_step(cfg: ModelConfig, params: dict, arenas: dict,
                      tokens: torch.Tensor, positions: torch.Tensor,
                      meta: dict):
    """One decode step against the paged pool: the nb * 4 self-attention
    layers walk the decode band (arena layer b * 4 + i), each block's
    gated cross attention reads the dense patch KV the engine
    reconstitutes from its static slab (``meta["patch_k"]`` /
    ``meta["patch_v"]``, (nb, B, Np, KV, hd)). Returns (logits (B, 1,
    V), arenas) with the arenas updated in place."""
    pk, pv = meta["patch_k"], meta["patch_v"]
    x = L.embed_lookup(params["embed"], tokens).to(torch.bfloat16)
    for b in range(_n_blocks(cfg)):
        bp = T._layer_groups(params["blocks"], b)
        for i in range(N_SELF_PER_BLOCK):
            x = x + T.attn_block_decode_paged(
                cfg, T._layer(bp["self_attn"], i), x,
                T._layer(arenas, b * N_SELF_PER_BLOCK + i), positions, meta)
            x = x + T.mlp_block(cfg, T._layer(bp["self_mlp"], i), x)
        x = x + _cross_attn(cfg, bp["cross"], x, pk[b], pv[b])
        g = torch.tanh(bp["cross"]["gate_ffn"]).to(x.dtype)
        x = x + g * T.mlp_block(cfg, bp["cross_mlp"], x)
    return T._logits_head(cfg, params, x), arenas
