"""Llama-3.2-Vision backbone: 8 macro-blocks of (4 self-attention + 1
gated cross-attention) = 40 layers. The decode side the serving path
runs.

Ports `repro.models.vision`'s `N_SELF_PER_BLOCK`, `_n_blocks`,
`abstract_params`, `_cross_attn`, `abstract_cache`,
`prefix_state_specs` and `paged_decode_step`. The patch-embedding cross
KV (computed once per image) is the STATIC plane: the engine keeps it in
a static `AugmentedStatePool` slab beside the paged pool (a
`CompositeStore`) and hands it to the step as dense `patch_k` /
`patch_v`; the self KV is the DYNAMIC plane, on the paged pool, whose
arenas carry the nb * 4 self-attention layers flat (layer b * 4 + i of
block b). The gated cross attention is plain attention over the dense
patch KV, as in the JAX package (XLA, no Pallas kernel there).

The vision tower (`_patch_kv`), `forward` and the contiguous
`decode_step` are the full-sequence side, which the serving path never
calls: the slab stays as admission leaves it, as in the JAX engine (the
patches are a stub in both packages).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
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
        return {k: PSpec((nb,) + s.shape, s.dtype, s.init)
                for k, s in specs.items()}
    cross = attn_pspecs(cfg, nb)
    cross["gate_attn"] = PSpec((nb,), init="zeros")
    cross["gate_ffn"] = PSpec((nb,), init="zeros")
    return {
        "embed": PSpec((V, d)),
        "patch_proj": PSpec((cfg.vision.vision_dim, d)),
        "final_norm": PSpec((d,), init="zeros"),
        "blocks": {"self_attn": per_block(attn_pspecs(cfg, N_SELF_PER_BLOCK)),
                   "self_mlp": per_block(mlp_pspecs(cfg, N_SELF_PER_BLOCK)),
                   "cross": cross, "cross_mlp": mlp_pspecs(cfg, nb)},
        "head": PSpec((d, V)),
    }


def prefix_state_specs(cfg: ModelConfig, batch: int) -> dict:
    """The STATIC per-row decode state (the patch KV of every cross
    layer): the slab the engine keeps in an `AugmentedStatePool` against
    the same byte budget as the KV pages."""
    shape = (_n_blocks(cfg), batch, cfg.vision.n_patches, cfg.n_kv_heads,
             cfg.hd)
    return {"patch_k": PSpec(shape, init="zeros"),
            "patch_v": PSpec(shape, init="zeros")}


def abstract_cache(cfg: ModelConfig, batch: int, seq: int) -> dict:
    """The self layers' bf16 KV at `seq` tokens and the patch KV."""
    shape = (_n_blocks(cfg) * N_SELF_PER_BLOCK, batch, seq, cfg.n_kv_heads,
             cfg.hd)
    return {"k": PSpec(shape, init="zeros"), "v": PSpec(shape, init="zeros"),
            **prefix_state_specs(cfg, batch)}


def _cross_attn(cfg: ModelConfig, p: dict, x: torch.Tensor,
                pk: torch.Tensor, pv: torch.Tensor) -> torch.Tensor:
    """tanh(gate_attn) x the cross attention of x (B, 1, d) over the
    dense patch KV pk / pv (B, Np, KV, hd): no mask."""
    B, S, _ = x.shape
    H, hd = cfg.n_heads, cfg.hd
    h = L.rms_norm(x, p["norm"], cfg.norm_eps)
    q = (h @ p["wq"]).reshape(B, S, H, hd)
    # one query a row over every patch: the decode attention with each
    # row's last valid slot the last patch masks nothing
    last = torch.full((B,), pk.shape[1] - 1, device=x.device)
    o = L.decode_attention(q, pk, pv, last)
    a = (o.reshape(B, S, -1) @ p["wo"]).to(x.dtype)
    return torch.tanh(p["gate_attn"]).to(x.dtype) * a


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
