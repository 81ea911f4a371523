"""Decoder-only dense transformer over the paged Normal/Augmented KV pool.

Ports the paged path of `repro.models.transformer`: `_project_qkv`,
`_paged_pack`, `_paged_scatter`, `_paged_gather`, the decode and prefill
attention blocks, `mlp_block`, `paged_decode_step` and
`paged_prefill_chunk_step`. JAX's `lax.scan` over the stacked layers is a
Python loop over the layer index of the stacked tensors.

Unlike the JAX package, which returns new arrays, the scatter writes the
pool's arenas IN PLACE (each layer's arenas are views of the stacked
tensors the pool owns), so a step returns the same arena dict it was
given.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as K
from repro_torch.kernels.paged_kv_attention import paged_gather_kv
from repro_torch.models import augment
from repro_torch.models import layers as L


def _project_qkv(cfg: ModelConfig, p: dict, x: torch.Tensor, positions):
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    h = L.rms_norm(x, p["norm"], cfg.norm_eps)
    q = augment.proj(p, "wq", h, cfg.amc)
    k = augment.proj(p, "wk", h, cfg.amc)
    v = augment.proj(p, "wv", h, cfg.amc)
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = L.apply_rope(q.reshape(B, S, H, hd), positions, cfg.rope_theta)
    k = L.apply_rope(k.reshape(B, S, KV, hd), positions, cfg.rope_theta)
    return q, k, v.reshape(B, S, KV, hd)


def _paged_pack(cfg: ModelConfig, kv: torch.Tensor):
    """Quantize bf16 KV for the Augmented plane: int4 through the fused
    `quantize_pack_kv` write driver (its plain version on the dequant
    reference path), int8 through the plain pack."""
    if cfg.amc.aug_bits == 4:
        return K.quantize_pack_kv(kv, plain=cfg.amc.kv_impl == "dequant")
    return L.pack_kv_int8(kv)


def _paged_scatter(cfg: ModelConfig, arenas: dict, k_new: torch.Tensor,
                   v_new: torch.Tensor, pos: torch.Tensor, meta: dict,
                   write: torch.Tensor) -> dict:
    """Scatter per-token KV rows (B, T, KV, hd) at absolute positions pos
    (B, T) into the plane each token's page is in, IN PLACE. Tokens with
    write == False are redirected to physical page 0, the write-dump page,
    so the other rows' pages stay bit-identical."""
    page = cfg.amc.page_size
    table, modes = meta["page_table"], meta["page_modes"]
    # rows outside the write mask may sit past the table (stale positions
    # of idle rows, padded prefill tails): clamp the lookup, the write is
    # redirected to the dump page anyway
    lp = (pos // page).clamp(max=table.shape[1] - 1).long()
    slot = (pos % page).long()
    phys = torch.gather(table, 1, lp).long()
    mode = torch.gather(modes, 1, lp)
    policy = cfg.amc.resolved_pool_mode
    if policy != "always-augmented":
        pn = torch.where(write & (mode == 0), phys, 0)
        arenas["kn"][pn, :, slot] = k_new.to(torch.bfloat16)
        arenas["vn"][pn, :, slot] = v_new.to(torch.bfloat16)
    if policy != "normal-only":
        pp = torch.where(write & (mode == 1), phys, 0)
        kq, ks = _paged_pack(cfg, k_new)
        vq, vs = _paged_pack(cfg, v_new)
        arenas["kp"][pp, :, slot] = kq
        arenas["vp"][pp, :, slot] = vq
        arenas["ks"][pp, :, slot] = ks[..., 0].to(torch.bfloat16)
        arenas["vs"][pp, :, slot] = vs[..., 0].to(torch.bfloat16)
    return arenas


def _paged_gather(cfg: ModelConfig, arenas: dict, meta: dict):
    """The pool's logical caches (B, KV, maxP*page, hd) in bf16: the
    chunked-prefill attention operand and the dequant decode path."""
    kd, vd = paged_gather_kv(arenas["kn"], arenas["vn"], arenas["kp"],
                             arenas["vp"], arenas["ks"], arenas["vs"],
                             meta["page_table"], meta["page_modes"],
                             kv_bits=cfg.amc.aug_bits)
    return kd.to(torch.bfloat16), vd.to(torch.bfloat16)


def attn_block_decode_paged(cfg: ModelConfig, p: dict, x: torch.Tensor,
                            arenas: dict, positions: torch.Tensor,
                            meta: dict):
    """Single-token attention against the paged pool: the new token's KV
    is scattered into its tail page's plane, then the row's pages are
    walked by the `paged_kv_attention` kernel (kv_impl="kernel") or
    gathered for dense attention (kv_impl="dequant")."""
    B = x.shape[0]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q, k_new, v_new = _project_qkv(cfg, p, x, positions[:, None])
    _paged_scatter(cfg, arenas, k_new, v_new, positions[:, None], meta,
                   meta["write_mask"][:, None])
    if cfg.amc.kv_impl == "kernel":
        o = K.paged_kv_attention(
            q[:, 0].reshape(B, KV, H // KV, hd), arenas["kn"], arenas["vn"],
            arenas["kp"], arenas["vp"], arenas["ks"], arenas["vs"],
            positions + 1, meta["page_table"], meta["page_modes"],
            kv_bits=cfg.amc.aug_bits)
    elif cfg.amc.kv_impl == "dequant":
        kd, vd = _paged_gather(cfg, arenas, meta)
        o = L.decode_attention_kvmajor(q, kd, vd, positions)
    else:
        raise ValueError(f"unknown kv_impl {cfg.amc.kv_impl!r}")
    o = augment.proj(p, "wo", o.reshape(B, 1, -1), cfg.amc)
    return o.to(x.dtype)


def attn_block_prefill_paged(cfg: ModelConfig, p: dict, x: torch.Tensor,
                             arenas: dict, starts: torch.Tensor,
                             write_mask: Optional[torch.Tensor], meta: dict):
    """Chunked-prefill attention: the chunk's KV is scattered across the
    pages (and modes) the page table assigns, then attended exactly
    against the gathered logical cache."""
    B, C, _ = x.shape
    positions = starts[:, None] + torch.arange(C, device=x.device)[None, :]
    q, k_new, v_new = _project_qkv(cfg, p, x, positions)
    write = torch.ones((B, C), dtype=torch.bool, device=x.device)
    if write_mask is not None:
        write = write & write_mask[:, None]
    _paged_scatter(cfg, arenas, k_new, v_new, positions, meta, write)
    kd, vd = _paged_gather(cfg, arenas, meta)
    o = L.prefill_attention_kvmajor(q, kd, vd, starts)
    o = augment.proj(p, "wo", o.reshape(B, C, -1), cfg.amc)
    return o.to(x.dtype)


def mlp_block(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    h = L.rms_norm(x, p["norm"], cfg.norm_eps)
    if "w_up_packed" in p:
        out = augment.ternary_mlp(cfg, p, h)
    elif cfg.act == "swiglu":
        out = (torch.nn.functional.silu(h @ p["w_gate"])
               * (h @ p["w_up"])) @ p["w_down"]
    else:
        out = torch.nn.functional.gelu(h @ p["w_up"],
                                       approximate="tanh") @ p["w_down"]
    return out.to(x.dtype)


def _logits_head(cfg: ModelConfig, params: dict, x: torch.Tensor):
    """Final norm + (tied) LM head."""
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params.get("head")
    if head is None:
        head = params["embed"].T
    return L.lm_head(x, head, cfg.vocab)


def _layer(tree: dict, i: int) -> dict:
    return {k: v[i] for k, v in tree.items()}


def paged_decode_step(cfg: ModelConfig, params: dict, arenas: dict,
                      tokens: torch.Tensor, positions: torch.Tensor,
                      meta: dict):
    """One decode step: tokens (B, 1), positions (B,), `meta` the pool's
    device tables plus write_mask (B,). Returns (logits (B, 1, V), arenas)
    with the arenas updated in place."""
    x = L.embed_lookup(params["embed"], tokens).to(torch.bfloat16)
    layers = params["layers"]
    for i in range(cfg.n_layers):
        x = x + attn_block_decode_paged(cfg, _layer(layers["attn"], i), x,
                                        _layer(arenas, i), positions, meta)
        x = x + mlp_block(cfg, _layer(layers["mlp"], i), x)
    return _logits_head(cfg, params, x), arenas


def paged_prefill_chunk_step(cfg: ModelConfig, params: dict, arenas: dict,
                             tokens: torch.Tensor, starts: torch.Tensor,
                             write_mask: Optional[torch.Tensor], meta: dict):
    """One chunked-prefill dispatch: tokens (B, C) at absolute positions
    starts (B,) + [0, C). Returns (logits (B, C, V), arenas) with the
    arenas updated in place."""
    x = L.embed_lookup(params["embed"], tokens).to(torch.bfloat16)
    layers = params["layers"]
    for i in range(cfg.n_layers):
        x = x + attn_block_prefill_paged(cfg, _layer(layers["attn"], i), x,
                                         _layer(arenas, i), starts,
                                         write_mask, meta)
        x = x + mlp_block(cfg, _layer(layers["mlp"], i), x)
    return _logits_head(cfg, params, x), arenas
