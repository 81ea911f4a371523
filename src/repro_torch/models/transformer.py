"""Decoder-only dense transformer over the paged Normal/Augmented KV pool,
and the contiguous single-token attention block the hybrid family runs.

Ports the paged path of `repro.models.transformer`: `_project_qkv`,
`_paged_scatter` (and the `_paged_pack` inside it: one fused write),
`_paged_gather`, the decode, verify and prefill attention blocks,
`mlp_block`, `paged_decode_step`, `paged_verify_window_step` and
`paged_prefill_chunk_step`; and `_seq_block` with the contiguous
`attn_block_decode` (the ring KV of `models/hybrid.py`). JAX's
`lax.scan` over the stacked layers is a Python loop over the layer index
of the stacked tensors.

Unlike the JAX package, which returns new arrays, the scatter writes the
pool's arenas IN PLACE (each layer's arenas are views of the stacked
tensors the pool owns), so a step returns the same arena dict it was
given; the verify step's commit pass rewrites, in place, the slots its
verify scatter wrote.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as K
from repro_torch.kernels.paged_kv_attention import paged_gather_kv
from repro_torch.models import augment
from repro_torch.models import layers as L


def _project_qkv(cfg: ModelConfig, p: dict, x: torch.Tensor, positions, *,
                 fixed_order: bool = True):
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    h = L.rms_norm(x, p["norm"], cfg.norm_eps)
    q = augment.proj(p, "wq", h, cfg.amc, fixed_order=fixed_order)
    if "wkv_buf" in p:
        # dual-plane: wk (high nibble) + wv (low nibble) share ONE uint8
        # buffer, one read for both products
        k, v = augment.dual_apply(h, p["wkv_buf"], p["wk_scale"],
                                  p["wv_scale"], amc=cfg.amc)
    else:
        k = augment.proj(p, "wk", h, cfg.amc, fixed_order=fixed_order)
        v = augment.proj(p, "wv", h, cfg.amc, fixed_order=fixed_order)
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = L.apply_rope(q.reshape(B, S, H, hd), positions, cfg.rope_theta)
    k = L.apply_rope(k.reshape(B, S, KV, hd), positions, cfg.rope_theta)
    return q, k, v.reshape(B, S, KV, hd)


def _seq_block(S: int, bs: int = 512) -> int:
    """Largest divisor of S that is <= `bs`: the sequence block of the
    packed attention kernel (S % bs == 0). S=2048 -> 512, S=16 -> 16."""
    for b in range(min(bs, S), 0, -1):
        if S % b == 0:
            return b
    return 1


def attn_block_decode(cfg: ModelConfig, p: dict, x: torch.Tensor,
                      cache_layer: dict, positions: torch.Tensor,
                      window: Optional[int] = None):
    """Single-token attention against a contiguous (ring, with `window`)
    KV cache. kv_mode "normal" keeps seq-major bf16 k/v (B, S, KV, hd);
    "int4" / "int8" keep head-major packed k/v (B, KV, S, hd//2 | hd) with
    per-token scales (B, KV, S, 1), streamed by `ops.packed_kv_attention`
    (kv_impl="kernel") or dequantized for dense attention
    (kv_impl="dequant"). The new token lands in slot positions % window.
    Returns (out, new cache layer); the cache is updated functionally."""
    B = x.shape[0]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q, k_new, v_new = _project_qkv(cfg, p, x, positions[:, None])
    kv_mode = cfg.amc.kv_mode
    slot = positions % window if window is not None else positions
    if kv_mode == "normal":
        k_cache = L.update_cache_line(cache_layer["k"], k_new, slot)
        v_cache = L.update_cache_line(cache_layer["v"], v_new, slot)
        new_cache = {"k": k_cache, "v": v_cache}
        o = L.decode_attention(q, k_cache, v_cache, positions, window=window)
    else:
        if kv_mode == "int4":
            pack, unpack, kv_bits = L.pack_kv_int4, L.unpack_kv_int4, 4
        elif kv_mode == "int8":
            pack, unpack, kv_bits = L.pack_kv_int8, L.unpack_kv_int8, 8
        else:
            raise ValueError(f"unknown kv_mode {kv_mode!r}")
        kp, ks = pack(k_new)                                # (B, 1, KV, .)
        vp, vs = pack(v_new)

        def write(c, new):
            return L.update_cache_line(c, L.to_kvmajor(new), slot, axis=1)
        k_cache = write(cache_layer["k"], kp)
        v_cache = write(cache_layer["v"], vp)
        k_scale = write(cache_layer["k_scale"], ks)
        v_scale = write(cache_layer["v_scale"], vs)
        new_cache = {"k": k_cache, "v": v_cache,
                     "k_scale": k_scale, "v_scale": v_scale}
        # valid slots = positions + 1 (the token just written included);
        # a ring runs past its capacity and the kernel clamps to S
        lengths = positions + 1
        if cfg.amc.kv_impl == "kernel":
            S = k_cache.shape[2]
            qk = q[:, 0].reshape(B, KV, H // KV, hd)
            o = K.packed_kv_attention(qk, k_cache, v_cache, k_scale[..., 0],
                                      v_scale[..., 0], lengths,
                                      bs=_seq_block(S), kv_bits=kv_bits)
            o = o.reshape(B, 1, H, hd)
        elif cfg.amc.kv_impl == "dequant":
            kd = unpack(k_cache, k_scale)
            vd = unpack(v_cache, v_scale)
            o = L.decode_attention_kvmajor(q, kd, vd, positions,
                                           window=window)
        else:
            raise ValueError(f"unknown kv_impl {cfg.amc.kv_impl!r}")
    o = augment.proj(p, "wo", o.reshape(B, 1, -1), cfg.amc)
    return o.to(x.dtype), new_cache


def _paged_scatter(cfg: ModelConfig, arenas: dict, k_new: torch.Tensor,
                   v_new: torch.Tensor, pos: torch.Tensor, meta: dict,
                   write: torch.Tensor, commit=None) -> dict:
    """Scatter per-token KV rows (B, T, KV, hd) at absolute positions pos
    (B, T) into the plane each token's page is in, IN PLACE, through the
    fused paged write (`ops.paged_kv_write`: one launch for K and V on the
    card). Tokens with write == False are redirected to physical page 0,
    the write-dump page, so the other rows' pages stay bit-identical.

    `commit` (B, T) bool, optional: the speculative accept mask. Tokens
    with commit == False are WRITTEN at their slot as zeros (zero bf16
    rows in the Normal plane, zero bytes and a unit scale in the
    Augmented plane): the rejected tail of a draft window is scrubbed.
    The Augmented plane packs to int4 or int8 under either kv_impl
    (kv_impl picks the attention read only, as in the JAX package)."""
    K.paged_kv_write(arenas["kn"], arenas["vn"], arenas["kp"], arenas["vp"],
                     arenas["ks"], arenas["vs"], k_new, v_new, pos, write,
                     commit, meta["page_table"], meta["page_modes"],
                     page_size=cfg.amc.page_size,
                     policy=cfg.amc.resolved_pool_mode,
                     aug_bits=cfg.amc.aug_bits)
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


def attn_block_verify_paged(cfg: ModelConfig, p: dict, x: torch.Tensor,
                            arenas: dict, starts: torch.Tensor, meta: dict):
    """Speculative-verify attention: x (B, W, d) is the window [last
    committed token, W - 1 drafts] at positions starts + [0, W). The
    window's full-quality KV is scattered over whatever the draft pass
    wrote, then each slot attends causally (slot w sees the tokens
    < starts + w + 1) through the `paged_kv_attention_window` kernel
    (kv_impl="kernel") or the gathered cache. Also returns the window's
    (k, v) for the commit pass."""
    B, W, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    positions = starts[:, None] + torch.arange(W, device=x.device)[None, :]
    q, k_new, v_new = _project_qkv(cfg, p, x, positions)
    # near the cache end a row's window is host-capped (write_mask False
    # past the cap); clamp those dump-bound slots into the table
    max_s = meta["page_table"].shape[1] * cfg.amc.page_size
    pos_w = positions.clamp(max=max_s - 1)
    _paged_scatter(cfg, arenas, k_new, v_new, pos_w, meta,
                   meta["write_mask"])
    if cfg.amc.kv_impl == "kernel":
        qk = q.reshape(B, W, KV, H // KV, hd).permute(0, 2, 1, 3, 4)
        o = K.paged_kv_attention_window(
            qk, arenas["kn"], arenas["vn"], arenas["kp"], arenas["vp"],
            arenas["ks"], arenas["vs"], starts, meta["page_table"],
            meta["page_modes"], kv_bits=cfg.amc.aug_bits)
        o = o.permute(0, 2, 1, 3, 4).reshape(B, W, H, hd)
    elif cfg.amc.kv_impl == "dequant":
        kd, vd = _paged_gather(cfg, arenas, meta)
        o = L.prefill_attention_kvmajor(q, kd, vd, starts)
    else:
        raise ValueError(f"unknown kv_impl {cfg.amc.kv_impl!r}")
    o = augment.proj(p, "wo", o.reshape(B, W, -1), cfg.amc)
    return o.to(x.dtype), (k_new, v_new)


def attn_block_prefill_paged(cfg: ModelConfig, p: dict, x: torch.Tensor,
                             arenas: dict, starts: torch.Tensor,
                             write_mask: Optional[torch.Tensor], meta: dict):
    """Chunked-prefill attention: the chunk's KV is scattered across the
    pages (and modes) the page table assigns, then attended exactly
    against the gathered logical cache."""
    B, C, _ = x.shape
    positions = starts[:, None] + torch.arange(C, device=x.device)[None, :]
    q, k_new, v_new = _project_qkv(cfg, p, x, positions, fixed_order=False)
    write = torch.ones((B, C), dtype=torch.bool, device=x.device)
    if write_mask is not None:
        write = write & write_mask[:, None]
    _paged_scatter(cfg, arenas, k_new, v_new, positions, meta, write)
    kd, vd = _paged_gather(cfg, arenas, meta)
    o = L.prefill_attention_kvmajor(q, kd, vd, starts)
    o = augment.proj(p, "wo", o.reshape(B, C, -1), cfg.amc,
                     fixed_order=False)
    return o.to(x.dtype)


def mlp_block(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
              fixed_order: bool = True) -> torch.Tensor:
    """Normed MLP. `fixed_order=False` (a prefill chunk) keeps the bf16
    products an augmented layer leaves dense on `x @ w`
    (`augment.dense_apply`); decode steps and verify windows take the
    fixed-order GEMM, so their rows get the same bits."""
    h = L.rms_norm(x, p["norm"], cfg.norm_eps)
    if "w_up_packed" in p:
        out = augment.ternary_mlp(cfg, p, h)
    elif "w_gate_up_buf" in p:
        out = augment.dual_mlp(cfg, p, h, fixed_order=fixed_order)
    elif cfg.act == "swiglu":
        out = (torch.nn.functional.silu(h @ p["w_gate"])
               * (h @ p["w_up"])) @ p["w_down"]
    else:
        out = torch.nn.functional.gelu(h @ p["w_up"],
                                       approximate="tanh") @ p["w_down"]
    return out.to(x.dtype)


def _logits_head(cfg: ModelConfig, params: dict, x: torch.Tensor, *,
                 fixed_order: bool = True):
    """Final norm + (tied) LM head. `fixed_order` as `mlp_block`'s."""
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    aug = augment.is_augmented(params)
    head = params.get("head")
    if head is None:        # tied: the embedding (V_pad, d) read in place
        y = augment.dense_apply(x, params["embed"], cfg.amc, augmented=aug,
                                layout="nk", fixed_order=fixed_order)
    else:
        y = augment.dense_apply(x, head, cfg.amc, augmented=aug,
                                fixed_order=fixed_order)
    return L.lm_head(y, cfg.vocab)


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


def paged_verify_window_step(cfg: ModelConfig, params: dict, arenas: dict,
                             tokens: torch.Tensor, starts: torch.Tensor,
                             meta: dict):
    """Speculative verify dispatch: tokens (B, W) = [last committed token,
    W - 1 drafted tokens] at positions starts + [0, W), `meta` the pool's
    device tables plus write_mask (B, W).

    Recomputes the window through the full path, greedily accepts on the
    device the longest draft prefix matching its own argmax, and commits
    exactly the accepted tokens' KV: a second pass over all layers
    rewrites the window's slots, the rejected tail as zeros through the
    paged write's commit mask. Returns (logits (B, W, V), arenas); the
    host replays the same argmax acceptance on the logits for its
    bookkeeping."""
    B, W = tokens.shape
    x = L.embed_lookup(params["embed"], tokens).to(torch.bfloat16)
    layers = params["layers"]
    wmask = meta["write_mask"]
    kvs = []
    for i in range(cfg.n_layers):
        a, kv = attn_block_verify_paged(cfg, _layer(layers["attn"], i), x,
                                        _layer(arenas, i), starts, meta)
        x = x + a
        x = x + mlp_block(cfg, _layer(layers["mlp"], i), x)
        kvs.append(kv)
    logits = _logits_head(cfg, params, x)                   # (B, W, V)
    # greedy acceptance: slot 0 follows the committed last token, so at
    # least one verify output is always emitted; n_acc - 1 drafts matched
    # the full path's own argmax
    v = logits.argmax(dim=-1).to(tokens.dtype)
    mism = torch.cat([tokens[:, 1:] != v[:, :-1],
                      torch.ones((B, 1), dtype=torch.bool,
                                 device=tokens.device)], dim=1)
    n_acc = mism.to(torch.uint8).argmax(dim=1) + 1          # (B,) in [1, W]
    ar = torch.arange(W, device=tokens.device)
    accept = (ar[None, :] < n_acc[:, None]) & wmask
    max_s = meta["page_table"].shape[1] * cfg.amc.page_size
    pos_w = (starts[:, None] + ar[None, :]).clamp(max=max_s - 1)
    for i, (k_l, v_l) in enumerate(kvs):
        _paged_scatter(cfg, _layer(arenas, i), k_l, v_l, pos_w, meta, wmask,
                       commit=accept)
    return logits, arenas


def paged_prefill_chunk_step(cfg: ModelConfig, params: dict, arenas: dict,
                             tokens: torch.Tensor, starts: torch.Tensor,
                             write_mask: Optional[torch.Tensor], meta: dict):
    """One chunked-prefill dispatch: tokens (B, C) at absolute positions
    starts (B,) + [0, C). Returns (logits (B, C, V), arenas) with the
    arenas updated in place. Its unpaired bf16 products stay on `x @ w`
    (`fixed_order=False`): no decode row has to match a chunk's."""
    x = L.embed_lookup(params["embed"], tokens).to(torch.bfloat16)
    layers = params["layers"]
    for i in range(cfg.n_layers):
        x = x + attn_block_prefill_paged(cfg, _layer(layers["attn"], i), x,
                                         _layer(arenas, i), starts,
                                         write_mask, meta)
        x = x + mlp_block(cfg, _layer(layers["mlp"], i), x,
                          fixed_order=False)
    return _logits_head(cfg, params, x, fixed_order=False), arenas
