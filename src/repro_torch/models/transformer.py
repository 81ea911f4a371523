"""Decoder-only transformer (dense and MoE): the full-sequence forward of
training and prefill, the contiguous prefill -> decode steps, the steps
over the paged Normal/Augmented KV pool, and the contiguous single-token
attention block the hybrid family runs.

The full-sequence side ports `attn_block`, `forward` (each layer under a
remat policy, `_remat`), `_pack_prefill_cache`, the contiguous
`attn_block_prefill`, `prefill_chunk_step`, `decode_step` and
`abstract_cache`: every product of `forward` is a plain torch op, so it
is differentiable and launches no kernel of the port; the contiguous
steps reach kernel 3 (the int4 chunk pack) and kernel 6 (the packed
decode read).

Ports the paged path of `repro.models.transformer`: `_project_qkv` (with
qwen3's q/k norm), `_paged_scatter` (and the `_paged_pack` inside it: one
fused write), `_paged_gather`, the decode, verify and prefill attention
blocks, `mlp_block`, `ffn_dispatch` (the MLP, or the MoE layer of
`models/moe.py`: routed per token in decode steps and verify windows,
in groups of 512 over a prefill chunk's flattened rows, as JAX routes),
`paged_decode_step`, `paged_verify_window_step` and
`paged_prefill_chunk_step`; and `_seq_block` with the contiguous
`attn_block_decode` (the ring KV of `models/hybrid.py`, and the
contiguous cache of `decode_step`). JAX's
`lax.scan` over the stacked layers is a Python loop over the layer index
of the stacked tensors.

Unlike the JAX package, which returns new arrays, the scatter writes the
pool's arenas IN PLACE (each layer's arenas are views of the stacked
tensors the pool owns), so a step returns the same arena dict it was
given; the verify step's commit pass rewrites, in place, the slots its
verify scatter wrote.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as K
from repro_torch.kernels.paged_kv_attention import paged_gather_kv
from repro_torch.models import augment
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod
from repro_torch.models.params import PSpec


def _project_qkv(cfg: ModelConfig, p: dict, x: torch.Tensor, positions, *,
                 fixed_order: bool = True, norm_fixed: bool = True):
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    h = L.rms_norm(x, p["norm"], cfg.norm_eps, fixed_order=norm_fixed)
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
    q, k = q.reshape(B, S, H, hd), k.reshape(B, S, KV, hd)
    if "q_norm" in p:           # qwen3: per-head RMS norm before RoPE
        q = L.rms_norm(q, p["q_norm"], cfg.norm_eps, fixed_order=norm_fixed)
        k = L.rms_norm(k, p["k_norm"], cfg.norm_eps, fixed_order=norm_fixed)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
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
              fixed_order: bool = True,
              norm_fixed: bool = True) -> torch.Tensor:
    """Normed MLP. Dense weights take `x @ w` and the activation with the
    compiled JAX MLP's bf16 roundings (`layers.silu`, `layers.gelu_tanh`).
    `fixed_order=False` (a prefill chunk) keeps the bf16
    products an augmented layer leaves dense on `x @ w`
    (`augment.dense_apply`); decode steps and verify windows take the
    fixed-order GEMM, so their rows get the same bits. `norm_fixed=False`
    (the full-sequence forward) takes torch's mean in the RMS norm
    instead of the fixed pairwise tree (`layers.rms_norm`)."""
    h = L.rms_norm(x, p["norm"], cfg.norm_eps, fixed_order=norm_fixed)
    if "w_up_packed" in p:
        out = augment.ternary_mlp(cfg, p, h)
    elif "w_gate_up_buf" in p:
        out = augment.dual_mlp(cfg, p, h, fixed_order=fixed_order)
    else:
        out = L.mlp(h, p.get("w_gate"), p["w_up"], p["w_down"], cfg.act)
    return out.to(x.dtype)


def ffn_dispatch(cfg: ModelConfig, layer_p: dict, x: torch.Tensor, *,
                 group_size: int = 512, fixed_order: bool = True,
                 norm_fixed: bool = True,
                 rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The layer's FFN: the MoE layer over `group_size`-token routing
    groups when the layer has one (only `rows`' tokens taking capacity
    slots), else `mlp_block`. The MoE layer's router and dense banks
    follow `mlp_block`'s `fixed_order` rule; the tree counts as augmented
    when the layer's attention is packed."""
    if "moe" not in layer_p:
        return mlp_block(cfg, layer_p["mlp"], x, fixed_order=fixed_order,
                         norm_fixed=norm_fixed)
    p = layer_p["moe"]
    h = L.rms_norm(x, p["norm"], cfg.norm_eps, fixed_order=norm_fixed)
    augmented = any(k.endswith(("_packed", "_buf"))
                    for k in layer_p["attn"])
    return moe_mod.moe_ffn(cfg, p, h, group_size=group_size,
                           augmented=augmented, fixed_order=fixed_order,
                           rows=rows)


def _logits_head(cfg: ModelConfig, params: dict, x: torch.Tensor, *,
                 fixed_order: bool = True, norm_fixed: bool = True):
    """Final norm + (tied) LM head. `fixed_order` and `norm_fixed` as
    `mlp_block`'s."""
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps,
                   fixed_order=norm_fixed)
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


def _layer_groups(layers: dict, i: int) -> dict:
    return {g: _layer(t, i) for g, t in layers.items()}


def paged_decode_step(cfg: ModelConfig, params: dict, arenas: dict,
                      tokens: torch.Tensor, positions: torch.Tensor,
                      meta: dict):
    """One decode step: tokens (B, 1), positions (B,), `meta` the pool's
    device tables plus write_mask (B,). Returns (logits (B, 1, V), arenas)
    with the arenas updated in place."""
    x = L.embed_lookup(params["embed"], tokens).to(torch.bfloat16)
    layers = params["layers"]
    for i in range(cfg.n_layers):
        lp = _layer_groups(layers, i)
        x = x + attn_block_decode_paged(cfg, lp["attn"], x,
                                        _layer(arenas, i), positions, meta)
        x = x + ffn_dispatch(cfg, lp, x, group_size=1)
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
        lp = _layer_groups(layers, i)
        a, kv = attn_block_verify_paged(cfg, lp["attn"], x,
                                        _layer(arenas, i), starts, meta)
        x = x + a
        x = x + ffn_dispatch(cfg, lp, x, group_size=1)
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
    (`fixed_order=False`): no decode row has to match a chunk's. A MoE
    layer routes the chunk's B*C rows (those not written too) in groups
    of 512, so a row's output depends on its neighbours, as in JAX."""
    x = L.embed_lookup(params["embed"], tokens).to(torch.bfloat16)
    layers = params["layers"]
    for i in range(cfg.n_layers):
        lp = _layer_groups(layers, i)
        x = x + attn_block_prefill_paged(cfg, lp["attn"], x,
                                         _layer(arenas, i), starts,
                                         write_mask, meta)
        x = x + ffn_dispatch(cfg, lp, x, fixed_order=False,
                             rows=write_mask)
    return _logits_head(cfg, params, x, fixed_order=False), arenas


# ---------------------------------------------------------------------------
# Full forward (train / prefill) and the contiguous prefill -> decode steps
# ---------------------------------------------------------------------------

def attn_block(cfg: ModelConfig, p: dict, x: torch.Tensor,
               positions: torch.Tensor, *, causal: bool = True,
               window: Optional[int] = None, q_chunk: int = 1024):
    """Full-sequence attention block. Returns (out, (k, v)) for the cache
    fill. It takes torch's products and norms (training, prefill):
    nothing here has to match a decode row's bits."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(cfg, p, x, positions, fixed_order=False,
                           norm_fixed=False)
    o = L.attention(q, k, v, causal=causal, window=window, q_chunk=q_chunk)
    o = augment.proj(p, "wo", o.reshape(B, S, -1), cfg.amc,
                     fixed_order=False)
    return o.to(x.dtype), (k, v)


def _save_dots(ctx, op, *args, **kwargs):
    """`dots_with_no_batch_dims_saveable`: keep the outputs of the 2-D
    products, recompute everything else."""
    from torch.utils.checkpoint import CheckpointPolicy
    aten = torch.ops.aten
    if op in (aten.mm.default, aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, policy: str):
    """The layer body under a remat policy: "none" / "everything" keep
    every activation, "nothing" recomputes the whole layer in the
    backward pass, "dots" keeps only the 2-D products' outputs. A
    recomputation runs the same ops on the same inputs, so no policy
    changes a bit of the loss or the gradients."""
    if policy in ("none", "everything"):
        return fn
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)
    if policy == "nothing":
        return lambda *a: checkpoint(fn, *a, use_reentrant=False)
    if policy == "dots":
        ctx = functools.partial(create_selective_checkpoint_contexts,
                                _save_dots)
        return lambda *a: checkpoint(fn, *a, use_reentrant=False,
                                     context_fn=ctx)
    raise ValueError(f"unknown remat_policy {policy!r} (none | dots | "
                     f"nothing | everything)")


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *,
            return_cache: bool = False, remat_policy: str = "dots",
            q_chunk: int = 1024):
    """tokens (B, S) -> float32 logits (B, S, V) [+ the decode cache of
    the S tokens, packed as `abstract_cache` lays it out]. Differentiable:
    every product is a plain torch op (no serving kernel has a backward),
    each layer under `remat_policy`. The norms take torch's mean, not the
    serving steps' fixed-order tree: no invariant binds a train step's
    bits to a decode row's."""
    B, S = tokens.shape
    x = L.embed_lookup(params["embed"], tokens).to(torch.bfloat16)
    positions = torch.arange(S, device=x.device)

    def body(x, lp):
        a, kv = attn_block(cfg, lp["attn"], x, positions, q_chunk=q_chunk)
        x = x + a
        x = x + ffn_dispatch(cfg, lp, x, fixed_order=False,
                             norm_fixed=False)
        return x, (kv if return_cache else None)

    run = _remat(body, remat_policy)
    kvs = []
    for i in range(cfg.n_layers):
        x, kv = run(x, _layer_groups(params["layers"], i))
        kvs.append(kv)
    logits = _logits_head(cfg, params, x, fixed_order=False,
                          norm_fixed=False)
    if return_cache:
        k = torch.stack([kv[0] for kv in kvs])
        v = torch.stack([kv[1] for kv in kvs])
        return logits, _pack_prefill_cache(cfg, (k, v))
    return logits


def _pack_prefill_cache(cfg: ModelConfig, kvs):
    """Stacked per-layer (k, v) (L, B, S, KV, hd) of a forward -> the
    decode cache: bf16 seq-major at kv_mode "normal", else packed
    head-major (L, B, KV, S, .) with per-token scales, the layout
    `ops.packed_kv_attention` streams."""
    k, v = kvs
    mode = cfg.amc.kv_mode
    if mode == "normal":
        return {"k": k, "v": v}
    pack = L.pack_kv_int4 if mode == "int4" else L.pack_kv_int8
    kp, ks = pack(L.to_kvmajor(k))
    vp, vs = pack(L.to_kvmajor(v))
    return {"k": kp, "v": vp, "k_scale": ks, "v_scale": vs}


def attn_block_prefill(cfg: ModelConfig, p: dict, x: torch.Tensor,
                       cache_layer: dict, starts: torch.Tensor,
                       write_mask: Optional[torch.Tensor] = None):
    """Chunked-prefill attention over a contiguous cache: a C-token chunk
    a row at positions starts (B,) + [0, C), written into the (packed)
    cache in one pass and attended exactly against it. Rows where
    `write_mask` (B,) is False keep their cache. At kv int4 the chunk is
    packed by `ops.quantize_pack_kv` (kernel 3 on the card), bit for bit
    `layers.pack_kv_int4`. Returns (out, new cache layer)."""
    B, C, _ = x.shape
    positions = starts[:, None] + torch.arange(C, device=x.device)[None, :]
    q, k_new, v_new = _project_qkv(cfg, p, x, positions, fixed_order=False)
    kv_mode = cfg.amc.kv_mode
    if kv_mode == "normal":
        k_cache = L.update_cache_chunk(cache_layer["k"], k_new, starts,
                                       write_mask)
        v_cache = L.update_cache_chunk(cache_layer["v"], v_new, starts,
                                       write_mask)
        new_cache = {"k": k_cache, "v": v_cache}
        o = L.prefill_attention(q, k_cache, v_cache, starts)
    else:
        if kv_mode == "int4":
            kp, ks = K.quantize_pack_kv(k_new)
            vp, vs = K.quantize_pack_kv(v_new)
            unpack = L.unpack_kv_int4
        elif kv_mode == "int8":
            kp, ks = L.pack_kv_int8(k_new)
            vp, vs = L.pack_kv_int8(v_new)
            unpack = L.unpack_kv_int8
        else:
            raise ValueError(f"unknown kv_mode {kv_mode!r}")

        def put(cache, new):
            # packed caches are head-major (B, KV, S, .)
            return L.update_cache_chunk(cache, L.to_kvmajor(new), starts,
                                        write_mask, axis=1)
        new_cache = {"k": put(cache_layer["k"], kp),
                     "v": put(cache_layer["v"], vp),
                     "k_scale": put(cache_layer["k_scale"], ks),
                     "v_scale": put(cache_layer["v_scale"], vs)}
        kd = unpack(new_cache["k"], new_cache["k_scale"])
        vd = unpack(new_cache["v"], new_cache["v_scale"])
        o = L.prefill_attention_kvmajor(q, kd, vd, starts)
    o = augment.proj(p, "wo", o.reshape(B, C, -1), cfg.amc,
                     fixed_order=False)
    return o.to(x.dtype), new_cache


def _stack_layers(layers: list) -> dict:
    return {k: torch.stack([c[k] for c in layers]) for k in layers[0]}


def decode_step(cfg: ModelConfig, params: dict, cache: dict,
                tokens: torch.Tensor, positions: torch.Tensor):
    """One decode step over the contiguous cache: tokens (B, 1), positions
    (B,). Packed kv modes stream the cache through
    `ops.packed_kv_attention` (kernel 6, kv_impl="kernel"), one launch a
    layer. A MoE layer routes per token (group_size=1), as in the
    serving steps. Returns (logits (B, 1, V), new cache)."""
    x = L.embed_lookup(params["embed"], tokens).to(torch.bfloat16)
    new = []
    for i in range(cfg.n_layers):
        lp = _layer_groups(params["layers"], i)
        a, c = attn_block_decode(cfg, lp["attn"], x, _layer(cache, i),
                                 positions)
        x = x + a
        x = x + ffn_dispatch(cfg, lp, x, group_size=1)
        new.append(c)
    return _logits_head(cfg, params, x), _stack_layers(new)


def prefill_chunk_step(cfg: ModelConfig, params: dict, cache: dict,
                       tokens: torch.Tensor, starts: torch.Tensor,
                       write_mask: Optional[torch.Tensor] = None):
    """One chunked-prefill dispatch over the contiguous cache: tokens
    (B, C) at positions starts (B,) + [0, C). Returns (logits (B, C, V),
    new cache). A MoE layer routes the chunk's B*C rows in groups of 512,
    every row taking capacity, as the JAX step routes them."""
    x = L.embed_lookup(params["embed"], tokens).to(torch.bfloat16)
    new = []
    for i in range(cfg.n_layers):
        lp = _layer_groups(params["layers"], i)
        a, c = attn_block_prefill(cfg, lp["attn"], x, _layer(cache, i),
                                  starts, write_mask)
        x = x + a
        x = x + ffn_dispatch(cfg, lp, x, fixed_order=False)
        new.append(c)
    return (_logits_head(cfg, params, x, fixed_order=False),
            _stack_layers(new))


def abstract_cache(cfg: ModelConfig, batch: int, seq: int) -> dict:
    """The contiguous decode cache of `batch` rows of `seq` tokens:
    seq-major bf16 k / v (L, B, S, KV, hd) at kv_mode "normal"; head-major
    packed (L, B, KV, S, hd // 2 | hd) uint8 (int4) or int8 bytes with
    bf16 scales (L, B, KV, S, 1) otherwise, the layout
    `ops.packed_kv_attention` streams with no transpose."""
    n, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    mode = cfg.amc.kv_mode
    if mode == "normal":
        shape = (n, batch, seq, KV, hd)
        return {"k": PSpec(shape, init="zeros"),
                "v": PSpec(shape, init="zeros")}
    if mode not in ("int4", "int8"):
        raise ValueError(f"unknown kv_mode {mode!r}")
    dt = torch.uint8 if mode == "int4" else torch.int8
    d_store = hd // 2 if mode == "int4" else hd
    packed = PSpec((n, batch, KV, seq, d_store), dt, init="zeros")
    scale = PSpec((n, batch, KV, seq, 1), init="zeros")
    return {"k": packed, "v": packed, "k_scale": scale, "v_scale": scale}
