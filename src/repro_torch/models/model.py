"""Family dispatch: the full-sequence forward and loss and the contiguous
decode step of all six families (dense, moe, ssm, hybrid, audio, vlm),
the contiguous chunked prefill of the transformer families (dense, moe),
their paged decode / verify / prefill steps, the paged decode step of the
static-plane families (audio over the pool's prefix band, vlm beside a
patch slab), and each family's decode-state tree."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, hybrid, ssm, transformer, vision

_TABLE_KEYS = ("page_table", "page_modes")


_FAMILY_MODS = {"dense": transformer, "moe": transformer, "audio": encdec,
                "vlm": vision, "ssm": ssm, "hybrid": hybrid}


def _family_mod(cfg: ModelConfig, families=("dense", "moe")):
    if cfg.family not in families:
        raise NotImplementedError(
            f"family {cfg.family!r} has no such step in repro_torch (this "
            f"step serves the {'/'.join(families)} family)")
    return _FAMILY_MODS[cfg.family]


def abstract_cache(cfg: ModelConfig, batch: int, seq: int) -> dict:
    """The family's decode-state tree at `batch` rows of `seq` tokens (the
    transformer families: the contiguous cache of `decode_step`, bf16 K
    and V at kv_mode "normal", packed head-major at int4 / int8; audio
    and vlm: their K and V with the cross or patch KV; the slab families:
    their fixed-size slabs)."""
    if cfg.family not in _FAMILY_MODS:
        raise ValueError(f"unknown family {cfg.family!r}")
    return _FAMILY_MODS[cfg.family].abstract_cache(cfg, batch, seq)


_ALL = tuple(_FAMILY_MODS)


def forward(cfg: ModelConfig, params, batch: dict, *, return_cache=False,
            remat_policy="dots", q_chunk=1024):
    """batch: {"tokens": (B, S)}, with "frames" (B, n_frames, frame_dim)
    for audio and "patches" (B, n_patches, vision_dim) for vlm -> float32
    logits (B, S, V) [+ the family's decode cache of the S tokens]."""
    mod = _family_mod(cfg, _ALL)
    kw = dict(return_cache=return_cache, remat_policy=remat_policy,
              q_chunk=q_chunk)
    if cfg.family == "audio":
        return mod.forward(cfg, params, batch["tokens"], batch["frames"],
                           **kw)
    if cfg.family == "vlm":
        return mod.forward(cfg, params, batch["tokens"], batch["patches"],
                           **kw)
    return mod.forward(cfg, params, batch["tokens"], **kw)


def loss_fn(cfg: ModelConfig, params, batch: dict, *, remat_policy="dots",
            q_chunk=1024) -> torch.Tensor:
    """Next-token cross-entropy, mean over (B, S): logsumexp(logits) minus
    the target's logit. The JAX package reads the target logit as
    <logits, one_hot(target)> over the vocab; every other product there is
    a zero (the padded slots hold -1e30, not -inf), so the gather gives
    the same value without the (B, S, V) float32 one-hot."""
    logits = forward(cfg, params, batch, remat_policy=remat_policy,
                     q_chunk=q_chunk)
    targets = batch["targets"].long()
    lse = torch.logsumexp(logits, dim=-1)                       # (B, S)
    tgt = logits.gather(-1, targets[..., None])[..., 0]
    return (lse - tgt).mean()


def decode_step(cfg: ModelConfig, params, cache, batch: dict):
    """Contiguous decode: batch = tokens (B, 1), positions (B,). Returns
    (logits (B, 1, V), new cache)."""
    return _family_mod(cfg, _ALL).decode_step(
        cfg, params, cache, batch["tokens"], batch["positions"])


def supports_prefill(cfg: ModelConfig) -> bool:
    """Whether the family has a chunked-prefill step over its contiguous
    cache (the transformer families); the others prefill token by token."""
    return hasattr(_FAMILY_MODS.get(cfg.family), "prefill_chunk_step")


def prefill_step(cfg: ModelConfig, params, cache, batch: dict):
    """Chunked prefill over the contiguous cache: batch = tokens (B, C),
    positions (B,) each row's chunk start, write_mask (B,) optional.
    Returns (logits (B, C, V), new cache) in one dispatch."""
    if not supports_prefill(cfg):
        raise NotImplementedError(
            f"family {cfg.family!r} has no chunked prefill")
    return _FAMILY_MODS[cfg.family].prefill_chunk_step(
        cfg, params, cache, batch["tokens"], batch["positions"],
        batch.get("write_mask"))


def paged_decode_step(cfg: ModelConfig, params, arenas, batch: dict):
    """batch: tokens (B, 1), positions (B,), write_mask (B,) and the
    pool's device tables (with audio's cross_* band tables, or vlm's
    dense patch_k / patch_v). Returns (logits (B, 1, V), arenas)."""
    meta = {k: v for k, v in batch.items()
            if k not in ("tokens", "positions")}
    mod = _family_mod(cfg, ("dense", "moe", "audio", "vlm"))
    return mod.paged_decode_step(cfg, params, arenas, batch["tokens"],
                                 batch["positions"], meta)


def paged_verify_step(cfg: ModelConfig, params, arenas, batch: dict):
    """Speculative verify over the paged pool: batch carries the window
    tokens (B, W), the windows' start positions (B,), a 2-D write_mask
    (B, W) capping each row's window, and the pool's device tables.
    Returns (logits (B, W, V), arenas) with only each window's accepted
    prefix committed."""
    meta = {k: v for k, v in batch.items()
            if k not in ("tokens", "positions")}
    return _family_mod(cfg).paged_verify_window_step(
        cfg, params, arenas, batch["tokens"], batch["positions"], meta)


def paged_prefill_step(cfg: ModelConfig, params, arenas, batch: dict):
    """batch: tokens (B, C), positions (B,) chunk starts, write_mask (B,)
    and the pool's device tables. Returns (logits (B, C, V), arenas)."""
    return _family_mod(cfg).paged_prefill_chunk_step(
        cfg, params, arenas, batch["tokens"], batch["positions"],
        batch.get("write_mask"), {k: batch[k] for k in _TABLE_KEYS})
