"""Family dispatch: the paged decode / verify / prefill steps of the
transformer families (dense, moe), the paged decode step of the static-
plane families (audio over the pool's prefix band, vlm beside a patch
slab), the contiguous decode step of the slab families (ssm, hybrid),
and each family's decode-state tree."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, hybrid, ssm, transformer, vision
from repro_torch.models.params import PSpec

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
    transformer families: bf16 K and V of every layer, the logical size of
    their paged cache, with the cross or patch KV of audio and vlm; the
    slab families: their fixed-size slabs)."""
    if cfg.family not in _FAMILY_MODS:
        raise ValueError(f"unknown family {cfg.family!r}")
    if cfg.family not in ("dense", "moe"):
        return _FAMILY_MODS[cfg.family].abstract_cache(cfg, batch, seq)
    shape = (cfg.n_layers, batch, seq, cfg.n_kv_heads, cfg.hd)
    return {"k": PSpec(shape, init="zeros"), "v": PSpec(shape, init="zeros")}


def decode_step(cfg: ModelConfig, params, cache, batch: dict):
    """Contiguous decode: batch = tokens (B, 1), positions (B,). Returns
    (logits (B, 1, V), new cache)."""
    return _family_mod(cfg, ("ssm", "hybrid")).decode_step(
        cfg, params, cache, batch["tokens"], batch["positions"])


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
