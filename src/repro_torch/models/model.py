"""Family dispatch of the paged decode / verify / prefill steps (`dense`
so far)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer

_TABLE_KEYS = ("page_table", "page_modes")


def _family_mod(cfg: ModelConfig):
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported to repro_torch yet")
    return transformer


def paged_decode_step(cfg: ModelConfig, params, arenas, batch: dict):
    """batch: tokens (B, 1), positions (B,), write_mask (B,) and the
    pool's device tables. Returns (logits (B, 1, V), arenas)."""
    meta = {k: v for k, v in batch.items()
            if k not in ("tokens", "positions")}
    return _family_mod(cfg).paged_decode_step(
        cfg, params, arenas, batch["tokens"], batch["positions"], meta)


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
