"""Family dispatch: the paged decode / verify / prefill steps of the dense
family, the contiguous decode step of the hybrid family, and each
family's decode-state tree."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import hybrid, transformer
from repro_torch.models.params import PSpec

_TABLE_KEYS = ("page_table", "page_modes")


def _family_mod(cfg: ModelConfig, family: str = "dense"):
    if cfg.family != family:
        raise NotImplementedError(
            f"family {cfg.family!r} has no such step in repro_torch (this "
            f"step serves the {family!r} family)")
    return {"dense": transformer, "hybrid": hybrid}[family]


def abstract_cache(cfg: ModelConfig, batch: int, seq: int) -> dict:
    """The family's decode-state tree at `batch` rows of `seq` tokens (the
    dense family: bf16 K and V of every layer, the logical size of its
    paged cache; the hybrid family: its fixed-size slabs)."""
    if cfg.family == "hybrid":
        return hybrid.abstract_cache(cfg, batch, seq)
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported to repro_torch yet")
    shape = (cfg.n_layers, batch, seq, cfg.n_kv_heads, cfg.hd)
    return {"k": PSpec(shape, init="zeros"), "v": PSpec(shape, init="zeros")}


def decode_step(cfg: ModelConfig, params, cache, batch: dict):
    """Contiguous decode: batch = tokens (B, 1), positions (B,). Returns
    (logits (B, 1, V), new cache)."""
    return _family_mod(cfg, "hybrid").decode_step(
        cfg, params, cache, batch["tokens"], batch["positions"])


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
