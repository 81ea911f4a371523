"""Decode-state store registry and step functions (the paged branch of
`repro.serve.state_store`: dense rows on a `PagedKVPool`)."""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.serve.cache_pool import PagedKVPool


def make_store(cfg: ModelConfig, *, max_batch: int, max_seq: int,
               device: torch.device, budget_bytes: Optional[int] = None,
               retention_steps: Optional[int] = None) -> PagedKVPool:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"no decode-state store for family {cfg.family!r} in "
            f"repro_torch yet")
    return PagedKVPool(cfg, max_batch=max_batch, max_seq=max_seq,
                       device=device, budget_bytes=budget_bytes,
                       retention_steps=retention_steps)


def make_step_fns(cfg: ModelConfig) -> dict[str, Callable]:
    """(decode, prefill, verify) callables over (params, arenas, batch);
    ``verify`` is the speculative-decode verify step."""
    return {
        "decode": lambda p, s, b: M.paged_decode_step(cfg, p, s, b),
        "prefill": lambda p, s, b: M.paged_prefill_step(cfg, p, s, b),
        "verify": lambda p, s, b: M.paged_verify_step(cfg, p, s, b),
    }
