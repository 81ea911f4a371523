"""LR schedules: cosine and WSD (warmup-stable-decay, MiniCPM's schedule).

Computed in float32 tensors, op for op as `repro.optim.schedule` computes
them in `jnp` (Python's float64 `math` would round differently). `step`
may be a Python int or a tensor (the train state's step, on the device):
the result is a 0-d float32 tensor on the step's device.
"""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(step, dtype=torch.float32)


def cosine(step, *, peak_lr: float, warmup: int, total: int,
           final_frac: float = 0.1) -> torch.Tensor:
    step = _f32(step)
    warm = peak_lr * step / max(warmup, 1)
    prog = torch.clip((step - warmup) / max(total - warmup, 1), 0, 1)
    cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi
                                                               * prog))
    return torch.where(step < warmup, warm, peak_lr * cos)


def wsd(step, *, peak_lr: float, warmup: int, total: int,
        decay_frac: float = 0.1, final_frac: float = 0.01) -> torch.Tensor:
    """Warmup-Stable-Decay (MiniCPM): flat plateau, sharp final decay."""
    step = _f32(step)
    decay_start = total * (1 - decay_frac)
    warm = peak_lr * step / max(warmup, 1)
    prog = torch.clip((step - decay_start) / max(total - decay_start, 1),
                      0, 1)
    log_final = torch.log(torch.tensor(final_frac, dtype=torch.float32,
                                       device=step.device))
    dec = peak_lr * torch.exp(log_final * prog)
    out = torch.where(step < warmup, warm,
                      torch.full_like(step, peak_lr))
    return torch.where(step > decay_start, dec, out)


SCHEDULES = {"cosine": cosine, "wsd": wsd}
