"""Registry of the architectures the port serves so far."""
from __future__ import annotations

from repro_torch.configs import granite_3_2b, qwen15_0_5b, recurrentgemma_9b
from repro_torch.configs.base import ModelConfig

ARCHS: dict[str, ModelConfig] = {
    c.name: c for c in [qwen15_0_5b.CONFIG, granite_3_2b.CONFIG,
                        recurrentgemma_9b.CONFIG]}

# architectures of the JAX package that later slices of the port bring
NOT_YET_PORTED = ("qwen3-moe-30b-a3b", "grok-1-314b", "whisper-tiny",
                  "minitron-8b", "minicpm-2b",
                  "llama-3.2-vision-11b", "mamba2-130m")


def get_arch(name: str) -> ModelConfig:
    if name in ARCHS:
        return ARCHS[name]
    if name in NOT_YET_PORTED:
        raise KeyError(f"arch {name!r} is not ported to repro_torch yet; "
                       f"ported: {sorted(ARCHS)}")
    raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
