"""Registry of the architectures the port serves so far."""
from __future__ import annotations

from repro_torch.configs import (granite_3_2b, grok_1_314b,
                                 llama32_vision_11b, mamba2_130m,
                                 qwen3_moe_30b_a3b, qwen15_0_5b,
                                 recurrentgemma_9b, whisper_tiny)
from repro_torch.configs.base import ModelConfig

ARCHS: dict[str, ModelConfig] = {
    c.name: c for c in [qwen15_0_5b.CONFIG, granite_3_2b.CONFIG,
                        recurrentgemma_9b.CONFIG, mamba2_130m.CONFIG,
                        qwen3_moe_30b_a3b.CONFIG, grok_1_314b.CONFIG,
                        whisper_tiny.CONFIG, llama32_vision_11b.CONFIG]}

# architectures of the JAX package that later slices of the port bring
NOT_YET_PORTED = ("minitron-8b", "minicpm-2b")


def get_arch(name: str) -> ModelConfig:
    if name in ARCHS:
        return ARCHS[name]
    if name in NOT_YET_PORTED:
        raise KeyError(f"arch {name!r} is not ported to repro_torch yet; "
                       f"ported: {sorted(ARCHS)}")
    raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
