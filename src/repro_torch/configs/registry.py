"""Registry of the architectures the port serves: every arch of the JAX
package's registry."""
from __future__ import annotations

from repro_torch.configs import (granite_3_2b, grok_1_314b,
                                 llama32_vision_11b, mamba2_130m,
                                 minicpm_2b, minitron_8b,
                                 qwen3_moe_30b_a3b, qwen15_0_5b,
                                 recurrentgemma_9b, whisper_tiny)
from repro_torch.configs.base import ModelConfig

ARCHS: dict[str, ModelConfig] = {
    c.name: c for c in [qwen15_0_5b.CONFIG, granite_3_2b.CONFIG,
                        recurrentgemma_9b.CONFIG, mamba2_130m.CONFIG,
                        qwen3_moe_30b_a3b.CONFIG, grok_1_314b.CONFIG,
                        whisper_tiny.CONFIG, llama32_vision_11b.CONFIG,
                        minicpm_2b.CONFIG, minitron_8b.CONFIG]}

# architectures of the JAX package the port does not serve (none left)
NOT_YET_PORTED: tuple[str, ...] = ()


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]
