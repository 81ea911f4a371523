"""Qwen3-30B-A3B: 48L d=2048 32H (GQA kv=4) moe_d_ff=768, 128 experts top-8.
[hf:Qwen/Qwen3-30B-A3B; hf-verified]"""
from repro_torch.configs.base import AMCConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=768,                      # per-expert MoE intermediate size
    vocab=151936,
    head_dim=128,                  # qwen3 uses explicit head_dim 128
    rope_theta=1e6,
    act="swiglu",
    moe=MoEConfig(n_experts=128, top_k=8, capacity_factor=1.25,
                  sharding="ep"),
    amc=AMCConfig(weight_mode="dual", kv_mode="int4"),
    source="hf:Qwen/Qwen3-30B-A3B",
)
