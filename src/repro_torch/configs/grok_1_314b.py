"""Grok-1 314B: 64L d=6144 48H (GQA kv=8) d_ff=32768, 8 experts top-2.
[hf:xai-org/grok-1; unverified]

628 GB of bf16 weights: served at its reduced size only. Its router
(N = 8 experts) is below the fixed-order GEMM's 64-column tile, so its
decode steps run on the CPU's plain route, not the card's kernels."""
from repro_torch.configs.base import AMCConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=32768,
    vocab=131072,
    head_dim=128,
    act="swiglu",                  # grok's gated 3-matrix expert MLP
    moe=MoEConfig(n_experts=8, top_k=2, capacity_factor=1.25, sharding="tp"),
    amc=AMCConfig(weight_mode="dual", kv_mode="int8"),
    source="hf:xai-org/grok-1",
)
