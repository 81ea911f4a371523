"""Minitron-8B (pruned Nemotron): 32L d=4096 32H (GQA kv=8) d_ff=16384
vocab=256000. [arXiv:2407.14679; hf-verified]"""
from repro_torch.configs.base import AMCConfig, ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=16384,
    vocab=256000,
    head_dim=128,
    act="swiglu",                  # squared-relu in paper; swiglu param-equiv
    amc=AMCConfig(weight_mode="dual", kv_mode="int4"),
    source="arXiv:2407.14679",
)
