"""Granite-3.0-2B: 40L d=2048 32H (GQA kv=8) d_ff=8192 vocab=49155.
[hf:ibm-granite/granite-3.0-2b-base; hf-verified]"""
from repro_torch.configs.base import AMCConfig, ModelConfig

CONFIG = ModelConfig(
    name="granite-3-2b",
    family="dense",
    n_layers=40,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab=49155,                   # padded to 49408
    tie_embeddings=True,
    act="swiglu",
    amc=AMCConfig(weight_mode="dual", kv_mode="int4"),
    source="hf:ibm-granite/granite-3.0-2b-base",
)
