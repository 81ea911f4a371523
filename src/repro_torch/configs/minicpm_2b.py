"""MiniCPM-2B: 40L d=2304 36H (kv=36, MHA) d_ff=5760 vocab=122753;
llama-like arch trained with the WSD schedule.
[arXiv:2404.06395; hf-verified]"""
from repro_torch.configs.base import AMCConfig, ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,                    # MHA: 36 KV heads, one query head each
    n_kv_heads=36,
    d_ff=5760,
    vocab=122753,                  # padded to 122880
    tie_embeddings=True,
    act="swiglu",
    amc=AMCConfig(weight_mode="dual", kv_mode="int4"),
    source="arXiv:2404.06395",
)
