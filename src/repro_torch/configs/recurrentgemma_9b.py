"""RecurrentGemma-9B: 38L d=4096 16H (MQA kv=1) d_ff=12288 vocab=256000;
RG-LRU + local attention, pattern (rec, rec, attn). 38 layers = 12 macro-
blocks of 3 + 2 trailing recurrent layers. [arXiv:2402.19427]"""
from repro_torch.configs.base import AMCConfig, HybridConfig, ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,                  # MQA
    d_ff=12288,
    vocab=256000,
    head_dim=256,                  # gemma-style wide heads
    tie_embeddings=True,
    act="gelu",
    hybrid=HybridConfig(lru_width=4096, window=2048,
                        pattern=("rec", "rec", "attn")),
    # the hybrid family keeps dense bf16 weights whatever weight_mode
    # says (augment_params packs the dense family only), as in the JAX
    # package
    amc=AMCConfig(weight_mode="dual", kv_mode="int4"),
    source="arXiv:2402.19427",
)
