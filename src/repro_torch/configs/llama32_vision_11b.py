"""Llama-3.2-11B-Vision backbone: 40L (32 self + 8 gated cross-attn)
d=4096 32H (GQA kv=8) d_ff=14336 vocab=128256; the vision frontend a stub
(the patch KV over 1601 patches is the static plane the serving path
reads). [hf:meta-llama/Llama-3.2-11B-Vision]"""
from repro_torch.configs.base import AMCConfig, ModelConfig, VisionConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,                   # 8 macro-blocks of (4 self + 1 cross)
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=128256,
    head_dim=128,
    rope_theta=5e5,
    act="swiglu",
    vision=VisionConfig(cross_attn_every=5, n_cross_layers=8,
                        n_patches=1601, vision_dim=4096),
    # dense bf16 weights whatever weight_mode says (augment_params packs
    # the dense and moe families only), as in the JAX package
    amc=AMCConfig(weight_mode="dual", kv_mode="int4"),
    source="hf:meta-llama/Llama-3.2-11B-Vision",
)
