"""Mamba2-130M: 24L d=768, attention-free SSD blocks, ssm_state=128,
vocab=50280. [arXiv:2405.21060]"""
from repro_torch.configs.base import AMCConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=0,                     # attention-free
    n_kv_heads=0,
    d_ff=0,                        # no separate MLP; the SSD block holds it
    vocab=50280,                   # padded to 50432
    tie_embeddings=True,
    act="swiglu",
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, n_groups=1,
                  conv_dim=4, chunk=256),
    # the ssm family keeps dense bf16 weights whatever weight_mode says
    # (augment_params packs the dense family only) and has no KV cache,
    # as in the JAX package
    amc=AMCConfig(weight_mode="ternary", kv_mode="normal"),
    source="arXiv:2405.21060",
)
