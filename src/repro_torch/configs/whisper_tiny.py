"""Whisper-tiny: 4L enc + 4L dec, d=384 6H d_ff=1536 vocab=51865; enc-dec
with the conv frontend a stub (the cross KV over 1500 frames is the
static plane the serving path reads). [arXiv:2212.04356]"""
from repro_torch.configs.base import AMCConfig, EncDecConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,                    # decoder layers
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab=51865,                   # padded to 51968
    act="gelu",
    rope_theta=0.0,                # learned positions in whisper: no RoPE
    encdec=EncDecConfig(n_encoder_layers=4, n_frames=1500, frame_dim=384),
    # the audio family keeps dense bf16 weights whatever weight_mode says
    # (augment_params packs the dense and moe families only), as in the
    # JAX package
    amc=AMCConfig(weight_mode="ternary", kv_mode="int8"),
    source="arXiv:2212.04356",
)
