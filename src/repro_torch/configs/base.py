"""Model configuration: `ModelConfig`, `AMCConfig` and `reduced()`.

The fields and their defaults are those of `repro.configs.base`, so a
config means the same thing in both packages. Only the knobs the port
reads so far are carried in `AMCConfig`; the others (faults, prefix
cache, fleet, observability) arrive with the modules that use them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


def pad_to(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    lru_width: int = 4096
    window: int = 2048            # local attention window (ring KV slots)
    pattern: Tuple[str, ...] = ("rec", "rec", "attn")


@dataclasses.dataclass(frozen=True)
class AMCConfig:
    """Augmented-memory settings for this model instance."""
    weight_mode: str = "normal"     # normal | ternary | dual
    ternary_fmt: str = "2bit"
    kv_mode: str = "normal"         # normal | int4 | int8
    # "kernel": decode attention walks the paged pool in the CUDA kernel;
    # "dequant": gather + dense attention reference, kept for parity tests,
    # the on-card logit check and the speculative draft. The int4 pack
    # runs its kernel under either.
    kv_impl: str = "kernel"         # kernel | dequant
    # "packed": ternary / dual weights go through the CUDA matmul kernels;
    # "dense": the plain dequantize-then-matmul reference; "imc": the dot
    # product is evaluated IN the array, wordline-serial activation bits x
    # bitline-parallel accumulation (kernels/imc_dot.py), billed by the
    # array event model (imc/energy.py). Dense (unpacked) weights have no
    # resident array and stay plain matmuls under "imc".
    matmul_impl: str = "packed"     # dense | packed | imc
    # activation precision of the bit-serial IMC path: 1, 4 or 8 bits
    imc_abits: int = 8
    retention_steps: int = 8
    # tokens per page: the mode-switch granularity of the pool
    page_size: int = 16
    # auto | normal-only | always-augmented | augment-on-pressure
    pool_mode: str = "auto"
    # packed width of an Augmented recurrent-state slab (serve/
    # state_store.py): int8 stores one value a byte, int4 nibble-packs pairs
    state_bits: int = 8
    # promote expired augmented pages back to Normal when the budget has
    # room (augment-on-pressure only); otherwise restamp them in place
    refresh_promote: bool = True
    # -- self-speculative decoding (serve/engine.py) ------------------------
    # Window size: spec_k - 1 tokens are drafted per round from the cheap
    # (dynamic-plane) representation and the whole spec_k-token window is
    # verified in ONE full-path dispatch; greedy accept/rollback keeps the
    # emitted stream token-identical to step-by-step decode. 1 disables.
    spec_k: int = 1
    # Cheap representation the draft pass decodes with: "dequant" reads the
    # pool through the dequantize-then-dense path, "dense"/"packed" force
    # that matmul_impl, "imc1/4/8" drafts through the bit-serial IMC dot at
    # 1/4/8-bit activations (the pool read stays as kv_impl says), "same"
    # drafts with the full config.
    spec_draft_impl: str = "dequant"

    @property
    def aug_bits(self) -> int:
        """Augmented-plane width of the paged pool: follows kv_mode, int8
        when the model itself serves a Normal cache."""
        return 4 if self.kv_mode == "int4" else 8

    @property
    def resolved_pool_mode(self) -> str:
        """``auto`` maps kv_mode onto a pool policy: a normal cache serves
        from Normal pages, a packed cache from Augmented pages."""
        if self.pool_mode == "auto":
            return "normal-only" if self.kv_mode == "normal" \
                else "always-augmented"
        return self.pool_mode


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    act: str = "swiglu"            # swiglu | gelu
    hybrid: Optional[HybridConfig] = None
    amc: AMCConfig = dataclasses.field(default_factory=AMCConfig)
    source: str = ""

    @property
    def hd(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def vocab_padded(self) -> int:
        return pad_to(self.vocab, 256)

    def reduced(self) -> "ModelConfig":
        """Small same-family config for CPU tests (the widths
        `repro.configs.base.ModelConfig.reduced` gives these families)."""
        kw = dict(
            name=self.name + "-reduced",
            family=self.family,
            n_layers=min(self.n_layers, 2),
            d_model=128,
            n_heads=4,
            n_kv_heads=(min(self.n_kv_heads, 4)
                        if self.n_kv_heads < self.n_heads else 4),
            d_ff=256,
            vocab=512,
            head_dim=32,
            qkv_bias=self.qkv_bias,
            act=self.act,
            tie_embeddings=self.tie_embeddings,
            amc=self.amc,
            source=self.source,
        )
        if self.hybrid is not None:
            # one macro-block (rec, rec, attn) and one trailing rec layer
            kw.update(hybrid=HybridConfig(lru_width=128, window=16,
                                          pattern=self.hybrid.pattern),
                      n_layers=4, n_kv_heads=1)
        return ModelConfig(**kw)
