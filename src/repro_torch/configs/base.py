"""Model configuration: `ModelConfig`, `AMCConfig` and `reduced()`.

The fields and their defaults are those of `repro.configs.base`, so a
config means the same thing in both packages. Only the knobs the port
reads are carried in `AMCConfig` (the prefix cache, the retention-fault,
the array fleet's and the observability knobs among them).
`EncDecConfig` and `VisionConfig` size the static plane of the audio and
vlm families: the cross KV over `n_frames` encoder frames, the gated
cross attention over `n_patches` image patches.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


def pad_to(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    # "ep" (experts over the model axis) or "tp" (the expert hidden dim
    # over it): carried for equality with the JAX config; on one card it
    # selects nothing
    sharding: str = "ep"
    # dense FFN interleave (qwen3-moe and grok route every layer)
    shared_expert: bool = False


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 128     # N (ssm_state)
    head_dim: int = 64       # P
    expand: int = 2          # d_inner = expand * d_model
    n_groups: int = 1
    conv_dim: int = 4
    chunk: int = 256         # SSD chunk length


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    lru_width: int = 4096
    window: int = 2048            # local attention window (ring KV slots)
    pattern: Tuple[str, ...] = ("rec", "rec", "attn")


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    cross_attn_every: int = 5     # one cross-attn layer per this many layers
    n_cross_layers: int = 8
    n_patches: int = 1601         # 1 CLS + 40x40 patches (llama-3.2 vision)
    vision_dim: int = 4096        # projected patch embedding dim (stub)


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    n_encoder_layers: int = 4
    n_frames: int = 1500          # whisper 30 s at 50 Hz after the conv stub
    frame_dim: int = 384


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
    # -- shared-prefix page reuse (serve/prefix.py) -------------------------
    # Cached prompt-prefix entries of the engine's PrefixIndex (paged pool
    # only): later requests with the same prefix map the SAME physical
    # pages (refcounted) and prefill only the tail; the first write past
    # the match copies the boundary page. 0: no share band, no index.
    prefix_cache: int = 0
    # -- retention-fault injection & self-healing (core/faults.py) ----------
    # Per-page, per-decode-step probability of an early retention expiry
    # of an Augmented page at the END of its window at 85C (younger pages
    # scale down linearly with age, colder arrays through LeakageModel).
    # 0 (with array_loss_rate 0) attaches no fault model at all.
    fault_rate: float = 0.0
    # seed of the deterministic fault schedule (chaos runs reproduce)
    fault_seed: int = 0
    # per-step probability of a whole-array loss (drain and requeue)
    array_loss_rate: float = 0.0
    # modeled array temperature the fault tails are sampled at
    fault_temp_c: float = 85.0
    # verify integrity words so corrupted pages are detected, never
    # served; off with a nonzero fault_rate is the silent-corruption
    # ablation
    integrity_check: bool = True
    # fault-recovery retries a request may use before it is failed
    max_retries: int = 3
    # detections of the same physical page before it is decommissioned
    # (or, for a share-band page, pinned back to Normal)
    fault_pin_threshold: int = 3
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
    # -- array fleet (serve/fleet.py) ---------------------------------------
    # Logical SRAM arrays the serving stack instantiates: 1 is the single
    # `ServeEngine`; above 1 an `ArrayFleet` runs one engine per array,
    # each with its own byte budget, store, refresh clock, fault domain and
    # energy ledger, over a partition of the CUDA devices (arrays share a
    # device when there are fewer devices than arrays).
    num_arrays: int = 1
    # fleet admission policy (serve/placement.py): least-loaded |
    # budget-headroom | affinity
    placement: str = "least-loaded"
    # -- observability (obs/) ------------------------------------------------
    # Chrome-trace spans and instants of the whole request lifecycle (one
    # perfetto lane a request, plus engine / scheduler / refresh / fault
    # lanes). Off: the engine holds the null facade, whose hooks are
    # constant no-ops.
    trace: bool = False
    # Host-side metrics plane: latency histograms (TTFT, queue wait,
    # inter-token gap, step wall) and sampled series (pool occupancy,
    # Normal/Augmented mode mix, refresh debt, energy-group totals), in
    # stats()["obs"] and exportable as Prometheus text.
    metrics: bool = False
    # sample the series every N engine steps (1 = each step)
    obs_sample_every: int = 1

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
    family: str                    # dense | moe | audio | vlm | ssm | hybrid
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
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    vision: Optional[VisionConfig] = None
    encdec: Optional[EncDecConfig] = None
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

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Supports 500k-token decode (bounded state / windowed attention)."""
        return self.family in ("ssm", "hybrid")

    @property
    def is_encoder_decoder(self) -> bool:
        return self.encdec is not None

    def param_count(self) -> int:
        """Analytic parameter count (for MODEL_FLOPS and capacity tables)."""
        d, v = self.d_model, self.vocab_padded
        n = v * d  # embedding
        if not self.tie_embeddings:
            n += v * d  # lm head
        per_layer = 0
        hd, H, KV = self.hd, self.n_heads, self.n_kv_heads
        attn = d * H * hd + 2 * d * KV * hd + H * hd * d
        ffn_mults = 3 if self.act == "swiglu" else 2
        if self.family == "ssm":
            s = self.ssm
            din = s.expand * d
            per_layer = d * (2 * din) + din * d + din * 2 * s.state_dim
        elif self.family == "hybrid":
            h = self.hybrid
            rec = 2 * d * h.lru_width + h.lru_width * d + 2 * h.lru_width
            att = attn
            npat = len(h.pattern)
            n_att = self.n_layers // npat
            n_rec = self.n_layers - n_att
            per_layer = 0
            n += n_rec * (rec + ffn_mults * d * self.d_ff + 2 * d)
            n += n_att * (att + ffn_mults * d * self.d_ff + 2 * d)
            return n
        elif self.moe is not None:
            per_layer = attn + self.moe.n_experts * ffn_mults * d * self.d_ff
            per_layer += d * self.moe.n_experts  # router
        else:
            per_layer = attn + ffn_mults * d * self.d_ff
        if self.vision is not None:
            cross = d * H * hd + 2 * d * self.n_kv_heads * hd + H * hd * d
            n += self.vision.n_cross_layers * (cross + ffn_mults * d * self.d_ff)
        per_layer += 2 * d  # norms
        n += self.n_layers * per_layer
        if self.encdec is not None:
            enc_layer = attn + ffn_mults * d * self.d_ff + 2 * d
            dec_cross = attn
            n += self.encdec.n_encoder_layers * enc_layer
            n += self.n_layers * dec_cross  # decoder cross-attn blocks
        return int(n)

    def active_param_count(self) -> int:
        """Activated params per token (MoE: only top-k experts count)."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        ffn_mults = 3 if self.act == "swiglu" else 2
        full = self.param_count()
        inactive = (self.moe.n_experts - self.moe.top_k) * ffn_mults * d * self.d_ff
        return int(full - self.n_layers * inactive)

    def nonembed_param_count(self) -> int:
        v, d = self.vocab_padded, self.d_model
        emb = v * d * (1 if self.tie_embeddings else 2)
        return self.param_count() - emb

    def nonembed_active_param_count(self) -> int:
        v, d = self.vocab_padded, self.d_model
        emb = v * d * (1 if self.tie_embeddings else 2)
        return self.active_param_count() - emb

    def model_flops(self, shape: "ShapeConfig") -> float:
        """Analytic useful FLOPs per step (global): 6ND train / 2ND fwd for
        non-embedding active params, plus the LM-head matmul explicitly."""
        tokens = shape.global_batch * (shape.seq_len
                                       if shape.kind != "decode" else 1)
        mult = 6 if shape.kind == "train" else 2
        body = mult * self.nonembed_active_param_count() * tokens
        head = mult * tokens * self.d_model * self.vocab_padded
        return float(body + head)

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
        if self.moe is not None:
            kw.update(moe=dataclasses.replace(self.moe, n_experts=8,
                                              top_k=2), d_ff=64)
        if self.ssm is not None:
            # attention-free: no heads, so hd falls back to d_model
            kw.update(ssm=SSMConfig(state_dim=16, head_dim=16, expand=2,
                                    conv_dim=4, chunk=32),
                      n_heads=0, n_kv_heads=0, head_dim=None)
        if self.hybrid is not None:
            # one macro-block (rec, rec, attn) and one trailing rec layer
            kw.update(hybrid=HybridConfig(lru_width=128, window=16,
                                          pattern=self.hybrid.pattern),
                      n_layers=4, n_kv_heads=1)
        if self.vision is not None:
            # one macro-block: 4 self-attention layers and 1 gated cross
            kw.update(vision=VisionConfig(cross_attn_every=5,
                                          n_cross_layers=1, n_patches=16,
                                          vision_dim=128), n_layers=5)
        if self.encdec is not None:
            kw.update(encdec=EncDecConfig(n_encoder_layers=2, n_frames=16,
                                          frame_dim=128), n_layers=2)
        return ModelConfig(**kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """An input shape: `seq_len` tokens a row, `global_batch` rows, for a
    "train", "prefill" or "decode" step (`repro.configs.base.ShapeConfig`)."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def cell_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether an (arch x shape) cell runs, with a skip reason otherwise."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("full quadratic attention at 524k context: "
                       "skipped per assignment (sub-quadratic archs only)")
    return True, ""
