"""Parameter declaration and initialization, and the bridge that carries
numpy parameter trees into the port.

`abstract_params(cfg)` declares every leaf once (shape, dtype, init),
with the stacked-layer layouts of the JAX package: the dense and moe
transformers' `layers/<group>/<name>` leaves carry a leading n_layers dim
(`repro.models.transformer`; the moe group's expert banks an expert dim
after it, `repro.models.moe`), the ssm family's `layers/<name>` too
(`repro.models.ssm`), the hybrid family's `blocks/...` and `tail/...` a
leading macro-block / trailing-layer dim (`repro.models.hybrid`), the
audio family's decoder `layers/{attn,cross,mlp}` and encoder
`encoder/...` a leading layer dim (`repro.models.encdec`), the vlm
family's `blocks/self_*` a leading (macro-block, layer) pair and
`blocks/cross*` a leading macro-block dim (`repro.models.vision`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class PSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]   # logical axis a dim (None: replicated)
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"              # normal | zeros | ones

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)

    @property
    def nbytes(self) -> int:
        return math.prod(self.shape) * torch.empty(
            (), dtype=self.dtype).element_size()


def attn_pspecs(cfg: ModelConfig, n: int, qk_norm: bool = False) -> dict:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    attn = {"norm": PSpec((n, d), (None, None), init="zeros"),
            "wq": PSpec((n, d, H * hd), (None, "embed", "heads")),
            "wk": PSpec((n, d, KV * hd), (None, "embed", "kv_heads")),
            "wv": PSpec((n, d, KV * hd), (None, "embed", "kv_heads")),
            "wo": PSpec((n, H * hd, d), (None, "heads", "embed"))}
    if cfg.qkv_bias:
        attn["bq"] = PSpec((n, H * hd), (None, "heads"), init="zeros")
        attn["bk"] = PSpec((n, KV * hd), (None, "kv_heads"), init="zeros")
        attn["bv"] = PSpec((n, KV * hd), (None, "kv_heads"), init="zeros")
    if qk_norm:
        attn["q_norm"] = PSpec((n, hd), (None, None), init="zeros")
        attn["k_norm"] = PSpec((n, hd), (None, None), init="zeros")
    return attn


def mlp_pspecs(cfg: ModelConfig, n: int) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    mlp = {"norm": PSpec((n, d), (None, None), init="zeros"),
           "w_up": PSpec((n, d, f), (None, "embed", "mlp")),
           "w_down": PSpec((n, f, d), (None, "mlp", "embed"))}
    if cfg.act == "swiglu":
        mlp["w_gate"] = PSpec((n, d, f), (None, "embed", "mlp"))
    return mlp


def abstract_params(cfg: ModelConfig) -> dict:
    """Dense master tree (weight_mode="normal") of the model's family."""
    if cfg.family == "hybrid":
        from repro_torch.models import hybrid
        return hybrid.abstract_params(cfg)
    if cfg.family == "ssm":
        from repro_torch.models import ssm
        return ssm.abstract_params(cfg)
    if cfg.family == "audio":
        from repro_torch.models import encdec
        return encdec.abstract_params(cfg)
    if cfg.family == "vlm":
        from repro_torch.models import vision
        return vision.abstract_params(cfg)
    if cfg.family not in ("dense", "moe"):
        raise ValueError(f"unknown family {cfg.family!r}")
    n, d, V = cfg.n_layers, cfg.d_model, cfg.vocab_padded
    if cfg.family == "moe":
        from repro_torch.models import moe
        # qwen3-style q/k norm on the wide-expert configs
        layers = {"attn": attn_pspecs(cfg, n, cfg.moe.n_experts >= 64),
                  "moe": moe.moe_pspecs(cfg, n)}
    else:
        layers = {"attn": attn_pspecs(cfg, n), "mlp": mlp_pspecs(cfg, n)}
    params = {"embed": PSpec((V, d), ("vocab", "embed")),
              "final_norm": PSpec((d,), (None,), init="zeros"),
              "layers": layers}
    if not cfg.tie_embeddings:
        params["head"] = PSpec((d, V), ("embed", "vocab"))
    return params


def _leaves(tree, prefix=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _set(tree: dict, path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def tree_nbytes(tree) -> int:
    """Bytes of a tree of tensors or of `PSpec`s."""
    return sum(v.nbytes if isinstance(v, PSpec)
               else v.numel() * v.element_size() for _, v in _leaves(tree))


def init_params(cfg: ModelConfig, *, seed: int = 0, device=None) -> dict:
    """Random dense parameters from a `torch.Generator` seeded with `seed`,
    made on `device` (CUDA unless the caller asks for another device).
    Normal leaves are N(0, 1) / sqrt(fan_in) with fan_in the product of
    every dim but the last, as `repro.models.params.init_params` draws
    them; norms and biases start at zero (the SSD's `a_log` and `dt_bias`
    too, and vlm's cross gates), the LRU's `lam` and the SSD's `d_skip`
    at one. A MoE expert bank (n, E, K, N) and a vlm block leaf (nb, ...)
    are drawn one slice of the leading dim at a time straight into their
    bf16 leaf: one of qwen3-moe's banks is 38.7 GB in float32, vlm's
    self-MLP leaves 7.5 GB each."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    out: dict = {}
    for path, spec in _leaves(abstract_params(cfg)):
        if spec.init in ("zeros", "ones"):
            w = (torch.zeros if spec.init == "zeros" else torch.ones)(
                spec.shape, dtype=spec.dtype, device=dev)
        else:
            fan = math.prod(spec.shape[:-1]) if len(spec.shape) > 1 \
                else spec.shape[0]
            root = math.sqrt(max(fan, 1))
            if (path[:2] == ("layers", "moe") and len(spec.shape) == 4
                    or cfg.family == "vlm" and path[0] == "blocks"
                    and len(spec.shape) >= 3):
                w = torch.empty(spec.shape, dtype=spec.dtype, device=dev)
                for i in range(spec.shape[0]):
                    w[i] = torch.randn(spec.shape[1:], generator=gen,
                                       device=dev,
                                       dtype=torch.float32) / root
            else:
                w = torch.randn(spec.shape, generator=gen, device=dev,
                                dtype=torch.float32) / root
                w = w.to(spec.dtype)
        _set(out, path, w)
    return out


def _to_tensor(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name in ("bfloat16", "uint16"):
        # numpy has no native bf16: it crosses as 16-bit words
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def from_numpy_tree(tree, device: Optional[torch.device] = None):
    """Nested dict of numpy arrays (for instance the JAX package's dense,
    ternary-packed or dual-packed parameters, `np.asarray`-ed) -> the same
    dict of tensors on `device`. bf16 leaves cross as uint16 (or ml_dtypes
    bfloat16) and are re-viewed as torch.bfloat16; every other dtype keeps
    its type (uint8 packed trits and dual buffers `wkv_buf` /
    `w_gate_up_buf`, float32 scales, ...)."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: from_numpy_tree(v, dev) for k, v in tree.items()}
    return _to_tensor(tree, dev)
