"""Parameter declaration and initialization, and the bridge that carries
numpy parameter trees into the port.

`abstract_params(cfg)` declares every leaf once (shape, dtype, init),
with the stacked-layer layouts of the JAX package: the dense transformer's
`layers/<group>/<name>` leaves carry a leading n_layers dim
(`repro.models.transformer`), the hybrid family's `blocks/...` and
`tail/...` a leading macro-block / trailing-layer dim
(`repro.models.hybrid`).
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
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"              # normal | zeros | ones

    @property
    def nbytes(self) -> int:
        return math.prod(self.shape) * torch.empty(
            (), dtype=self.dtype).element_size()


def attn_pspecs(cfg: ModelConfig, n: int) -> dict:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    attn = {"norm": PSpec((n, d), init="zeros"),
            "wq": PSpec((n, d, H * hd)),
            "wk": PSpec((n, d, KV * hd)),
            "wv": PSpec((n, d, KV * hd)),
            "wo": PSpec((n, H * hd, d))}
    if cfg.qkv_bias:
        attn["bq"] = PSpec((n, H * hd), init="zeros")
        attn["bk"] = PSpec((n, KV * hd), init="zeros")
        attn["bv"] = PSpec((n, KV * hd), init="zeros")
    return attn


def mlp_pspecs(cfg: ModelConfig, n: int) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    mlp = {"norm": PSpec((n, d), init="zeros"),
           "w_up": PSpec((n, d, f)),
           "w_down": PSpec((n, f, d))}
    if cfg.act == "swiglu":
        mlp["w_gate"] = PSpec((n, d, f))
    return mlp


def abstract_params(cfg: ModelConfig) -> dict:
    """Dense master tree (weight_mode="normal") of the model's family."""
    if cfg.family == "hybrid":
        from repro_torch.models import hybrid
        return hybrid.abstract_params(cfg)
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported to repro_torch yet")
    n, d, V = cfg.n_layers, cfg.d_model, cfg.vocab_padded
    params = {"embed": PSpec((V, d)),
              "final_norm": PSpec((d,), init="zeros"),
              "layers": {"attn": attn_pspecs(cfg, n),
                         "mlp": mlp_pspecs(cfg, n)}}
    if not cfg.tie_embeddings:
        params["head"] = PSpec((d, V))
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
    them; norms and biases start at zero, the LRU's `lam` at one."""
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
            w = torch.randn(spec.shape, generator=gen, device=dev,
                            dtype=torch.float32) / math.sqrt(max(fan, 1))
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
