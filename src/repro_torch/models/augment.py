"""Augmented weight storage: every attention/MLP matmul weight of the
dense model packed to 2-bit trits (4 a byte) plus a per-output-channel
TWN scale (`weight_mode="ternary"`), consumed packed.

`cfg.amc.matmul_impl` picks the consumer: "packed" streams the packed
bytes through `kernels.ops.ternary_matmul`, "dense" takes its plain
dequantize-then-matmul version. The `dual` weight mode and the `imc`
route are not ported yet.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import ternary
from repro_torch.kernels import ops

TERNARY_KEYS = ("wq", "wk", "wv", "wo", "w_up", "w_down", "w_gate")


def _impl_of(amc) -> str:
    impl = "packed" if amc is None else amc.matmul_impl
    if impl not in ("dense", "packed"):
        raise ValueError(f"matmul_impl {impl!r} is not ported "
                         f"(dense | packed)")
    return impl


def ternary_apply(x: torch.Tensor, packed: torch.Tensor,
                  scale: torch.Tensor, amc=None) -> torch.Tensor:
    """x (..., K) @ unpack(packed (K//4, N)) * scale (1, N) -> (..., N)."""
    lead, K = x.shape[:-1], x.shape[-1]
    y = ops.ternary_matmul(x.reshape(-1, K).to(torch.bfloat16), packed,
                           scale, plain=_impl_of(amc) == "dense")
    return y.reshape(*lead, packed.shape[1])


def proj(p: dict, name: str, x: torch.Tensor, amc=None) -> torch.Tensor:
    """x @ p[name], through the packed consumer when the weight is stored
    packed (`{name}_packed` / `{name}_scale`)."""
    if f"{name}_packed" in p:
        return ternary_apply(x, p[f"{name}_packed"], p[f"{name}_scale"],
                             amc=amc)
    return x @ p[name]


def ternary_mlp(cfg: ModelConfig, p: dict, h: torch.Tensor) -> torch.Tensor:
    """MLP with every weight 2-bit packed (h is already normed)."""
    amc = cfg.amc
    if cfg.act == "swiglu":
        mid = F.silu(proj(p, "w_gate", h, amc)) * proj(p, "w_up", h, amc)
    else:
        mid = F.gelu(proj(p, "w_up", h, amc), approximate="tanh")
    return proj(p, "w_down", mid, amc)


def _ternary_pack(w: torch.Tensor):
    """(n, K, N) dense -> (packed (n, K//4, N) uint8, scale (n, 1, N) f32)."""
    t, scale = ternary.ternarize(w.float(), dim=-2)
    packed = torch.stack([ternary.pack_ternary_2bit(t[i])
                          for i in range(t.shape[0])])
    return packed, scale


def is_augmented(params: dict) -> bool:
    attn = params.get("layers", {}).get("attn", {})
    return any(k.endswith("_packed") for k in attn)


def augment_params(cfg: ModelConfig, params: dict) -> dict:
    """Dense parameter tree -> ternary-packed tree (weight_mode="ternary");
    already-packed trees and weight_mode="normal" pass through."""
    mode = cfg.amc.weight_mode
    if mode == "normal" or is_augmented(params):
        return params
    if mode != "ternary":
        raise ValueError(f"weight_mode {mode!r} is not ported "
                         f"(normal | ternary)")
    layers = {}
    for gname, g in params["layers"].items():
        g = dict(g)
        for key in TERNARY_KEYS:
            if key in g:
                g[f"{key}_packed"], g[f"{key}_scale"] = _ternary_pack(
                    g.pop(key))
        layers[gname] = g
    return {**params, "layers": layers}


def dequant_params(cfg: ModelConfig, params: dict) -> dict:
    """Ternary-packed tree -> dense bf16 tree (what the packed weights
    represent, materialized)."""
    if not is_augmented(params):
        return params
    layers = {}
    for gname, g in params["layers"].items():
        g = dict(g)
        for key in [k for k in g if k.endswith("_packed")]:
            name = key[:-len("_packed")]
            packed, scale = g.pop(key), g.pop(f"{name}_scale")
            t = torch.stack([ternary.unpack_ternary_2bit(
                packed[i], packed.shape[1] * 4)
                for i in range(packed.shape[0])])
            g[name] = ternary.ternary_dequant(t, scale)
        layers[gname] = g
    return {**params, "layers": layers}
