"""Augmented weight storage: the paper's 7T/8T cells applied to the
dense model's matmul weights, consumed packed.

  weight_mode="ternary"  every attention/MLP matmul weight becomes 2-bit
                         trits (4 a byte) plus a per-output-channel TWN
                         scale; matmuls go through `ops.ternary_matmul`.
  weight_mode="dual"     naturally paired weights share ONE uint8 buffer
                         as two int4 planes (the 8T dual-bit cell): wk
                         (high nibble) + wv (low nibble), and w_gate +
                         w_up; `ops.dual_plane_matmul` reads each byte
                         once for both products. Unpaired weights (wq,
                         wo, w_down) stay dense bf16.

`cfg.amc.matmul_impl` picks the consumer: "packed" streams the packed
bytes through the CUDA matmul kernels, "dense" takes their plain
dequantize-then-matmul versions, "imc" evaluates the dot product in the
array, bit-serially at `cfg.amc.imc_abits` activation bits
(`ops.imc_dot` / `ops.imc_dual_dot`). On the packed route the bf16
weights an augmented model keeps dense (dual mode's wq, wo, w_down, and
the tied head of either mode) go through the port's fixed-order GEMM
(`ops.dense_matmul`) in decode steps and verify windows, like the
packed ones: a row's bits then do not depend on how many rows a call
has, so a verify window gives the bits of the decode steps it replaces.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import quant, ternary
from repro_torch.kernels import ops

TERNARY_KEYS = ("wq", "wk", "wv", "wo", "w_up", "w_down", "w_gate")
DUAL_PAIRS = ((("wk", "wv"), "wkv_buf"),
              (("w_gate", "w_up"), "w_gate_up_buf"))


def _impl_of(amc) -> str:
    impl = "packed" if amc is None else amc.matmul_impl
    if impl not in ("dense", "packed", "imc"):
        raise ValueError(f"unknown matmul_impl {impl!r} (dense | packed | "
                         f"imc)")
    return impl


def ternary_apply(x: torch.Tensor, packed: torch.Tensor,
                  scale: torch.Tensor, amc=None) -> torch.Tensor:
    """x (..., K) @ unpack(packed (K//4, N)) * scale (1, N) -> (..., N)."""
    impl = _impl_of(amc)
    lead, K = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, K).to(torch.bfloat16)
    if impl == "imc":
        y = ops.imc_dot(x2, packed, scale, fmt="ternary",
                        abits=amc.imc_abits)
    else:
        y = ops.ternary_matmul(x2, packed, scale, plain=impl == "dense")
    return y.reshape(*lead, packed.shape[1])


def dual_apply(x: torch.Tensor, buf: torch.Tensor, hi_scale: torch.Tensor,
               lo_scale: torch.Tensor, amc=None):
    """x (..., K) @ BOTH int4 planes of buf (K, N): one read of the
    buffer, two results ((..., N), (..., N))."""
    impl = _impl_of(amc)
    lead, K = x.shape[:-1], x.shape[-1]
    N = buf.shape[1]
    x2 = x.reshape(-1, K).to(torch.bfloat16)
    if impl == "imc":
        # one wordline-serial activation stream drives both planes
        y_hi, y_lo = ops.imc_dual_dot(x2, buf, hi_scale, lo_scale,
                                      abits=amc.imc_abits)
    else:
        y_hi, y_lo = ops.dual_plane_matmul(x2, buf, hi_scale, lo_scale,
                                           plain=impl == "dense")
    return y_hi.reshape(*lead, N), y_lo.reshape(*lead, N)


def dense_apply(x: torch.Tensor, w: torch.Tensor, amc=None, *,
                augmented: bool, layout: str = "kn",
                fixed_order: bool = True) -> torch.Tensor:
    """x @ w (w (K, N)), or x @ w.T for layout "nk" (w (N, K), the tied
    head's embedding): the port's fixed-order GEMM for a weight left dense
    in an `augmented` tree on the packed route, `x @ w` otherwise.

    `fixed_order=False` (a prefill chunk) keeps `x @ w` there too: a
    chunk's rows never have to match a decode step's, and the chunk then
    gives the plain route's bits. Granite's int4 KV turns any one-ulp
    change of these products into a different first chunk (PERF.md: 0.21
    of the logits through the kernel, 0.19 through torch.matmul itself on
    the rows cut in halves)."""
    kernel = augmented and fixed_order and _impl_of(amc) == "packed"
    return ops.dense_matmul(x, w, layout=layout, plain=not kernel)


def proj(p: dict, name: str, x: torch.Tensor, amc=None, *,
         fixed_order: bool = True) -> torch.Tensor:
    """x @ p[name], through the packed consumer when the weight is stored
    packed (`{name}_packed` / `{name}_scale`), through `dense_apply` when
    it stays dense beside packed ones in the same layer."""
    if f"{name}_packed" in p:
        return ternary_apply(x, p[f"{name}_packed"], p[f"{name}_scale"],
                             amc=amc)
    augmented = any(k.endswith(("_packed", "_buf")) for k in p)
    return dense_apply(x, p[name], amc, augmented=augmented,
                       fixed_order=fixed_order)


def ternary_mlp(cfg: ModelConfig, p: dict, h: torch.Tensor) -> torch.Tensor:
    """MLP with every weight 2-bit packed (h is already normed)."""
    amc = cfg.amc
    if cfg.act == "swiglu":
        mid = F.silu(proj(p, "w_gate", h, amc)) * proj(p, "w_up", h, amc)
    else:
        mid = F.gelu(proj(p, "w_up", h, amc), approximate="tanh")
    return proj(p, "w_down", mid, amc)


def dual_mlp(cfg: ModelConfig, p: dict, h: torch.Tensor, *,
             fixed_order: bool = True) -> torch.Tensor:
    """swiglu MLP with w_gate + w_up sharing one dual-plane buffer."""
    gate, up = dual_apply(h, p["w_gate_up_buf"], p["w_gate_scale"],
                          p["w_up_scale"], amc=cfg.amc)
    return dense_apply(F.silu(gate) * up, p["w_down"], cfg.amc,
                       augmented=True, fixed_order=fixed_order)


def _ternary_pack(w: torch.Tensor):
    """(n, K, N) dense -> (packed (n, K//4, N) uint8, scale (n, 1, N) f32)."""
    t, scale = ternary.ternarize(w.float(), dim=-2)
    packed = torch.stack([ternary.pack_ternary_2bit(t[i])
                          for i in range(t.shape[0])])
    return packed, scale


def _dual_pack(w_hi: torch.Tensor, w_lo: torch.Tensor):
    """Two (n, K, N) dense weights -> one (n, K, N) uint8 buffer and the
    planes' (n, 1, N) f32 scales (int4 per output channel, quantized in
    float32 along K, as `repro.models.augment._dual_pack`)."""
    qh, sh = quant.quantize_int4(w_hi.float(), dim=-2)
    ql, sl = quant.quantize_int4(w_lo.float(), dim=-2)
    return quant.pack_int4_pair(qh, ql), sh, sl


def is_augmented(params: dict) -> bool:
    attn = params.get("layers", {}).get("attn", {})
    return "wkv_buf" in attn or any(k.endswith("_packed") for k in attn)


def augment_params(cfg: ModelConfig, params: dict) -> dict:
    """Dense parameter tree -> augmented storage per cfg.amc.weight_mode
    (ternary or dual); already-packed trees, weight_mode="normal" and
    families other than the dense transformer (the hybrid family keeps
    dense bf16 weights, as in the JAX package) pass through."""
    mode = cfg.amc.weight_mode
    if mode == "normal" or cfg.family != "dense" or is_augmented(params):
        return params
    if mode not in ("ternary", "dual"):
        raise ValueError(f"unknown weight_mode {mode!r} "
                         f"(normal | ternary | dual)")
    layers = {}
    for gname, g in params["layers"].items():
        g = dict(g)
        if mode == "ternary":
            for key in TERNARY_KEYS:
                if key in g:
                    g[f"{key}_packed"], g[f"{key}_scale"] = _ternary_pack(
                        g.pop(key))
        else:
            for (hi, lo), buf_key in DUAL_PAIRS:
                if hi in g and lo in g:
                    g[buf_key], g[f"{hi}_scale"], g[f"{lo}_scale"] = \
                        _dual_pack(g.pop(hi), g.pop(lo))
        layers[gname] = g
    return {**params, "layers": layers}


def dequant_params(cfg: ModelConfig, params: dict) -> dict:
    """Augmented tree -> dense bf16 tree (what the packed weights
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
        for (hi, lo), buf_key in DUAL_PAIRS:
            if buf_key in g:
                buf = g.pop(buf_key)
                g[hi] = quant.dequantize(quant.unpack_int4_hi(buf),
                                         g.pop(f"{hi}_scale"))
                g[lo] = quant.dequantize(quant.unpack_int4_lo(buf),
                                         g.pop(f"{lo}_scale"))
        layers[gname] = g
    return {**params, "layers": layers}
