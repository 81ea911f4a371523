"""Mixture-of-Experts FFN with GShard-style capacity dispatch: the port of
`repro.models.moe` without its mesh code (one card has no axis to shard
experts or groups over; `MoEConfig.sharding` selects nothing here).

Top-k routing with a per-(group, expert) capacity C = ceil(sg*k*cf/E);
tokens over capacity are dropped, as in the JAX package. The router's
logits, the softmax, top-k and the renormalised top-k probabilities are
float32; the gates are taken to bf16 where JAX builds its combine tensor.

The JAX layer moves tokens with one-hot einsums: dispatch
"gsec,gsd->egcd" and combine "egcd,gsec->gsd". Each dispatch slot holds at
most one token, so the port's gather (empty slots read a zero row) is
that einsum bit for bit. The combine sums each token's kept gate x
expert output in ascending expert order, in float32, then casts once to
bf16: elementwise per token, so a row's bits do not depend on how many
rows the call has (decode steps and verify windows route per token,
group_size=1, and must give the same bits).

One departure from the JAX package: a prefill chunk computes every row of
the dispatch but writes one, and only the written rows' tokens take
capacity slots here (`rows`). In the JAX package the other rows' pad
tokens compete for the same slots, so a request's prefill depends on
what its neighbours hold, and a speculative run and a stepwise run,
whose neighbours differ when a request is admitted, can part (the JAX
tests pick prompt seeds around it, tests/test_faults.py:132-137).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import augment
from repro_torch.models import layers as L
from repro_torch.models.params import PSpec


def moe_pspecs(cfg: ModelConfig, n: int) -> dict:
    d, f, E = cfg.d_model, cfg.d_ff, cfg.moe.n_experts
    p = {"norm": PSpec((n, d), init="zeros"),
         "router": PSpec((n, d, E)),
         "w_up": PSpec((n, E, d, f)),
         "w_down": PSpec((n, E, f, d))}
    if cfg.act == "swiglu":
        p["w_gate"] = PSpec((n, E, d, f))
    return p


def route(cfg: ModelConfig, p: dict, xs: torch.Tensor, *,
          augmented: bool = False, fixed_order: bool = True,
          valid: Optional[torch.Tensor] = None):
    """xs (G, sg, d) -> the routing decisions of each token: top_i (G, sg,
    k) expert ids ascending, their gates (G, sg, k) in bf16, pos (G, sg,
    k) each token's slot in its expert's capacity, keep (G, sg, k) bool
    (pos < C). Tokens where `valid` (G, sg) is False take no slot and
    keep nothing. The router product is the fixed-order GEMM with float32
    output where the other dense products of an augmented tree take it
    (`augment.dense_apply`'s rule), float32 `x @ w` elsewhere."""
    moe = cfg.moe
    G, sg, d = xs.shape
    E, k = moe.n_experts, moe.top_k
    C = max(1, math.ceil(sg * k * moe.capacity_factor / E))
    logits = augment.dense_apply(xs.reshape(G * sg, d), p["router"],
                                 cfg.amc, augmented=augmented,
                                 fixed_order=fixed_order,
                                 out_dtype=torch.float32)
    probs = torch.softmax(logits.reshape(G, sg, E), dim=-1)
    # top-k as `jax.lax.top_k`: of equal probabilities the lower expert
    # id first (a stable descending sort; torch.topk leaves ties open)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[..., :k], top_i[..., :k]
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    # position-in-expert within each group: a token's count of earlier
    # tokens routed to the same expert
    mask = torch.zeros((G, sg, E), dtype=torch.int32, device=xs.device)
    mask.scatter_(-1, top_i, 1)
    if valid is not None:
        mask *= valid[..., None]
    pos_e = mask.cumsum(dim=1) - 1                          # (G, sg, E)
    top_i, order = top_i.sort(dim=-1)
    gates = top_p.gather(-1, order).to(torch.bfloat16)
    pos = pos_e.gather(-1, top_i)
    keep = pos < C
    if valid is not None:
        keep &= valid[..., None]
    return top_i, gates, pos, keep


def moe_ffn(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
            group_size: int = 512, augmented: bool = False,
            fixed_order: bool = True,
            rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (B, S, d) pre-normed -> (B, S, d). Tokens are grouped in the
    flattened (B, S) order, `group_size` a group (the JAX package's
    groups). `augmented` (the layer's other weights are packed) and
    `fixed_order` (a decode step or verify window, not a prefill chunk)
    pick the router's and the dense banks' product, as
    `augment.dense_apply` picks a dense weight's. `rows` (B,) bool,
    optional: only these rows' tokens take capacity slots (the others
    get zeros), so a prefill chunk's written row does not compete with
    the pad tokens of the rows it shares the dispatch with."""
    moe = cfg.moe
    B, S, d = x.shape
    E, k = moe.n_experts, moe.top_k
    T = B * S
    sg = min(group_size, T)
    G = T // sg
    if T % sg:
        raise ValueError(f"{T} tokens do not split into groups of {sg}")
    C = max(1, math.ceil(sg * k * moe.capacity_factor / E))
    xs = x.reshape(G, sg, d)
    valid = None if rows is None else rows[:, None].expand(B, S).reshape(
        G, sg)
    top_i, gates, pos, keep = route(cfg, p, xs, augmented=augmented,
                                    fixed_order=fixed_order, valid=valid)

    # --- dispatch: slot (e, g, c) gathers its token, or the zero row sg ---
    tok = torch.arange(sg, device=x.device)[None, :, None].expand(G, sg, k)
    col = torch.where(keep, pos, C).long()     # dropped: the spare column
    slot = torch.full((G, E * (C + 1)), sg, dtype=torch.long,
                      device=x.device)
    slot.scatter_(1, (top_i * (C + 1) + col).reshape(G, sg * k),
                  tok.reshape(G, sg * k))
    slot = slot.reshape(G, E, C + 1)[..., :C]
    xs_pad = torch.cat([xs, xs.new_zeros((G, 1, d))], dim=1)
    xe = xs_pad[torch.arange(G, device=x.device)[:, None, None],
                slot]                                       # (G, E, C, d)
    xe = xe.permute(1, 0, 2, 3).reshape(E, G * C, d)

    # --- the expert FFN over every expert's slots ---
    amc = cfg.amc
    kw = dict(augmented=augmented, fixed_order=fixed_order)
    if cfg.act == "swiglu":
        h = L.silu(augment.expert_proj(p, "w_gate", xe, amc, **kw)) \
            * augment.expert_proj(p, "w_up", xe, amc, **kw)
    else:
        h = L.gelu_tanh(augment.expert_proj(p, "w_up", xe, amc, **kw))
    ye = augment.expert_proj(p, "w_down", h, amc, **kw)     # (E, G*C, d)

    # --- combine: ascending expert, float32, one cast ---
    g_idx = torch.arange(G, device=x.device)[:, None]
    row = (top_i * G + g_idx[..., None]) * C + torch.where(keep, pos, 0)
    gate = torch.where(keep, gates, torch.zeros_like(gates)).float()
    terms = ye.reshape(E * G * C, d)[row].float() * gate[..., None]
    out = terms[..., 0, :]
    for j in range(1, k):
        out = out + terms[..., j, :]
    return out.reshape(B, S, d).to(x.dtype)
