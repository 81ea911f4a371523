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
from repro_torch.distributed.sharding import (constrain_spec, is_dtensor,
                                              replicate, spec_placements)
from repro_torch.models import augment
from repro_torch.models import layers as L
from repro_torch.models.params import PSpec


def moe_pspecs(cfg: ModelConfig, n: int) -> dict:
    d, f, E = cfg.d_model, cfg.d_ff, cfg.moe.n_experts
    ea = "experts"
    # EP: experts ride the model axis, so the hidden dim must not claim it
    # too; TP: experts replicate (Rules' sizes), the hidden dim rides it
    fa = "mlp" if cfg.moe.sharding == "tp" else None
    p = {"norm": PSpec((n, d), (None, None), init="zeros"),
         "router": PSpec((n, d, E), (None, "embed", None)),
         "w_up": PSpec((n, E, d, f), (None, ea, "embed", fa)),
         "w_down": PSpec((n, E, f, d), (None, ea, fa, "embed"))}
    if cfg.act == "swiglu":
        p["w_gate"] = PSpec((n, E, d, f), (None, ea, "embed", fa))
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


def _dispatch(xs: torch.Tensor, top_i, pos, keep, E: int,
              C: int) -> torch.Tensor:
    """Slot (e, g, c) gathers its token, or the zero row sg: xs (G, sg,
    d) -> xe (E, G * C, d), groups major within an expert."""
    G, sg, d = xs.shape
    k = top_i.shape[-1]
    tok = torch.arange(sg, device=xs.device)[None, :, None].expand(G, sg, k)
    col = torch.where(keep, pos, C).long()     # dropped: the spare column
    slot = torch.full((G, E * (C + 1)), sg, dtype=torch.long,
                      device=xs.device)
    slot.scatter_(1, (top_i * (C + 1) + col).reshape(G, sg * k),
                  tok.reshape(G, sg * k))
    slot = slot.reshape(G, E, C + 1)[..., :C]
    xs_pad = torch.cat([xs, xs.new_zeros((G, 1, d))], dim=1)
    xe = xs_pad[torch.arange(G, device=xs.device)[:, None, None],
                slot]                                       # (G, E, C, d)
    return xe.permute(1, 0, 2, 3).reshape(E, G * C, d)


def _combine(ye: torch.Tensor, top_i, gates, pos, keep, G: int,
             C: int) -> torch.Tensor:
    """ye (E, G * C, d) -> (G, sg, d) float32: each token's kept slots
    times their gates, added in ascending expert order."""
    E, d = ye.shape[0], ye.shape[-1]
    k = top_i.shape[-1]
    g_idx = torch.arange(G, device=ye.device)[:, None]
    row = (top_i * G + g_idx[..., None]) * C + torch.where(keep, pos, 0)
    gate = torch.where(keep, gates, torch.zeros_like(gates)).float()
    terms = ye.reshape(E * G * C, d)[row].float() * gate[..., None]
    out = terms[..., 0, :]
    for j in range(1, k):
        out = out + terms[..., j, :]
    return out


def _expert_ffn(cfg: ModelConfig, p: dict, xe, *, augmented: bool,
                fixed_order: bool, between=lambda t: t):
    """The expert FFN over every expert's slots, xe (E, M, d) -> (E, M,
    d); `between` constrains the hidden activations (the sharded
    route)."""
    amc = cfg.amc
    kw = dict(augmented=augmented, fixed_order=fixed_order)
    if cfg.act == "swiglu":
        h = L.silu(augment.expert_proj(p, "w_gate", xe, amc, **kw)) \
            * augment.expert_proj(p, "w_up", xe, amc, **kw)
    else:
        h = L.gelu_tanh(augment.expert_proj(p, "w_up", xe, amc, **kw))
    return augment.expert_proj(p, "w_down", between(h), amc, **kw)


def moe_ffn(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
            group_size: int = 512, augmented: bool = False,
            fixed_order: bool = True,
            rows: Optional[torch.Tensor] = None, rules=None) -> torch.Tensor:
    """x (B, S, d) pre-normed -> (B, S, d). Tokens are grouped in the
    flattened (B, S) order, `group_size` a group (the JAX package's
    groups). `augmented` (the layer's other weights are packed) and
    `fixed_order` (a decode step or verify window, not a prefill chunk)
    pick the router's and the dense banks' product, as
    `augment.dense_apply` picks a dense weight's. `rows` (B,) bool,
    optional: only these rows' tokens take capacity slots (the others
    get zeros), so a prefill chunk's written row does not compete with
    the pad tokens of the rows it shares the dispatch with. A DTensor x
    with `rules` takes the sharded route (`_moe_ffn_sharded`)."""
    if rules is not None and is_dtensor(x):
        return _moe_ffn_sharded(cfg, p, x, rules, group_size=group_size,
                                augmented=augmented, fixed_order=fixed_order,
                                rows=rows)
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
    xe = _dispatch(xs, top_i, pos, keep, E, C)
    ye = _expert_ffn(cfg, p, xe, augmented=augmented,
                     fixed_order=fixed_order)            # (E, G*C, d)
    out = _combine(ye, top_i, gates, pos, keep, G, C)
    return out.reshape(B, S, d).to(x.dtype)


def _best_axes(n: int, sizes: dict, preferred):
    """Largest prefix of `preferred` mesh axes whose product divides n."""
    axes = [a for a in preferred if a in sizes]
    while axes:
        t = 1
        for a in axes:
            t *= sizes[a]
        if n % t == 0:
            return tuple(axes)
        axes.pop()
    return None


def _moe_ffn_sharded(cfg: ModelConfig, p: dict, x, rules, *,
                     group_size: int, augmented: bool, fixed_order: bool,
                     rows=None):
    """`moe_ffn` on a DTensor x, the GShard layout of the JAX layer: the
    routing groups ride ("pod", "data") only (`_best_axes`), the experts
    the "experts" axis (EP), or in TP mode (experts replicated) the
    expert hidden dim rides "mlp". Routing, dispatch and combine have no
    DTensor sharding strategy (sort, scatter, gathers by index), and a
    group's routing needs only its own tokens, so each rank routes,
    dispatches and combines its own groups on its local shard (the
    router replicated); the expert products run on DTensors: the
    dispatched slots are sliced over the experts' axis, and gathered
    back over it for the combine."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    moe = cfg.moe
    B, S, d = x.shape
    E, k = moe.n_experts, moe.top_k
    T = B * S
    sg = min(group_size, T)
    G = T // sg
    if T % sg:
        raise ValueError(f"{T} tokens do not split into groups of {sg}")
    C = max(1, math.ceil(sg * k * moe.capacity_factor / E))
    mesh = x.device_mesh
    g_ax = _best_axes(G, rules.axis_sizes, ("pod", "data"))
    e_ax = rules.resolve("experts")
    f_ax = None if e_ax is not None else rules.resolve("mlp")
    at = lambda spec: spec_placements(mesh, spec)          # noqa: E731
    xs = constrain_spec(x.reshape(G, sg, d), (g_ax, None, None))
    xl = xs.to_local()                                      # my groups
    # the router's gradient from my groups only: partial over the group
    # axes, the same on the others
    names = mesh.mesh_dim_names
    router = replicate(p["router"]).to_local(grad_placements=[
        Partial() if g_ax and names[i] in g_ax else Replicate()
        for i in range(mesh.ndim)])
    valid = None
    if rows is not None:
        valid = replicate(rows).to_local()[:, None].expand(B, S).reshape(
            G, sg)
        valid = DTensor.from_local(valid, mesh, [Replicate()] * mesh.ndim)
        valid = constrain_spec(valid, (g_ax, None)).to_local()
    top_i, gates, pos, keep = route(cfg, {"router": router}, xl,
                                    augmented=augmented,
                                    fixed_order=fixed_order, valid=valid)
    xe = DTensor.from_local(_dispatch(xl, top_i, pos, keep, E, C), mesh,
                            at((None, g_ax, None)))
    xe = constrain_spec(xe, (e_ax, g_ax, None))
    ye = _expert_ffn(cfg, p, xe, augmented=augmented,
                     fixed_order=fixed_order,
                     between=lambda h: constrain_spec(h, (e_ax, g_ax, f_ax)))
    ye = constrain_spec(ye, (None, g_ax, None)).to_local()
    out = _combine(ye, top_i, gates, pos, keep, xl.shape[0], C)
    out = DTensor.from_local(out, mesh, at((g_ax, None, None)))
    return out.reshape(B, S, d).to(x.dtype)
