"""Train, prefill and decode steps: the port of `repro.train.step`.

`make_train_step` returns a function of (TrainState, batch) that runs the
forward and loss under autograd (every product a plain torch op: no
serving kernel has a backward, and on a dense master tree none is
launched), accumulates gradients over `grad_accum` microbatches in
float32 as the JAX step's scan does, and applies the optimizer, whose
update writes the parameters and moments in place.

With `rules` (`distributed.sharding.Rules` on a DeviceMesh) the same
steps run on DTensor parameters, optimizer state and batches: the
forward and loss under the rules' constraints, the gradients at the
parameters' placements. The spec builders (`param_pspecs`,
`param_shardings`, `opt_abstract`, `batch_pspecs`, `cache_pspecs`) give
each leaf its logical axes' placements, as the JAX module's give their
NamedShardings.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed.sharding import (Rules, dtensor_mode,
                                              is_dtensor, local_shard)
from repro_torch.models import model as M
from repro_torch.models.params import PSpec
from repro_torch.optim import adamw
from repro_torch.tree import flatten, tree_map, unflatten


@dataclasses.dataclass(frozen=True)
class TrainSettings:
    optimizer: str = "adamw"        # adamw | amc_adamw
    lr: float = 3e-4
    weight_decay: float = 0.1
    remat_policy: str = "nothing"   # none | dots | nothing (full remat)
    q_chunk: int = 1024
    grad_accum: int = 1


# ---------------------------------------------------------------------------
# Spec builders
# ---------------------------------------------------------------------------

def param_pspecs(abstract, rules: Rules):
    """The pspec tuple of every `PSpec` leaf."""
    return tree_map(lambda l: rules.pspec(*l.axes), abstract)


def param_shardings(abstract, rules: Rules):
    """The DTensor placements of every `PSpec` leaf on `rules.mesh`."""
    return tree_map(lambda l: rules.placements(*l.axes), abstract)


def distribute(tree, abstract, rules: Rules):
    """Each tensor of `tree` (the same on every rank) distributed at its
    `PSpec`'s placements: every rank keeps its shard."""
    return tree_map(lambda t, l: local_shard(t, rules.mesh,
                                             rules.pspec(*l.axes)),
                    tree, abstract)


def opt_abstract(abstract_params, kind: str):
    """PSpec tree of the optimizer state, mirroring the parameters'
    sharding: AdamW's moments take the parameter's axes, AMC-Adam's int8
    moments too and its per-row scales the axes but the last."""
    if kind == "adamw":
        f32 = lambda l: PSpec(l.shape, l.axes, torch.float32, "zeros")
        return adamw.AdamState(
            step=PSpec((), (), torch.int32, "zeros"),
            m=tree_map(f32, abstract_params),
            v=tree_map(f32, abstract_params))
    q = lambda l: PSpec(l.shape, l.axes, torch.int8, "zeros")
    s = lambda l: PSpec(tuple(l.shape[:-1]) + (1,), tuple(l.axes[:-1])
                        + (None,), torch.float32, "zeros")
    return adamw.AMCAdamState(
        step=PSpec((), (), torch.int32, "zeros"),
        m_q=tree_map(q, abstract_params),
        m_scale=tree_map(s, abstract_params),
        v_q=tree_map(q, abstract_params),
        v_scale=tree_map(s, abstract_params))


def batch_pspecs(cfg: ModelConfig, shape: ShapeConfig, rules: Rules):
    specs = {}
    b = rules.resolve("batch")
    if shape.kind == "train":
        specs["tokens"] = (b, None)
        specs["targets"] = (b, None)
    elif shape.kind == "prefill":
        specs["tokens"] = (b, None)
    else:
        specs["tokens"] = (b, None)
        specs["positions"] = (b,)
    if cfg.encdec is not None:
        specs["frames"] = (b, None, None)
    if cfg.vision is not None:
        specs["patches"] = (b, None, None)
    return specs


def cache_pspecs(cfg: ModelConfig, shape: ShapeConfig, rules: Rules):
    return param_pspecs(M.abstract_cache(cfg, shape.global_batch,
                                         shape.seq_len), rules)


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------

class TrainState(NamedTuple):
    params: dict
    opt: object
    step: torch.Tensor


def value_and_grad(loss_fn, params, *args):
    """(loss, grads) of loss_fn(params, *args) with respect to every leaf
    of the params tree; each gradient has its parameter's dtype."""
    leaves, treedef = flatten(params)
    leaves = [p.detach().requires_grad_(True) for p in leaves]
    with torch.enable_grad():
        loss = loss_fn(unflatten(treedef, leaves), *args)
        grads = torch.autograd.grad(loss, leaves)
    grads = [_at_placements(g, p) for g, p in zip(grads, leaves)]
    return loss.detach(), unflatten(treedef, grads)


def _at_placements(g, p):
    """A DTensor gradient at its parameter's placements: partial sums
    across ranks (a contraction over data-parallel rows) are added in
    float32 and rounded once to the gradient's dtype, so the optimizer
    sees each rank's shard of the whole gradient."""
    if not is_dtensor(g) or tuple(g.placements) == tuple(p.placements):
        return g
    return g.float().redistribute(p.device_mesh, p.placements).to(g.dtype)


def accumulated_grads(loss_fn, params, batch: dict, n: int):
    """(loss, grads) of the batch as `n` microbatches: one
    `value_and_grad` at n <= 1, else the microbatches' grads summed in
    float32 in order and divided by n (the JAX step's scan), so the live
    activations are one microbatch's. Every key of the batch is split
    along its rows (tokens, targets, and the audio / vlm families'
    frames / patches)."""
    if n <= 1:
        return value_and_grad(loss_fn, params, batch)
    micro = {k: t.reshape((n, t.shape[0] // n) + t.shape[1:])
             for k, t in batch.items()}
    gacc, lacc = None, 0.0
    for i in range(n):
        l, g = value_and_grad(loss_fn, params,
                              {k: t[i] for k, t in micro.items()})
        g = tree_map(lambda x: x.to(torch.float32), g)
        gacc = g if gacc is None else tree_map(torch.add, gacc, g)
        lacc = lacc + l
    return lacc / n, tree_map(lambda g: g / n, gacc)


def make_train_step(cfg: ModelConfig, settings: TrainSettings,
                    rules: Rules = None, lr_fn=None):
    """With `rules`, the state and batch are DTensors and the loss comes
    back replicated."""
    _, opt_update = adamw.make_optimizer(settings.optimizer)

    def loss(p, b):
        return M.loss_fn(cfg, p, b, rules=rules,
                         remat_policy=settings.remat_policy,
                         q_chunk=settings.q_chunk)

    def train_step(state: TrainState, batch: dict):
        with dtensor_mode(rules):
            lval, grads = accumulated_grads(loss, state.params, batch,
                                            settings.grad_accum)
            lr = settings.lr if lr_fn is None else lr_fn(state.step)
            new_p, new_opt = opt_update(grads, state.opt, state.params,
                                        lr=lr,
                                        weight_decay=settings.weight_decay)
        if is_dtensor(lval):
            lval = lval.full_tensor()
        return TrainState(new_p, new_opt, state.step + 1), lval

    return train_step


def make_prefill_step(cfg: ModelConfig, settings: TrainSettings,
                      rules: Rules = None):
    """params, batch {"tokens" (B, S)} -> (logits, the decode cache of the
    S tokens), no autograd. With `rules`, on DTensors."""
    @torch.no_grad()
    def prefill_step(params, batch):
        with dtensor_mode(rules):
            return M.forward(cfg, params, batch, rules=rules,
                             return_cache=True, remat_policy="none",
                             q_chunk=settings.q_chunk)
    return prefill_step


def make_decode_step(cfg: ModelConfig, rules: Rules = None):
    """params, cache, batch {"tokens" (B, 1), "positions" (B,)} ->
    (logits, new cache), no autograd. With `rules` (DTensor parameters,
    cache and batch), kernel 6 reads each rank's local cache shard."""
    @torch.no_grad()
    def decode_step(params, cache, batch):
        with dtensor_mode(rules):
            return M.decode_step(cfg, params, cache, batch, rules=rules)
    return decode_step


def make_chunk_step(cfg: ModelConfig, rules: Rules = None):
    """params, cache, batch {"tokens" (B, C), "positions" (B,) chunk
    starts, "write_mask" (B,) optional} -> (logits, new cache): one
    chunked-prefill dispatch over the contiguous cache (kernel 3 packs
    the chunk at kv int4), no autograd. With `rules`, on each rank's
    local shard."""
    @torch.no_grad()
    def chunk_step(params, cache, batch):
        with dtensor_mode(rules):
            return M.prefill_step(cfg, params, cache, batch, rules=rules)
    return chunk_step
