"""Train, prefill and decode steps: the port of `repro.train.step`.

`make_train_step` returns a function of (TrainState, batch) that runs the
forward and loss under autograd (every product a plain torch op: no
serving kernel has a backward, and on a dense master tree none is
launched), accumulates gradients over `grad_accum` microbatches in
float32 as the JAX step's scan does, and applies the optimizer, whose
update writes the parameters and moments in place. The sharding-spec
builders of the JAX module wait for `distributed/sharding.py`.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
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
    return loss.detach(), unflatten(treedef, grads)


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


def make_train_step(cfg: ModelConfig, settings: TrainSettings, lr_fn=None):
    _, opt_update = adamw.make_optimizer(settings.optimizer)

    def loss(p, b):
        return M.loss_fn(cfg, p, b, remat_policy=settings.remat_policy,
                         q_chunk=settings.q_chunk)

    def train_step(state: TrainState, batch: dict):
        lval, grads = accumulated_grads(loss, state.params, batch,
                                        settings.grad_accum)
        lr = settings.lr if lr_fn is None else lr_fn(state.step)
        new_p, new_opt = opt_update(grads, state.opt, state.params, lr=lr,
                                    weight_decay=settings.weight_decay)
        return TrainState(new_p, new_opt, state.step + 1), lval

    return train_step


def make_prefill_step(cfg: ModelConfig, settings: TrainSettings):
    """params, batch {"tokens" (B, S)} -> (logits, the decode cache of the
    S tokens), no autograd."""
    @torch.no_grad()
    def prefill_step(params, batch):
        return M.forward(cfg, params, batch, return_cache=True,
                         remat_policy="none", q_chunk=settings.q_chunk)
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """params, cache, batch {"tokens" (B, 1), "positions" (B,)} ->
    (logits, new cache), no autograd."""
    @torch.no_grad()
    def decode_step(params, cache, batch):
        return M.decode_step(cfg, params, cache, batch)
    return decode_step
