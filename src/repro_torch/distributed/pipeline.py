"""Microbatch pipeline parallelism over the "pod" axis (GPipe style): the
port of `repro.distributed.pipeline`.

Where cross-pod gradient traffic dominates, the pod axis can carry
pipeline stages instead: each pod owns a contiguous block of layers, and
microbatches stream stage to stage over the inter-pod links. The schedule
runs n_micro + n_stages - 1 ticks (fill, steady state, drain); each tick
stage 0 ingests the next microbatch, every stage applies its block to its
occupant, and one `batch_isend_irecv` ring shift (the JAX package's
`ppermute`) passes each stage's output to the next. The last stage's
outputs are replicated by an all-reduce of the masked buffer (JAX's
`psum`). The forward pipeline of serving and inference scale-out.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.tree import tree_map


def _stage_block(t, stage: int):
    """This stage's block of a stage-stacked leaf: a DTensor sharded on
    dim 0 over the axis gives its local (1, ...) shard, a plain tensor
    (every stage's block on every rank) its row `stage`."""
    if hasattr(t, "device_mesh"):
        return t.to_local()[0]
    return t[stage]


def pipeline_forward(mesh, stage_fn: Callable, n_micro: int,
                     axis: str = "pod"):
    """Build a pipelined forward over the mesh axis `axis`.

    stage_fn(stage_params, x) -> x, applied by every stage to whatever
    microbatch occupies it.

    Returns fn(stage_params_stacked, xs):
      stage_params_stacked: a tree of (n_stages, ...) leaves (DTensors
        sharded on dim 0 over `axis`, or plain tensors whole on every
        rank)
      xs: (n_micro, mb, ...), the same on every rank
      -> (n_micro, mb, ...) outputs, each microbatch taken through ALL
         stages in order, the same on every rank.
    """
    n_stages = mesh.shape[mesh.mesh_dim_names.index(axis)]
    group = mesh.get_group(axis)
    ranks = dist.get_process_group_ranks(group)
    stage = mesh.get_local_rank(axis)

    def pipelined(params, xs: torch.Tensor) -> torch.Tensor:
        p = tree_map(lambda t: _stage_block(t, stage), params)
        buf = torch.zeros(xs.shape[1:], dtype=xs.dtype, device=xs.device)
        outs = torch.zeros_like(xs)
        for t in range(n_micro + n_stages - 1):
            # stage 0 ingests microbatch t (if any)
            x_in = xs[min(t, n_micro - 1)] if stage == 0 else buf
            active = t >= stage and t - stage < n_micro
            y = stage_fn(p, x_in) if active else buf
            # the last stage emits microbatch t - n_stages + 1
            emit = t - (n_stages - 1)
            if stage == n_stages - 1 and emit >= 0:
                outs[emit] = y.to(outs.dtype)
            if n_stages == 1:
                buf = y
                continue
            # ring shift: stage s sends to s + 1 (the wraparound is
            # harmless: stage 0 takes its input fresh)
            nxt = torch.empty_like(y)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, y.contiguous(),
                           ranks[(stage + 1) % n_stages], group),
                dist.P2POp(dist.irecv, nxt,
                           ranks[(stage - 1) % n_stages], group)])
            for r in reqs:
                r.wait()
            buf = nxt
        # only the last stage holds the outputs; replicate them
        if stage != n_stages - 1:
            outs.zero_()
        dist.all_reduce(outs, group=group)
        return outs

    return pipelined
