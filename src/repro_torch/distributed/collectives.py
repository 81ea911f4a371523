"""Distributed-optimization collectives: the port of
`repro.distributed.collectives`.

`compressed_allreduce_mean`: an int8 error-feedback gradient all-reduce
for the slow cross-pod hop. Each rank quantizes its local gradient to int8
with a per-row scale (the augmented-memory write, the machinery of
AMC-Adam), sends the int8 payload and the float32 row scales (1 byte an
element and 4 a row instead of 2-4 bytes an element), and keeps the
quantization residual locally, feeding it back into the next step's
gradient (error feedback: unbiased in the long run, as in the 1-bit /
8-bit Adam literature).

The wire is explicit: `all_gather` of the payload and of the scales on
the axis's process group, then the dequantized rows summed in rank order
in float32 and divided by the rank count (at two ranks this is the JAX
package's float32 `psum`, bit for bit). Plain torch ops and collectives:
the JAX package has no Pallas kernel here.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import mesh_axes
from repro_torch.tree import flatten, unflatten


def _q8(x: torch.Tensor):
    """Per-row symmetric int8: the scale is the row's amax times the
    float32 reciprocal of 127, as the compiled JAX program computes
    `amax / 127.0` (XLA turns a division by a constant into that
    product)."""
    scale = torch.clamp_min(x.abs().amax(dim=-1, keepdim=True)
                            * (1 / 127.0), 1e-12)
    q = torch.clip(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def compressed_allreduce_mean(g: torch.Tensor, group=None,
                              residual: Optional[torch.Tensor] = None):
    """int8 + scale all-reduce-mean of this rank's `g` over `group` (the
    default group when None). Returns (g_mean in g's dtype, the new
    float32 residual, this rank's own)."""
    gf = g.to(torch.float32)
    if residual is not None:
        gf = gf + residual
    if gf.ndim == 0:
        gf2 = gf[None, None]
    elif gf.ndim == 1:
        gf2 = gf[None, :]
    else:
        gf2 = gf
    q, scale = _q8(gf2)
    # the residual gf - q * scale rounded once (a fused multiply-add, as
    # XLA fuses it): exact in float64, the product having <= 32 bits
    new_residual = (gf2.double() - q.double() * scale.double()).to(
        torch.float32).reshape(gf.shape)
    # the wire: the int8 payload and the float32 row scales
    n = dist.get_world_size(group)
    qs = [torch.empty_like(q) for _ in range(n)]
    ss = [torch.empty_like(scale) for _ in range(n)]
    dist.all_gather(qs, q.contiguous(), group=group)
    dist.all_gather(ss, scale.contiguous(), group=group)
    summed = qs[0].to(torch.float32) * ss[0]
    for qi, si in zip(qs[1:], ss[1:]):
        summed = summed + qi.to(torch.float32) * si
    out = (summed / float(n)).reshape(gf.shape)
    return out.to(g.dtype), new_residual


def make_compressed_grad_allreduce(mesh, axis: str = "pod"):
    """Tree-level compressed mean over the mesh axis `axis` (None when
    the mesh has no such axis or it is one rank wide).

    For the trainer when the cross-pod links are the bottleneck: the
    in-pod reduction stays in native precision (the DTensor gradients'
    own reductions), only the cross-pod hop is compressed. A DTensor
    leaf is reduced on its local shard (replicated over `axis`) and
    keeps its placements."""
    sizes = mesh_axes(mesh)
    if axis not in sizes or sizes[axis] == 1:
        return None
    group = mesh.get_group(axis)

    def one(g, res):
        if hasattr(g, "device_mesh"):
            from torch.distributed.tensor import DTensor
            out, new_res = compressed_allreduce_mean(g.to_local(), group,
                                                     res)
            return DTensor.from_local(out, g.device_mesh, g.placements), \
                new_res
        return compressed_allreduce_mean(g, group, res)

    def tree_allreduce(grads, residuals=None):
        flat_g, treedef = flatten(grads)
        flat_r = ([None] * len(flat_g) if residuals is None
                  else flatten(residuals)[0])
        outs = [one(g, r) for g, r in zip(flat_g, flat_r)]
        return (unflatten(treedef, [o[0] for o in outs]),
                unflatten(treedef, [o[1] for o in outs]))

    return tree_allreduce
