"""AdamW, plus AMC-Adam: Adam whose moment buffers live in augmented
(int8-quantized, dynamic-plane) storage.

AMC-Adam is the optimizer-state instance of the paper's capacity
augmentation: m and v are DYNAMIC data (rewritten every step, tolerant of
quantization noise), so they take the augmented plane, 1 byte a parameter
each instead of 4, with per-row scales as the "reference voltage" and the
every-step rewrite acting as the DRAM-style refresh. Optimizer memory
falls from 8 to about 2 bytes a parameter. Moments keep the parameter's
shape (int8).

The port of `repro.optim.adamw`. The updates write the new parameters and
moments IN PLACE into the tensors they were given (under `no_grad`) and
return the same trees, with a new step tensor: the arithmetic is the JAX
package's, op for op, in float32 (the bias corrections `b ** step` too).
A caller that keeps an earlier state (an asynchronous checkpoint) takes a
copy of it first.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.tree import flatten, tree_map


class AdamState(NamedTuple):
    step: torch.Tensor
    m: dict
    v: dict


class AMCAdamState(NamedTuple):
    step: torch.Tensor
    m_q: dict      # int8, param-shaped
    m_scale: dict  # f32, shape[:-1] + (1,)
    v_q: dict      # int8, sqrt-space for dynamic range
    v_scale: dict


def _step0(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=flatten(params)[0][0].device)


def adamw_init(params) -> AdamState:
    z = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return AdamState(step=_step0(params), m=tree_map(z, params),
                     v=tree_map(z, params))


def _bias_corrections(step: torch.Tensor, b1: float, b2: float):
    """1 - b ** step in float32, as `b1 ** step.astype(jnp.float32)`."""
    s = step.to(torch.float32)
    one = lambda b: torch.tensor(b, dtype=torch.float32, device=s.device)
    return 1 - torch.pow(one(b1), s), 1 - torch.pow(one(b2), s)


def _new_param(p, m, v, bc1, bc2, lr, eps, weight_decay):
    pf = p.to(torch.float32)
    return pf - lr * ((m / bc1) / (torch.sqrt(v / bc2) + eps)
                      + weight_decay * pf)


@torch.no_grad()
def adamw_update(grads, state: AdamState, params, *, lr, b1=0.9, b2=0.95,
                 eps=1e-8, weight_decay=0.1):
    step = state.step + 1
    bc1, bc2 = _bias_corrections(step, b1, b2)

    def upd(g, m, v, p):
        g = g.to(torch.float32)
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * g * g)
        p.copy_(_new_param(p, m, v, bc1, bc2, lr, eps, weight_decay))

    tree_map(upd, grads, state.m, state.v, params)
    return params, AdamState(step=step, m=state.m, v=state.v)


# ---------------------------------------------------------------------------
# AMC-Adam: int8 row-quantized moments (augmented dynamic plane)
# ---------------------------------------------------------------------------

def _q_write(x: torch.Tensor):
    """Per-row symmetric int8 write to the augmented plane."""
    scale = torch.clamp_min(x.abs().amax(dim=-1, keepdim=True) / 127.0,
                            1e-12)
    q = torch.clip(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _q_read(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Sense amplifier: dequantize the plane."""
    return q.to(torch.float32) * scale


def amc_adamw_init(params) -> AMCAdamState:
    zq = lambda p: torch.zeros(p.shape, dtype=torch.int8, device=p.device)
    zs = lambda p: torch.zeros(tuple(p.shape[:-1]) + (1,),
                               dtype=torch.float32, device=p.device)
    return AMCAdamState(step=_step0(params), m_q=tree_map(zq, params),
                        m_scale=tree_map(zs, params),
                        v_q=tree_map(zq, params),
                        v_scale=tree_map(zs, params))


@torch.no_grad()
def amc_adamw_update(grads, state: AMCAdamState, params, *, lr, b1=0.9,
                     b2=0.95, eps=1e-8, weight_decay=0.1):
    step = state.step + 1
    bc1, bc2 = _bias_corrections(step, b1, b2)

    def upd(g, mq, ms, vq, vs, p):
        g = g.to(torch.float32)
        m = _q_read(mq, ms)                    # sense the dynamic plane
        v = _q_read(vq, vs) ** 2               # v stored in sqrt-space
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        p.copy_(_new_param(p, m, v, bc1, bc2, lr, eps, weight_decay))
        for (q, s), x in (((mq, ms), m), ((vq, vs), torch.sqrt(v))):
            q2, s2 = _q_write(x)               # refresh (re-write) the plane
            q.copy_(q2)
            s.copy_(s2)

    tree_map(upd, grads, state.m_q, state.m_scale, state.v_q,
             state.v_scale, params)
    return params, AMCAdamState(step=step, m_q=state.m_q,
                                m_scale=state.m_scale, v_q=state.v_q,
                                v_scale=state.v_scale)


def make_optimizer(kind: str):
    if kind == "adamw":
        return adamw_init, adamw_update
    if kind == "amc_adamw":
        return amc_adamw_init, amc_adamw_update
    raise KeyError(kind)
