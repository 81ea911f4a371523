"""Mamba-2 (SSD, state-space duality) blocks, attention-free.

Ports the decode side of `repro.models.ssm`: `_dims`, `abstract_params`,
`decode_step` and `abstract_cache`. One decode step updates each layer's
recurrent state in O(1):

    h_t = exp(dt_t * A) h_{t-1} + b_t (x) (dt_t x_t)      per head
    y_t = c_t . h_t + D x_t

with dt from a per-head softplus gate, x / b / c through a width-4 causal
depthwise conv over the ring of the last 3 inputs, and a gated RMS norm
before the output projection. The projections are bf16 `x @ w`, as the
JAX package computes them outside any Pallas kernel; the conv, the state
update and the readout run in float32, as the JAX step does. The decode
state of a row is a FIXED-SIZE slab (`ssd_state` float32, `conv_state`
bf16) that the serving store holds. Parameter and cache trees keep the
JAX stacking (`layers/<name>` with a leading layer dim), so a JAX tree
carries over as it is.

The full-sequence SSD (`ssd_chunked`, `block`, `forward`) is not ported:
the engine prefills this family token by token.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.params import PSpec


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    din = s.expand * cfg.d_model
    H = din // s.head_dim
    return din, H, s.head_dim, s.n_groups, s.state_dim, s.conv_dim


def abstract_params(cfg: ModelConfig) -> dict:
    n, d, V = cfg.n_layers, cfg.d_model, cfg.vocab_padded
    din, H, _, G, N, K = _dims(cfg)
    layer = {
        "norm": PSpec((n, d), init="zeros"),
        "z_proj": PSpec((n, d, din)),
        "x_proj": PSpec((n, d, din)),
        "b_proj": PSpec((n, d, G * N)),
        "c_proj": PSpec((n, d, G * N)),
        "dt_proj": PSpec((n, d, H)),
        "conv_x": PSpec((n, K, din)),
        "conv_b": PSpec((n, K, G * N)),
        "conv_c": PSpec((n, K, G * N)),
        "a_log": PSpec((n, H), init="zeros"),
        "d_skip": PSpec((n, H), init="ones"),
        "dt_bias": PSpec((n, H), init="zeros"),
        "gate_norm": PSpec((n, din), init="zeros"),
        "out_proj": PSpec((n, din, d)),
    }
    params = {"embed": PSpec((V, d)),
              "final_norm": PSpec((d,), init="zeros"),
              "layers": layer}
    if not cfg.tie_embeddings:
        params["head"] = PSpec((d, V))
    return params


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) without `F.softplus`'s linear branch above 20, as
    `jax.nn.softplus` computes it."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _block_step(cfg: ModelConfig, p: dict, x: torch.Tensor,
                h: torch.Tensor, conv_s: torch.Tensor):
    """One layer, one token. x (B, d) bf16; h (B, H, N, P) float32;
    conv_s (B, K-1, C) bf16. Returns (x + block output, new h, new conv
    ring)."""
    din, H, P_, G, N, _ = _dims(cfg)
    B = x.shape[0]
    hN = L.rms_norm(x, p["norm"], cfg.norm_eps, fixed_order=False)
    z = hN @ p["z_proj"]
    xi = hN @ p["x_proj"]
    bi = hN @ p["b_proj"]
    ci = hN @ p["c_proj"]
    # the compiled JAX step keeps this product in float32 (XLA drops the
    # bf16 round trip in front of the float32 cast)
    dt = _softplus(hN.float() @ p["dt_proj"].float()
                   + p["dt_bias"].float())                    # (B, H)
    full = torch.cat([conv_s, torch.cat([xi, bi, ci], -1)[:, None]], 1)
    w = torch.cat([p["conv_x"], p["conv_b"], p["conv_c"]], -1)
    conv = (full.float() * w.float()).sum(dim=1).to(full.dtype)
    xbc = L.silu(conv)
    xi, bi, ci = xbc[:, :din], xbc[:, din:din + G * N], xbc[:, din + G * N:]
    xh = xi.reshape(B, H, P_)
    bh = bi.reshape(B, G, N).repeat_interleave(H // G, dim=1)
    ch = ci.reshape(B, G, N).repeat_interleave(H // G, dim=1)
    a = torch.exp(dt * -torch.exp(p["a_log"].float()))        # (B, H)
    upd = torch.einsum("bhn,bhp->bhnp", bh.float(),
                       xh.float() * dt[..., None])
    h = a[:, :, None, None] * h + upd
    y = torch.einsum("bhn,bhnp->bhp", ch.float(), h)
    y = y + p["d_skip"].float()[None, :, None] * xh.float()
    # silu(z) feeds a float32 product: the compiled JAX step keeps its
    # last multiply in float32 too
    y = L.rms_norm(y.reshape(B, din) * (z.float() * L.sigmoid(z).float()),
                   p["gate_norm"], cfg.norm_eps, fixed_order=False)
    out = (y @ p["out_proj"].float()).to(x.dtype)
    return x + out, h, full[:, 1:]


def decode_step(cfg: ModelConfig, params: dict, cache: dict,
                tokens: torch.Tensor, positions: torch.Tensor):
    """One token a row: tokens (B, 1); positions are unused (the state
    carries no position). Returns (logits (B, 1, V), new cache): a new
    tree, never written into the cache given (a speculative snapshot may
    hold it)."""
    x = L.embed_lookup(params["embed"], tokens[:, 0]).to(torch.bfloat16)
    lp = params["layers"]
    hs, convs = [], []
    for i in range(cfg.n_layers):
        x, h, c = _block_step(cfg, {k: v[i] for k, v in lp.items()}, x,
                              cache["ssd_state"][i], cache["conv_state"][i])
        hs.append(h)
        convs.append(c)
    logits = T._logits_head(cfg, params, x[:, None])
    return logits, {"ssd_state": torch.stack(hs),
                    "conv_state": torch.stack(convs)}


def abstract_cache(cfg: ModelConfig, batch: int, seq: int) -> dict:
    """The decode-state tree, batch at axis 1 of every leaf. `seq` is
    unused: the state has the same size at every length."""
    din, H, P_, G, N, K = _dims(cfg)
    n = cfg.n_layers
    return {
        "ssd_state": PSpec((n, batch, H, N, P_), torch.float32,
                           init="zeros"),
        "conv_state": PSpec((n, batch, K - 1, din + 2 * G * N),
                            init="zeros"),
    }
