"""Mamba-2 (SSD, state-space duality) blocks, attention-free.

Ports `repro.models.ssm`: `_dims`, `abstract_params`, the full-sequence
side (`_causal_conv`, `_segsum_decay`, `ssd_chunked`, `_head_expand`,
`block`, `forward`) and the decode side (`decode_step`,
`abstract_cache`). One decode step updates each layer's recurrent state
in O(1):

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

The full-sequence side is the chunked dual form (Dao & Gu 2024):
quadratic attention-like products inside each chunk of `cfg.ssm.chunk`
tokens, the state carried from chunk to chunk by a loop over the chunks
(JAX's `lax.scan`). It rounds as the JAX source is written: the causal
conv adds its K shifted products one by one in the input's dtype, dt goes
through softplus in float32, the intra-chunk scores are cast to the
input's dtype before the second product, and the state products run in
float32. Every product is a plain torch op (the JAX package computes the
family in XLA, no Pallas kernel), so `forward` is differentiable, each
layer under `transformer._remat`; `forward(return_cache=True)` hands the
final states to `decode_step` as they are. The engine still prefills this
family token by token.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import constrain, gather_weights
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
        "norm": PSpec((n, d), (None, None), init="zeros"),
        "z_proj": PSpec((n, d, din), (None, "embed", "lru")),
        "x_proj": PSpec((n, d, din), (None, "embed", "lru")),
        "b_proj": PSpec((n, d, G * N), (None, "embed", None)),
        "c_proj": PSpec((n, d, G * N), (None, "embed", None)),
        "dt_proj": PSpec((n, d, H), (None, "embed", None)),
        "conv_x": PSpec((n, K, din), (None, None, "lru")),
        "conv_b": PSpec((n, K, G * N), (None, None, None)),
        "conv_c": PSpec((n, K, G * N), (None, None, None)),
        "a_log": PSpec((n, H), (None, None), init="zeros"),
        "d_skip": PSpec((n, H), (None, None), init="ones"),
        "dt_bias": PSpec((n, H), (None, None), init="zeros"),
        "gate_norm": PSpec((n, din), (None, "lru"), init="zeros"),
        "out_proj": PSpec((n, din, d), (None, "lru", "embed")),
    }
    params = {"embed": PSpec((V, d), ("vocab", "embed")),
              "final_norm": PSpec((d,), (None,), init="zeros"),
              "layers": layer}
    if not cfg.tie_embeddings:
        params["head"] = PSpec((d, V), ("embed", "vocab"))
    return params


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv of x (B, S, C) with w (K, C): the K shifted
    products added one by one in x's dtype."""
    K, S = w.shape[0], x.shape[1]
    out = torch.zeros_like(x)
    for i in range(K):
        shift = K - 1 - i
        xi = torch.nn.functional.pad(x, (0, 0, shift, 0))[:, :S]
        out = out + xi * w[i]
    return out


def _segsum_decay(a_cum: torch.Tensor) -> torch.Tensor:
    """a_cum (..., L) -> the lower-triangular decay exp(a_cum[t] -
    a_cum[s]) for t >= s, 0 above the diagonal. The exponent above the
    diagonal is masked to -inf before the exp (JAX masks after it): the
    same values, and no inf above the diagonal whose gradient 0 * inf
    would be NaN in a long chunk."""
    Lm = a_cum[..., :, None] - a_cum[..., None, :]
    n = a_cum.shape[-1]
    tri = torch.ones((n, n), dtype=torch.bool,
                     device=a_cum.device).tril()
    return torch.exp(Lm.masked_fill(~tri, float("-inf")))


def ssd_chunked(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                c: torch.Tensor, chunk: int, h0=None):
    """The SSD scan. x (B, S, H, P) dt-weighted, a (B, S, H) log-decay,
    b, c (B, S, H, N) head-expanded. Returns y (B, S, H, P) in x's dtype
    and the final state h (B, H, N, P) float32. Recurrence:
    h_t = e^{a_t} h_{t-1} + b_t (x) x_t, y_t = c_t . h_t."""
    B, S, H, P_ = x.shape
    N = b.shape[-1]
    if S % chunk:
        raise ValueError(f"sequence {S} is not a multiple of the chunk "
                         f"{chunk}")
    nc = S // chunk

    def r(t):
        return t.reshape((B, nc, chunk) + tuple(t.shape[2:])).transpose(0, 1)
    xr, br, cr = r(x), r(b), r(c)
    a_cum = torch.cumsum(r(a).float(), dim=2)              # (nc, B, L, H)
    h = (torch.zeros((B, H, N, P_), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    ys = []
    for i in range(nc):
        xc, ac, bc, cc = xr[i], a_cum[i], br[i], cr[i]
        # inside the chunk: the dual quadratic form
        decay = _segsum_decay(ac.transpose(1, 2))           # (B, H, L, L)
        scores = torch.einsum("blhn,bshn->bhls", cc.float(),
                              bc.float()) * decay
        y = torch.einsum("bhls,bshp->blhp", scores.to(xc.dtype), xc)
        # from the carried state
        y = y + torch.einsum("blhn,bhnp,blh->blhp", cc.float(), h,
                             torch.exp(ac)).to(y.dtype)
        # the state update
        out_decay = torch.exp(ac[:, -1:, :] - ac)            # (B, L, H)
        states = torch.einsum("blhn,blh,blhp->bhnp", bc.float(), out_decay,
                              xc.float())
        h = torch.exp(ac[:, -1])[:, :, None, None] * h + states
        ys.append(y)
    y = torch.stack(ys).transpose(0, 1).reshape(B, S, H, P_)
    return y, h


def _head_expand(t: torch.Tensor, H: int) -> torch.Tensor:
    """(B, S, G, N) -> (B, S, H, N), each group repeated H // G times."""
    return t.repeat_interleave(H // t.shape[2], dim=2)


def block(cfg: ModelConfig, p: dict, x: torch.Tensor,
          return_state: bool = False):
    """One mamba2 block over a full sequence from a zero state, x (B, S,
    d) bf16. With `return_state` also returns the final SSD state (B, H,
    N, P) float32 and the conv tail (B, K - 1, C), the decode step's
    cache."""
    din, H, P_, G, N, K = _dims(cfg)
    B, S, _ = x.shape
    hN = L.rms_norm(x, p["norm"], cfg.norm_eps, fixed_order=False)
    z = L.matmul(hN, p["z_proj"])
    xi = L.matmul(hN, p["x_proj"])
    bi = L.matmul(hN, p["b_proj"])
    ci = L.matmul(hN, p["c_proj"])
    conv_tail = torch.cat([xi, bi, ci], -1)[:, S - (K - 1):]
    dt = _softplus(L.matmul(hN, p["dt_proj"]).float()
                   + p["dt_bias"].float())                   # (B, S, H)
    xi = L.silu(_causal_conv(xi, p["conv_x"]))
    bi = L.silu(_causal_conv(bi, p["conv_b"]))
    ci = L.silu(_causal_conv(ci, p["conv_c"]))
    xh = xi.reshape(B, S, H, P_)
    bh = _head_expand(bi.reshape(B, S, G, N), H)
    ch = _head_expand(ci.reshape(B, S, G, N), H)
    a = dt * -torch.exp(p["a_log"].float())                 # (B, S, H)
    xw = (xh * dt[..., None]).to(xh.dtype)
    y, h_fin = ssd_chunked(xw, a, bh, ch, cfg.ssm.chunk)
    y = y + p["d_skip"].float()[None, None, :, None] * xh
    y = L.rms_norm(y.reshape(B, S, din) * L.silu(z), p["gate_norm"],
                   cfg.norm_eps, fixed_order=False)
    out = L.matmul(y, p["out_proj"]).to(x.dtype)
    if return_state:
        return out, h_fin, conv_tail
    return out


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *,
            rules=None, return_cache: bool = False,
            remat_policy: str = "dots", q_chunk=None):
    """tokens (B, S) -> float32 logits (B, S, V) [+ the decode cache
    {"ssd_state", "conv_state"} after the S tokens]. S must be a multiple
    of `cfg.ssm.chunk`. Each layer runs under `remat_policy`; `q_chunk`
    is unused (no attention). With `rules`, the residual stream is
    sequence-parallel between the layers, as in the JAX forward."""
    top = gather_weights(params, rules, skip=("layers",))
    x = L.embed_lookup(top["embed"], tokens).to(torch.bfloat16)
    x = constrain(x, rules, "batch", "seq_sp", None)

    def body(x, lp):
        lp = gather_weights(lp, rules)
        x = constrain(x, rules, "batch", "seq_sp", None)
        if return_cache:
            out, h, conv = block(cfg, lp, x, return_state=True)
            return constrain(x + out, rules, "batch", "seq_sp", None), \
                (h, conv)
        return constrain(x + block(cfg, lp, x), rules, "batch", "seq_sp",
                         None), None

    run = T._remat(body, remat_policy)
    states = []
    for i in range(cfg.n_layers):
        x, st = run(x, T._layer(params["layers"], i))
        states.append(st)
    logits = T._logits_head(cfg, top, x, fixed_order=False,
                            norm_fixed=False)
    if return_cache:
        return logits, {"ssd_state": torch.stack([h for h, _ in states]),
                        "conv_state": torch.stack([c for _, c in states])}
    return logits


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
                tokens: torch.Tensor, positions: torch.Tensor, *,
                rules=None):
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
        "ssd_state": PSpec((n, batch, H, N, P_),
                           (None, "cache_batch", None, None, None),
                           torch.float32, init="zeros"),
        "conv_state": PSpec((n, batch, K - 1, din + 2 * G * N),
                            (None, "cache_batch", None, "lru"),
                            init="zeros"),
    }
