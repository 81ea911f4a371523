"""RecurrentGemma-style hybrid: RG-LRU recurrent blocks and local sliding-
window attention, pattern (rec, rec, attn) — 38 layers are 12 macro-blocks
of 3 and 2 trailing recurrent layers.

RG-LRU (diagonal-gated, gates per channel from the branch input):
    r_t = sigmoid(w_r * x_t + b_r)            recurrence gate
    i_t = sigmoid(w_i * x_t + b_i)            input gate
    log a_t = -8 * softplus(lam) * r_t        per-channel decay
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Ports `repro.models.hybrid`: `_layout`, `rec_pspecs`, `abstract_params`,
`_lru_gates`, the full-sequence side (`rec_block`, `_ring_from_full`,
`forward`) and the decode side (`rec_step`, `decode_step`,
`abstract_cache`). The decode state of a row is a FIXED-SIZE slab: the LRU
state h (float32), the conv tails (bf16) and the window's ring KV, packed
here per `kv_mode` (integer leaves and their scales pass through the
serving store's slab planes unchanged). The parameter and cache trees
keep the JAX package's stacking (`blocks` with a leading macro-block dim,
`tail` with the trailing layers), so a JAX tree carries over as it is.

The full-sequence recurrence, which JAX computes with
`jax.lax.associative_scan`, is a log-depth doubling scan over the
sequence here (`_linear_scan`: ceil(log2 S) steps, each combining every
position with the one 2^k before it), not a loop over tokens; its
float32 sums run in a different tree order than JAX's, so h agrees to
float32 rounding (rel_err 1e-4 in the tests), not bit for bit.
`forward(return_cache=True)` hands off to `decode_step`: the LRU states
and conv tails as they are, and each attention layer's K / V of the last
`window` tokens as a ring (`_ring_from_full`, slot = position % window),
packed head-major at int4 / int8 as the decode step's kernel 6 reads it.
The engine still prefills this family token by token.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.params import PSpec, attn_pspecs, mlp_pspecs


def _layout(cfg: ModelConfig):
    npat = len(cfg.hybrid.pattern)          # 3
    nb = cfg.n_layers // npat               # 12 macro-blocks
    tail = cfg.n_layers - nb * npat         # 2 trailing rec layers
    return nb, tail


def rec_pspecs(cfg: ModelConfig, n: int) -> dict:
    d, w = cfg.d_model, cfg.hybrid.lru_width
    return {
        "norm": PSpec((n, d), init="zeros"),
        "proj_x": PSpec((n, d, w)),
        "proj_gate": PSpec((n, d, w)),
        "conv": PSpec((n, 4, w)),
        "w_r": PSpec((n, w), init="zeros"),
        "b_r": PSpec((n, w), init="zeros"),
        "w_i": PSpec((n, w), init="zeros"),
        "b_i": PSpec((n, w), init="zeros"),
        "lam": PSpec((n, w), init="ones"),
        "out": PSpec((n, w, d)),
    }


def abstract_params(cfg: ModelConfig) -> dict:
    nb, tail = _layout(cfg)
    d, V = cfg.d_model, cfg.vocab_padded
    blocks = {
        "rec_a": rec_pspecs(cfg, nb), "rec_a_mlp": mlp_pspecs(cfg, nb),
        "rec_b": rec_pspecs(cfg, nb), "rec_b_mlp": mlp_pspecs(cfg, nb),
        "attn": attn_pspecs(cfg, nb), "attn_mlp": mlp_pspecs(cfg, nb),
    }
    params = {
        "embed": PSpec((V, d)),
        "final_norm": PSpec((d,), init="zeros"),
        "blocks": blocks,
        "tail": {"rec": rec_pspecs(cfg, tail), "mlp": mlp_pspecs(cfg, tail)},
    }
    if not cfg.tie_embeddings:
        params["head"] = PSpec((d, V))
    return params


def _lru_gates(p: dict, x: torch.Tensor):
    """(a, gated input), both float32, from the conv output x (B, w)."""
    xf = x.float()
    r = torch.sigmoid(xf * p["w_r"].float() + p["b_r"].float())
    i = torch.sigmoid(xf * p["w_i"].float() + p["b_i"].float())
    lam = p["lam"].float()
    log_a = -8.0 * torch.logaddexp(lam, torch.zeros_like(lam)) * r
    a = torch.exp(log_a)
    gated_in = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-9)) * (i * xf)
    return a, gated_in


def _linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t along axis 1 with h_{-1} = 0, as a doubling
    (Hillis-Steele) scan: at step k every position t >= 2^k takes in the
    pair 2^k before it with JAX's combine (a1, b1), (a2, b2) -> (a1 a2,
    a2 b1 + b2). Differentiable; no in-place writes."""
    d, S = 1, a.shape[1]
    while d < S:
        a, b = (torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1),
                torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]],
                          dim=1))
        d *= 2
    return b


def rec_block(cfg: ModelConfig, p: dict, x: torch.Tensor, h0=None,
              return_state: bool = False):
    """The full-sequence RG-LRU block, x (B, S, d) bf16, from the state
    `h0` (B, w) float32 when given (zero otherwise). With `return_state`
    also returns the final h (B, w) float32 and the conv tail (B, 3, w),
    the decode step's state."""
    B, S, _ = x.shape
    hN = L.rms_norm(x, p["norm"], cfg.norm_eps, fixed_order=False)
    xb = L.matmul(hN, p["proj_x"])                           # (B, S, w)
    gate = L.gelu_tanh(L.matmul(hN, p["proj_gate"]))
    # causal depthwise conv of width 4: shifted products added in xb's dtype
    conv = torch.zeros_like(xb)
    for i in range(4):
        xi = torch.nn.functional.pad(xb, (0, 0, 3 - i, 0))[:, :S]
        conv = conv + xi * p["conv"][i]
    a, gin = _lru_gates(p, conv)                            # float32
    if h0 is not None:
        gin = torch.cat([gin[:, :1] + a[:, :1] * h0[:, None], gin[:, 1:]],
                        dim=1)
    hh = _linear_scan(a, gin)
    y = L.matmul(hh.to(x.dtype) * gate, p["out"]).to(x.dtype)
    if return_state:
        return y, hh[:, -1], xb[:, S - 3:]
    return y


def _ring_from_full(k: torch.Tensor, W: int) -> torch.Tensor:
    """A full sequence's keys (B, S, KV, hd) -> the ring (B, W, KV, hd):
    token t in slot t % W for the last min(S, W) tokens, zeros
    elsewhere."""
    B, S = k.shape[:2]
    if S <= W:
        return torch.cat([k, k.new_zeros((B, W - S) + tuple(k.shape[2:]))],
                         dim=1)
    ring = k.new_zeros((B, W) + tuple(k.shape[2:]))
    ring[:, torch.arange(S - W, S, device=k.device) % W] = k[:, S - W:]
    return ring


def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *,
            return_cache: bool = False, remat_policy: str = "dots",
            q_chunk: int = 1024):
    """tokens (B, S) -> float32 logits (B, S, V) [+ the decode cache of
    the S tokens, `abstract_cache`'s tree]. Each macro-block and each
    tail layer runs under `remat_policy`; the attention layers attend a
    causal sliding window of `cfg.hybrid.window` tokens."""
    B, S = tokens.shape
    W = cfg.hybrid.window
    x = L.embed_lookup(params["embed"], tokens).to(torch.bfloat16)
    positions = torch.arange(S, device=x.device)

    def mlp(p, x):
        return T.mlp_block(cfg, p, x, fixed_order=False, norm_fixed=False)

    def block_body(x, bp):
        st = {}
        for name in ("a", "b"):
            if return_cache:
                y, st[f"h_{name}"], st[f"conv_{name}"] = rec_block(
                    cfg, bp[f"rec_{name}"], x, return_state=True)
            else:
                y = rec_block(cfg, bp[f"rec_{name}"], x)
            x = x + y
            x = x + mlp(bp[f"rec_{name}_mlp"], x)
        a, (k, v) = T.attn_block(cfg, bp["attn"], x, positions, window=W,
                                 q_chunk=q_chunk)
        x = x + a
        x = x + mlp(bp["attn_mlp"], x)
        if not return_cache:
            return x, None
        kv = {"k": _ring_from_full(k, W), "v": _ring_from_full(v, W)}
        mode = cfg.amc.kv_mode
        if mode != "normal":
            # packed rings are head-major (B, KV, W, .), the layout the
            # packed decode-attention kernel streams
            pack = L.pack_kv_int4 if mode == "int4" else L.pack_kv_int8
            kv["k"], kv["k_scale"] = pack(L.to_kvmajor(kv["k"]))
            kv["v"], kv["v_scale"] = pack(L.to_kvmajor(kv["v"]))
        st.update(kv)
        return x, st

    def tail_body(x, tp):
        if return_cache:
            y, h, c = rec_block(cfg, tp["rec"], x, return_state=True)
        else:
            y, h, c = rec_block(cfg, tp["rec"], x), None, None
        x = x + y
        x = x + mlp(tp["mlp"], x)
        return x, ({"h": h, "conv": c} if return_cache else None)

    nb, tail = _layout(cfg)
    blocks, tails = [], []
    run = T._remat(block_body, remat_policy)
    for i in range(nb):
        x, st = run(x, T._layer_groups(params["blocks"], i))
        blocks.append(st)
    run = T._remat(tail_body, remat_policy)
    for i in range(tail):
        x, st = run(x, T._layer_groups(params["tail"], i))
        tails.append(st)
    logits = T._logits_head(cfg, params, x, fixed_order=False,
                            norm_fixed=False)
    if not return_cache:
        return logits
    if not tails:   # a layer count that is a multiple of the pattern
        w = cfg.hybrid.lru_width
        tails_st = {"h": x.new_zeros((0, B, w), dtype=torch.float32),
                    "conv": x.new_zeros((0, B, 3, w))}
    else:
        tails_st = _stack(tails)
    return logits, {"blocks": _stack(blocks), "tail": tails_st}


def rec_step(cfg: ModelConfig, p: dict, x: torch.Tensor, h: torch.Tensor,
             conv_s: torch.Tensor):
    """O(1) decode step. x (B, d) bf16; h (B, w) float32; conv_s (B, 3, w)
    bf16. Returns (y (B, d), new h, new conv tail)."""
    hN = L.rms_norm(x, p["norm"], cfg.norm_eps, fixed_order=False)
    xb = hN @ p["proj_x"]
    gate = L.gelu_tanh(hN @ p["proj_gate"])
    full = torch.cat([conv_s, xb[:, None]], dim=1)          # (B, 4, w)
    conv = (full.float() * p["conv"].float()).sum(dim=1).to(full.dtype)
    a, gin = _lru_gates(p, conv)
    h = a * h + gin
    y = (h.to(x.dtype) * gate) @ p["out"]
    return y.to(x.dtype), h, full[:, 1:]


def _layer(tree: dict, i: int) -> dict:
    return {k: v[i] for k, v in tree.items()}


def _stack(states: list) -> dict:
    return {k: torch.stack([s[k] for s in states]) for k in states[0]}


def decode_step(cfg: ModelConfig, params: dict, cache: dict,
                tokens: torch.Tensor, positions: torch.Tensor):
    """One token a row: tokens (B, 1), positions (B,). Returns (logits
    (B, 1, V), new cache) — a new tree, as the JAX step returns; the
    serving store decides which rows' state is kept."""
    nb, tail = _layout(cfg)
    W = cfg.hybrid.window
    x = L.embed_lookup(params["embed"], tokens[:, 0]).to(torch.bfloat16)
    blocks, bst = params["blocks"], cache["blocks"]
    new_blocks = []
    for i in range(nb):
        st = _layer(bst, i)
        y, ha, ca = rec_step(cfg, _layer(blocks["rec_a"], i), x, st["h_a"],
                             st["conv_a"])
        x = x + y
        x = x + T.mlp_block(cfg, _layer(blocks["rec_a_mlp"], i),
                            x[:, None])[:, 0]
        y, hb, cb = rec_step(cfg, _layer(blocks["rec_b"], i), x, st["h_b"],
                             st["conv_b"])
        x = x + y
        x = x + T.mlp_block(cfg, _layer(blocks["rec_b_mlp"], i),
                            x[:, None])[:, 0]
        a, new_kv = T.attn_block_decode(
            cfg, _layer(blocks["attn"], i), x[:, None],
            {k: v for k, v in st.items() if k.startswith(("k", "v"))},
            positions, window=W)
        x = x + a[:, 0]
        x = x + T.mlp_block(cfg, _layer(blocks["attn_mlp"], i),
                            x[:, None])[:, 0]
        new_blocks.append({**new_kv, "h_a": ha, "conv_a": ca, "h_b": hb,
                           "conv_b": cb})
    tp, tst = params["tail"], cache["tail"]
    new_tail = []
    for i in range(tail):
        y, h, c = rec_step(cfg, _layer(tp["rec"], i), x, tst["h"][i],
                           tst["conv"][i])
        x = x + y
        x = x + T.mlp_block(cfg, _layer(tp["mlp"], i), x[:, None])[:, 0]
        new_tail.append({"h": h, "conv": c})
    logits = T._logits_head(cfg, params, x[:, None])
    # a layer count that is a multiple of the pattern leaves no tail
    return logits, {"blocks": _stack(new_blocks),
                    "tail": _stack(new_tail) if new_tail else tst}


def abstract_cache(cfg: ModelConfig, batch: int, seq: int) -> dict:
    """The decode-state tree, batch at axis 1 of every leaf. `seq` is
    unused: the ring holds `window` slots whatever the sequence length."""
    nb, tail = _layout(cfg)
    w = cfg.hybrid.lru_width
    W = cfg.hybrid.window
    KV, hd = cfg.n_kv_heads, cfg.hd
    mode = cfg.amc.kv_mode
    f32 = torch.float32
    blocks = {
        "h_a": PSpec((nb, batch, w), f32, init="zeros"),
        "conv_a": PSpec((nb, batch, 3, w), init="zeros"),
        "h_b": PSpec((nb, batch, w), f32, init="zeros"),
        "conv_b": PSpec((nb, batch, 3, w), init="zeros"),
    }
    if mode == "normal":
        blocks["k"] = PSpec((nb, batch, W, KV, hd), init="zeros")
        blocks["v"] = PSpec((nb, batch, W, KV, hd), init="zeros")
    else:
        dt = torch.uint8 if mode == "int4" else torch.int8
        ds = hd // 2 if mode == "int4" else hd
        blocks["k"] = PSpec((nb, batch, KV, W, ds), dt, init="zeros")
        blocks["v"] = PSpec((nb, batch, KV, W, ds), dt, init="zeros")
        blocks["k_scale"] = PSpec((nb, batch, KV, W, 1), init="zeros")
        blocks["v_scale"] = PSpec((nb, batch, KV, W, 1), init="zeros")
    tail_c = {
        "h": PSpec((tail, batch, w), f32, init="zeros"),
        "conv": PSpec((tail, batch, 3, w), init="zeros"),
    }
    return {"blocks": blocks, "tail": tail_c}
