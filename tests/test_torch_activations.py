"""The packed MLPs' and the hybrid gate's activations round as the JAX
package's do: silu and the tanh GELU op by op (`layers.silu`,
`layers.gelu_tanh`), as the compiled `jax.nn.silu` / `jax.nn.gelu(
approximate=True)` run them, where `torch.nn.functional` rounds once.

Each site runs at its reduced config with seeded weights and inputs while
`layers.silu` / `layers.gelu_tanh` record what they were given and what
they returned; the outputs' bits (bf16 viewed as int16) must equal the
jitted JAX activation's on the same inputs, and the site must have gone
through the recorder at all.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import get_arch
from repro_torch.models import augment, hybrid, layers, moe
from repro_torch.models.params import init_params

CPU = torch.device("cpu")
JAX_ACT = {"silu": jax.jit(jax.nn.silu),
           "gelu_tanh": jax.jit(functools.partial(jax.nn.gelu,
                                                  approximate=True))}


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.detach().contiguous().view(torch.int16).numpy()


def _jax_bits(kind: str, x: torch.Tensor) -> np.ndarray:
    jx = jnp.asarray(_bits(x).view(jnp.bfloat16))
    return np.asarray(JAX_ACT[kind](jx)).view(np.int16)


@pytest.fixture
def recorder(monkeypatch):
    """Wrap `layers.silu` / `layers.gelu_tanh`: every call's (kind, x, y)."""
    calls = []
    for kind in ("silu", "gelu_tanh"):
        base = getattr(layers, kind)

        def rec(x, base=base, kind=kind):
            y = base(x)
            calls.append((kind, x.clone(), y.clone()))
            return y

        monkeypatch.setattr(layers, kind, rec)
    return calls


def _layer(tree: dict, i: int = 0) -> dict:
    return {k: v[i] for k, v in tree.items()}


def _packed_layer(cfg, group: str) -> dict:
    dense = dataclasses.replace(cfg, amc=dataclasses.replace(
        cfg.amc, weight_mode="normal"))
    params = augment.augment_params(cfg, init_params(dense, seed=3,
                                                     device=CPU))
    return _layer(params["layers"][group])


def _h(cfg, rows: int = 8, seed: int = 0) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randn((rows, 1, cfg.d_model), generator=g).to(
        torch.bfloat16)


def _check(calls, kinds: set) -> None:
    assert {k for k, _, _ in calls} == kinds, [k for k, _, _ in calls]
    for kind, x, y in calls:
        assert x.dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(y), _jax_bits(kind, x),
                                      err_msg=kind)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_ternary_mlp_activation_bits_match_jax(recorder, act):
    """`augment.ternary_mlp` (the main path's qwen ternary MLP), both
    activations (`repro/models/augment.py:149, 151`)."""
    cfg = dataclasses.replace(get_arch("qwen1.5-0.5b").reduced(), act=act)
    assert cfg.amc.weight_mode == "ternary"
    p = _packed_layer(cfg, "mlp")
    augment.ternary_mlp(cfg, p, _h(cfg))
    _check(recorder, {"silu"} if act == "swiglu" else {"gelu_tanh"})


def test_dual_mlp_activation_bits_match_jax(recorder):
    """`augment.dual_mlp` (granite's, minicpm's and minitron's MLP;
    `repro/models/augment.py:159`)."""
    cfg = get_arch("granite-3-2b").reduced()
    assert cfg.amc.weight_mode == "dual"
    p = _packed_layer(cfg, "mlp")
    augment.dual_mlp(cfg, p, _h(cfg, seed=1))
    _check(recorder, {"silu"})


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_moe_ffn_activation_bits_match_jax(recorder, act):
    """`moe.moe_ffn`'s expert FFN over every expert's slots
    (`repro/models/moe.py:124, 127`)."""
    cfg = dataclasses.replace(get_arch("qwen3-moe-30b-a3b").reduced(),
                              act=act)
    cfg = dataclasses.replace(cfg, amc=dataclasses.replace(
        cfg.amc, weight_mode="normal"))
    p = _layer(init_params(cfg, seed=4, device=CPU)["layers"]["moe"])
    moe.moe_ffn(cfg, p, _h(cfg, rows=4, seed=2).reshape(2, 2, -1))
    _check(recorder, {"silu"} if act == "swiglu" else {"gelu_tanh"})


def test_hybrid_rec_gate_activation_bits_match_jax(recorder):
    """The hybrid `rec_step`'s GELU gate (`repro/models/hybrid.py:97`)."""
    cfg = get_arch("recurrentgemma-9b").reduced()
    p = _layer(init_params(cfg, seed=5, device=CPU)["blocks"]["rec_a"])
    g = torch.Generator().manual_seed(3)
    w = cfg.hybrid.lru_width
    x = torch.randn((4, cfg.d_model), generator=g).to(torch.bfloat16)
    h = torch.randn((4, w), generator=g)
    conv = torch.randn((4, 3, w), generator=g).to(torch.bfloat16)
    hybrid.rec_step(cfg, p, x, h, conv)
    _check(recorder, {"gelu_tanh"})


def test_op_by_op_activations_equal_jax_and_f_rounds_once():
    """65,536 bf16 inputs (standard normal x 4): `layers.silu` and
    `layers.gelu_tanh` give the jitted JAX activations' bits on every
    one; `F.silu` / `F.gelu(approximate="tanh")` (what the four sites
    called before) differ on thousands."""
    g = torch.Generator().manual_seed(0)
    x = (torch.randn(65536, generator=g) * 4).to(torch.bfloat16)
    for kind, ours, once in (
            ("silu", layers.silu, F.silu),
            ("gelu_tanh", layers.gelu_tanh,
             functools.partial(F.gelu, approximate="tanh"))):
        want = _jax_bits(kind, x)
        np.testing.assert_array_equal(_bits(ours(x)), want, err_msg=kind)
        assert (_bits(once(x)) != want).sum() > 1000, kind


def test_fused_xla_expert_ffn_rounds_silu_op_by_op():
    """Inside a jitted `silu(x @ a) * (x @ b)` (the expert FFN's shape,
    one XLA fusion) the compiled JAX code still rounds silu op by op: the
    port's `layers.silu(g) * u` on the same bf16 products gives its bits
    on all 8,192 outputs, `F.silu` does not."""
    rng = np.random.default_rng(0)
    E, M, K, N = 8, 16, 128, 64
    x = jnp.asarray(rng.standard_normal((E, M, K)), jnp.bfloat16)
    a, b = (jnp.asarray(rng.standard_normal((E, K, N)) / np.sqrt(K),
                        jnp.bfloat16) for _ in range(2))
    mm = jax.jit(lambda x, w: jnp.einsum("emk,ekn->emn", x, w))
    fused = jax.jit(lambda x, a, b: jax.nn.silu(mm(x, a)) * mm(x, b))
    want = np.asarray(fused(x, a, b)).view(np.int16)

    def t(arr):
        return torch.from_numpy(np.asarray(arr).view(np.int16).copy()
                                ).view(torch.bfloat16)

    g, u = t(mm(x, a)), t(mm(x, b))
    np.testing.assert_array_equal(_bits(layers.silu(g) * u), want)
    assert (_bits(F.silu(g) * u) != want).sum() > 1000
