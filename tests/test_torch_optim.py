"""The port's optimizers and LR schedules held against `repro.optim`.

Both packages compute in float32 here (no bf16 op is involved), so the
JAX side runs in this process.

Tolerances:
- schedules: relative 1e-6 at steps 0..120;
- AdamW and AMC-Adam, 5 steps on the same float32 params and grads:
  float32 moments, scales and params relative 1e-6 (elementwise, against
  the largest entry of the leaf); the int8 moments equal, or one level
  apart only at an entry whose pre-round value lies within 1e-5 of a .5
  boundary (counted; the count is printed and is 0 for these seeds);
- tracking: AMC-Adam's params within 0.2x AdamW's largest move after 10
  steps (`tests/test_integration.py::test_amc_adam_tracks_adamw`).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro_torch import optim as toptim
from repro_torch.optim import adamw as tadamw

SHAPES = {"w": (64, 48), "stack": (3, 16, 32), "bias": (48,)}
STEPS = 5
LR = 1e-2


def _max_rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("name", ["cosine", "wsd"])
def test_schedules_match_jax(name):
    kw = dict(peak_lr=3e-4, warmup=10, total=100)
    want = np.array([float(joptim.SCHEDULES[name](s, **kw))
                     for s in range(121)], np.float32)
    got = np.array([float(toptim.SCHEDULES[name](s, **kw))
                    for s in range(121)], np.float32)
    assert _max_rel(got, want) < 1e-6
    # a step tensor (the train state's) gives the same float32 values
    got_t = np.array([float(toptim.SCHEDULES[name](
        torch.tensor(s, dtype=torch.int32), **kw)) for s in range(121)],
        np.float32)
    np.testing.assert_array_equal(got_t, got)


def _inputs(seed: int):
    rng = np.random.default_rng(seed)
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()}
    grads = [{k: (rng.standard_normal(s) * 10.0 ** rng.integers(-3, 1))
              .astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(STEPS)]
    return params, grads


def _torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def test_adamw_exact_math():
    params, grads = _inputs(0)
    jp, tp = {k: jnp.asarray(v) for k, v in params.items()}, _torch(params)
    js, ts = joptim.adamw_init(jp), toptim.adamw_init(tp)
    for g in grads:
        jp, js = joptim.adamw_update({k: jnp.asarray(v) for k, v in g.items()},
                                     js, jp, lr=LR)
        tp, ts = toptim.adamw_update(_torch(g), ts, tp, lr=LR)
        for k in SHAPES:
            assert _max_rel(tp[k], jp[k]) < 1e-6, k
            assert _max_rel(ts.m[k], js.m[k]) < 1e-6, k
            assert _max_rel(ts.v[k], js.v[k]) < 1e-6, k
    assert int(ts.step) == int(js.step) == STEPS
    assert ts.step.dtype == torch.int32


def _pre_round(ts_prev, g, which: str) -> dict:
    """The float value each int8 moment entry rounds, divided by its new
    scale: `_q_write`'s x / scale on the port's side."""
    out = {}
    for k in SHAPES:
        gf = torch.from_numpy(np.array(g[k]))
        m = tadamw._q_read(ts_prev.m_q[k], ts_prev.m_scale[k])
        v = tadamw._q_read(ts_prev.v_q[k], ts_prev.v_scale[k]) ** 2
        m = 0.9 * m + (1 - 0.9) * gf
        v = 0.95 * v + (1 - 0.95) * gf * gf
        x = m if which == "m" else torch.sqrt(v)
        _, scale = tadamw._q_write(x)
        out[k] = (x / scale).numpy()
    return out


def test_amc_adamw_exact_math():
    params, grads = _inputs(1)
    jp, tp = {k: jnp.asarray(v) for k, v in params.items()}, _torch(params)
    js, ts = joptim.amc_adamw_init(jp), toptim.amc_adamw_init(tp)
    near_ties = 0
    for g in grads:
        prev = tadamw.AMCAdamState(
            ts.step, *({k: v.clone() for k, v in t.items()}
                       for t in (ts.m_q, ts.m_scale, ts.v_q, ts.v_scale)))
        jp, js = joptim.amc_adamw_update(
            {k: jnp.asarray(v) for k, v in g.items()}, js, jp, lr=LR)
        tp, ts = toptim.amc_adamw_update(_torch(g), ts, tp, lr=LR)
        for which, tq, jq in (("m", ts.m_q, js.m_q), ("v", ts.v_q, js.v_q)):
            pre = _pre_round(prev, g, which)
            for k in SHAPES:
                assert tq[k].dtype == torch.int8
                d = tq[k].numpy().astype(np.int32) - np.asarray(jq[k],
                                                                np.int32)
                off = d != 0
                assert (np.abs(d) <= 1).all(), (which, k)
                frac = np.abs(np.abs(pre[k][off]) % 1.0 - 0.5)
                assert (frac < 1e-5).all(), (which, k, frac)
                near_ties += int(off.sum())
        for k in SHAPES:
            assert _max_rel(tp[k], jp[k]) < 1e-6, k
            assert _max_rel(ts.m_scale[k], js.m_scale[k]) < 1e-6, k
            assert _max_rel(ts.v_scale[k], js.v_scale[k]) < 1e-6, k
            assert ts.m_scale[k].shape == tuple(SHAPES[k][:-1]) + (1,)
    print(f"int8 moment entries one level apart at a .5 tie: {near_ties}")


def test_amc_adam_tracks_adamw():
    """Quantized-state Adam follows float32 Adam closely."""
    gen = torch.Generator().manual_seed(0)
    p = {"w": torch.randn((64, 64), generator=gen)}
    s_a, s_b = toptim.adamw_init(p), toptim.amc_adamw_init(p)
    pa = {"w": p["w"].clone()}
    pb = {"w": p["w"].clone()}
    for _ in range(10):
        g = {"w": torch.randn((64, 64), generator=gen)}
        pa, s_a = toptim.adamw_update(g, s_a, pa, lr=1e-2)
        pb, s_b = toptim.amc_adamw_update(g, s_b, pb, lr=1e-2)
    diff = float((pa["w"] - pb["w"]).abs().max())
    scale = float((pa["w"] - p["w"]).abs().max())
    assert diff < 0.2 * scale, (diff, scale)


def test_amc_state_is_a_quarter_of_adamw():
    """AMC-Adam stores 1 + 1 bytes a parameter plus one float32 scale a
    row for each moment; AdamW 4 + 4."""
    from repro_torch.models.params import tree_nbytes
    p = {"w": torch.zeros((256, 1024), dtype=torch.bfloat16)}
    a = toptim.adamw_init(p)
    b = toptim.amc_adamw_init(p)
    nb = lambda s: sum(tree_nbytes(t) for t in s[1:])
    assert nb(a) == 8 * 256 * 1024
    assert nb(b) == 2 * 256 * 1024 + 2 * 4 * 256


@pytest.mark.parametrize("kind", ["adamw", "amc_adamw"])
def test_make_optimizer(kind):
    init, update = toptim.make_optimizer(kind)
    assert init is getattr(toptim, f"{kind}_init")
    assert update is getattr(toptim, f"{kind}_update")
    with pytest.raises(KeyError):
        toptim.make_optimizer("sgd")


def test_update_runs_in_place_under_no_grad():
    p = {"w": torch.ones((4, 4), requires_grad=True)}
    s = toptim.adamw_init(p)
    w = p["w"]
    p2, _ = toptim.adamw_update({"w": torch.ones((4, 4))}, s, p, lr=0.1)
    assert p2["w"] is w and not torch.equal(w.detach(), torch.ones(4, 4))
