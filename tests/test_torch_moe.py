"""The moe family of the port (qwen3-moe-30b-a3b, grok-1-314b's config)
held against the JAX package, in this process.

- Configs: every field, the `moe` block included, at full size and
  reduced.
- `models/moe.py`: the routing decisions (each token's top-k expert ids
  and which of them keep a capacity slot) equal JAX's exactly, at group
  sizes 1 and 512 and with capacity drops; `moe_ffn`'s output within
  rel_err 1e-2 of `repro.models.moe.moe_ffn` on the same bf16 inputs and
  weights (two frameworks' float32 sums of bf16 products, then one bf16
  rounding). The ports of tests/test_system.py:128 (identical experts
  give the dense FFN, atol 3e-2 as there) and :145 (capacity drops).
- `augment.expert_proj`: dense banks, ternary banks and the imc route at
  abits 1, 4 and 8 against the JAX package's (its oracle route per
  expert), rel_err 1e-2 (imc 2e-2, the random-row tolerance of
  tests/test_torch_imc.py).
- `augment_params` / `dequant_params` on the moe tree: packed bytes and
  scales bit-equal in ternary mode (the port of tests/test_imc.py:324),
  the expert banks left dense in dual mode.
The paged steps are in tests/test_torch_moe_steps.py, the engines in
tests/test_torch_moe_serve.py.
- `model_decode_matmuls` equal to JAX's; the store registry's moe row
  (tests/test_state_store.py:284); the unified engine's pinned moe
  goldens (tests/test_scheduler.py:254) from the JAX engine's weights.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.imc import energy as jenergy
from repro.kernels import ref
from repro.models import augment as jaug
from repro.models import model as jm
from repro.models import moe as jmoe
from repro.models.params import init_params as jax_init_params
from repro_torch.configs import get_arch
from repro_torch.configs.registry import NOT_YET_PORTED
from repro_torch.imc import energy as tenergy
from repro_torch.kernels import ops
from repro_torch.models import augment as taug
from repro_torch.models import model as tm
from repro_torch.models import moe as tmoe
from repro_torch.models.params import (abstract_params, from_numpy_tree,
                                       init_params)
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve import cache_pool as tpool_mod
from repro_torch.serve.state_store import make_step_fns, make_store

CPU = torch.device("cpu")
ARCH = "qwen3-moe-30b-a3b"
# the reduced config has 8 experts; qwen3's q/k norm needs 64 or more
VARIANTS = {"reduced": {}, "e64": {"n_experts": 64, "top_k": 8}}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny tensors: torch's intra-op threads only contend with XLA's."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tt(a) -> torch.Tensor:
    return from_numpy_tree(np.asarray(a), CPU)


def f32(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def cfgs(variant="reduced", moe=None, **amc):
    """(JAX, port) reduced configs of the variant, `moe` fields and `amc`
    fields replaced on both."""
    out = []
    for get in (jax_get_arch, get_arch):
        c = get(ARCH).reduced()
        c = dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, **{**VARIANTS[variant], **(moe or {})}),
            amc=dataclasses.replace(c.amc, **amc))
        out.append(c)
    return out


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "grok-1-314b"])
@pytest.mark.parametrize("full", [True, False])
def test_config_matches_jax(arch, full):
    j, t = jax_get_arch(arch), get_arch(arch)
    if not full:
        j, t = j.reduced(), t.reduced()
    for f in ("name", "family", "n_layers", "d_model", "n_heads",
              "n_kv_heads", "d_ff", "vocab", "hd", "vocab_padded",
              "qkv_bias", "rope_theta", "norm_eps", "tie_embeddings", "act",
              "source"):
        assert getattr(t, f) == getattr(j, f), f
    assert dataclasses.asdict(t.moe) == dataclasses.asdict(j.moe)
    for f in ("weight_mode", "kv_mode", "aug_bits", "resolved_pool_mode"):
        assert getattr(t.amc, f) == getattr(j.amc, f), f
    assert arch not in NOT_YET_PORTED


def test_params_declare_the_jax_tree():
    """Leaf paths and shapes of the dense moe tree equal JAX's, q/k norm
    present exactly at >= 64 experts; `init_params` draws the banks in
    bf16, one layer at a time, at JAX's 1/sqrt(fan_in) scale."""
    for variant in VARIANTS:
        jc, tc = cfgs(variant)
        jt = jax.tree.map(lambda s: tuple(s.shape), jm.abstract_params(jc),
                          is_leaf=lambda x: hasattr(x, "shape"))
        tt_ = jax.tree.map(lambda s: tuple(s.shape), abstract_params(tc),
                           is_leaf=lambda x: hasattr(x, "shape"))
        assert tt_ == jt
        assert ("q_norm" in tt_["layers"]["attn"]) == (variant == "e64")
    _, tc = cfgs("e64")
    p = init_params(tc, seed=0, device="cpu")
    bank = p["layers"]["moe"]["w_up"]
    assert bank.dtype == torch.bfloat16 and bank.dim() == 4
    fan = math.prod(bank.shape[:-1])
    assert abs(float(bank.float().std()) * math.sqrt(fan) - 1.0) < 0.05
    assert not torch.equal(bank[0], bank[1])


# ---------------------------------------------------------------------------
# models/moe.py
# ---------------------------------------------------------------------------

def jit(fn, *args):
    """fn(*args) compiled: the JAX package's eager forms of these calls
    dispatch op by op and take seconds each at these sizes."""
    return jax.jit(fn)(*args)


def jax_init(tree, seed):
    return jit(lambda k: jax_init_params(tree, k), jax.random.PRNGKey(seed))


def jax_moe_ffn(cfg, p, x, group_size=512):
    return jit(lambda p_, x_: jmoe.moe_ffn(cfg, p_, x_,
                                           group_size=group_size),
               {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))


def moe_layer(cfg, seed):
    """One layer's moe weights from the JAX initialiser, layer dim
    dropped, as numpy (bf16 leaves stay bf16)."""
    p = jax_init(jmoe.moe_pspecs(cfg, 1), seed)
    return {k: np.asarray(v[0]) for k, v in p.items()}


def jax_routing(cfg, p, x, group_size):
    """The routing lines of `repro.models.moe.moe_ffn`, evaluated here:
    each token's top-k ids ascending and whether each keeps a slot."""
    moe = cfg.moe
    B, S, d = x.shape
    E, k, cf = moe.n_experts, moe.top_k, moe.capacity_factor
    T = B * S
    sg = min(group_size, T)
    G = T // sg
    C = max(1, math.ceil(sg * k * cf / E))
    xs = jnp.asarray(x).reshape(G, sg, d)
    logits = xs.astype(jnp.float32) @ jnp.asarray(p["router"]).astype(
        jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    _, top_i = jax.lax.top_k(probs, k)
    mask = jax.nn.one_hot(top_i, E, dtype=jnp.float32).sum(axis=2)
    pos = jnp.cumsum(mask, axis=1) - 1.0
    keep = np.asarray((pos < C) * mask) > 0
    ids = np.sort(np.asarray(top_i), axis=-1)
    return ids, np.take_along_axis(keep, ids, axis=-1)


def moe_case(cfg, seed, B, S, scale=1.0):
    p = moe_layer(cfg, seed)
    rng = np.random.default_rng(seed)
    x = np.asarray(jnp.asarray(rng.standard_normal((B, S, cfg.d_model))
                               * scale, jnp.bfloat16))
    return p, x


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("group_size,B,S,cf", [
    (1, 2, 8, 1.25), (512, 4, 256, 1.25), (512, 2, 256, 0.5)])
def test_moe_ffn_matches_jax(variant, group_size, B, S, cf):
    """Routing decisions exactly, output within rel_err 1e-2, on both of
    the port's product routes (torch.bmm, and the expert GEMM's plain
    version where an augmented tree's decode step takes the kernel)."""
    jc, tc = cfgs(variant, moe={"capacity_factor": cf})
    p, x = moe_case(jc, 11 + B + S, B, S)
    want = jax_moe_ffn(jc, p, x, group_size)
    ids, keep = jax_routing(jc, p, x, group_size)
    tp = from_numpy_tree(p, CPU)
    sg = min(group_size, B * S)
    got_i, _, _, got_keep = tmoe.route(tc, tp, tt(x).reshape(-1, sg,
                                                              tc.d_model))
    np.testing.assert_array_equal(got_i.numpy(), ids)
    np.testing.assert_array_equal(got_keep.numpy(), keep)
    if cf < 1:
        assert not keep.all()           # the capacity drops were hit
    for augmented in (False, True):
        got = tmoe.moe_ffn(tc, tp, tt(x), group_size=group_size,
                           augmented=augmented)
        assert got.dtype == torch.bfloat16 and got.shape == x.shape
        assert ref.rel_err(f32(got), f32(want)) < 1e-2


def test_moe_identity_when_experts_equal():
    """tests/test_system.py:128: all experts share weights and no token
    is dropped (capacity factor 8), so the output is the one-expert FFN
    (atol 3e-2, as there) and JAX's (rel_err 1e-2)."""
    jc, tc = cfgs(moe={"n_experts": 4, "top_k": 2, "capacity_factor": 8.0})
    jc = dataclasses.replace(jc, d_model=16, d_ff=32)
    tc = dataclasses.replace(tc, d_model=16, d_ff=32)
    p = moe_layer(jc, 0)
    for name in ("w_gate", "w_up", "w_down"):
        p[name] = np.broadcast_to(p[name][:1], p[name].shape).copy()
    rng = np.random.default_rng(1)
    x = np.asarray(jnp.asarray(rng.standard_normal((2, 8, 16)) * 0.1,
                               jnp.bfloat16))
    got = tmoe.moe_ffn(tc, from_numpy_tree(p, CPU), tt(x))
    wg, wu, wd = (tt(p[n][0]).float() for n in ("w_gate", "w_up", "w_down"))
    xf = tt(x).float()
    expect = (torch.nn.functional.silu(xf @ wg) * (xf @ wu)) @ wd
    assert np.allclose(f32(got), expect.numpy(), atol=3e-2)
    want = jax_moe_ffn(jc, p, x)
    assert ref.rel_err(f32(got), f32(want)) < 1e-2


def test_moe_capacity_drops_tokens():
    """tests/test_system.py:145: every token steered to expert 0 (top-1,
    capacity ceil(16 * 0.26 / 4) = 2): 1-4 of 16 tokens survive. Tokens
    whose logits tie at zero go to expert 1, as jax.lax.top_k breaks
    ties. Positions past the capacity are masked before the gather (a
    one-hot of them would raise in torch)."""
    jc, tc = cfgs(moe={"n_experts": 4, "top_k": 1, "capacity_factor": 0.26})
    jc = dataclasses.replace(jc, d_model=16, d_ff=32)
    tc = dataclasses.replace(tc, d_model=16, d_ff=32)
    p = moe_layer(jc, 0)
    p["router"] = np.zeros_like(p["router"])
    p["router"][:, 0] = 10.0
    rng = np.random.default_rng(2)
    x = np.asarray(jnp.asarray(rng.standard_normal((1, 16, 16)),
                               jnp.bfloat16))
    got = tmoe.moe_ffn(tc, from_numpy_tree(p, CPU), tt(x))
    nonzero = np.abs(f32(got)).sum(-1) > 1e-6
    assert 1 <= nonzero.sum() <= 4, nonzero.sum()
    want = jax_moe_ffn(jc, p, x)
    np.testing.assert_array_equal(nonzero,
                                  np.abs(f32(want)).sum(-1) > 1e-6)
    assert ref.rel_err(f32(got), f32(want)) < 1e-2
    _, _, pos, keep = tmoe.route(tc, from_numpy_tree(p, CPU),
                                 tt(x).reshape(1, 16, 16))
    assert int(pos.max()) >= 2 and int(keep.sum()) < 16


def test_written_row_does_not_compete_with_pad_rows():
    """A prefill chunk computes every row of the dispatch but writes one.
    With `rows`, only the written row's tokens take capacity slots: its
    output is the same bits whatever the other rows hold (in the JAX
    package the pad rows take slots too, so a request's prefill depends
    on its neighbours, and speculative and stepwise runs, whose
    neighbours differ, part). The pad rows' outputs are zeros."""
    _, tc = cfgs(moe={"capacity_factor": 0.5})
    p, x = moe_case(tc, 4, 4, 32)
    tp, tx = from_numpy_tree(p, CPU), tt(x)
    rows = torch.tensor([False, False, True, False])
    want = tmoe.moe_ffn(tc, tp, tx, rows=rows)
    assert not want[~rows].any()
    g = torch.Generator().manual_seed(0)
    for _ in range(3):
        other = torch.randn(tx.shape, generator=g).to(torch.bfloat16)
        other[2] = tx[2]
        assert torch.equal(tmoe.moe_ffn(tc, tp, other, rows=rows)[2],
                           want[2])
    # without the mask the pad rows (zeros in every row here) crowd the
    # experts they pick and the written row loses slots
    pads = torch.zeros_like(tx)
    pads[2] = tx[2]
    assert not torch.equal(tmoe.moe_ffn(tc, tp, pads)[2], want[2])


def test_prefill_logits_do_not_depend_on_neighbour_rows():
    """The paged prefill step: the written row's logits are the same bits
    whatever the other rows' tokens and positions."""
    _, tc = cfgs(weight_mode="dual", kv_mode="int4")
    params = taug.augment_params(tc, init_params(dataclasses.replace(
        tc, amc=dataclasses.replace(tc.amc, weight_mode="normal")),
        seed=1, device="cpu"))
    B, Cn = 4, 8
    rng = np.random.default_rng(5)
    toks = rng.integers(0, tc.vocab, size=(Cn,)).astype(np.int32)
    outs = []
    for trial in range(2):
        pool = tpool_mod.PagedKVPool(tc, max_batch=B, max_seq=48,
                                     device=CPU)
        for r in range(B):
            assert pool.admit_row(r, 24, step=0)
        tok = rng.integers(0, tc.vocab, size=(B, Cn)).astype(np.int32) \
            if trial else np.zeros((B, Cn), np.int32)
        tok[1] = toks
        pos = np.array([0, 0, 8, 16], np.int32) if trial \
            else np.zeros(B, np.int32)
        lg, _ = tm.paged_prefill_step(tc, params, pool.arenas, {
            **pool.device_tables(), "tokens": torch.from_numpy(tok),
            "positions": torch.from_numpy(pos),
            "write_mask": torch.tensor([False, True, False, False])})
        outs.append(lg[1])
    assert torch.equal(outs[0], outs[1])


# ---------------------------------------------------------------------------
# augment.expert_proj and the weight transforms
# ---------------------------------------------------------------------------

def bank_case(seed, E=4, M=6, K=128, N=64):
    rng = np.random.default_rng(seed)
    xe = np.asarray(jnp.asarray(rng.standard_normal((E, M, K)),
                                jnp.bfloat16))
    w = np.asarray(jnp.asarray(rng.standard_normal((E, K, N)) / K ** 0.5,
                               jnp.bfloat16))
    return xe, w


@pytest.mark.parametrize("augmented,fixed_order", [
    (True, True), (True, False), (False, True)])
def test_expert_proj_dense_bank_matches_jax(augmented, fixed_order):
    xe, w = bank_case(3)
    want = jaug.expert_proj({"w": jnp.asarray(w)}, "w", jnp.asarray(xe))
    got = taug.expert_proj({"w": tt(w)}, "w", tt(xe), None,
                           augmented=augmented, fixed_order=fixed_order)
    assert got.dtype == torch.bfloat16
    assert ref.rel_err(f32(got), f32(want)) < 1e-2
    if augmented and fixed_order:       # the kernel's plain version here
        torch.testing.assert_close(
            got, ops.expert_matmul(tt(xe), tt(w), plain=True), rtol=0,
            atol=0)


def ternary_bank(seed, E=4, K=128, N=64):
    _, w = bank_case(seed, E=E, K=K, N=N)
    packed, scale = jaug._ternary_pack(jnp.asarray(w))
    return np.asarray(packed), np.asarray(scale)


@pytest.mark.parametrize("impl,abits", [("dense", 8), ("packed", 8),
                                        ("imc", 1), ("imc", 4),
                                        ("imc", 8)])
def test_expert_proj_ternary_bank_matches_jax(impl, abits):
    """A 2-bit bank per expert: the expert GEMM's 2-bit mode (plain
    version on the CPU) and its "dense" route against JAX's
    `expert_proj` on its oracle route; "imc" expert by expert against
    `imc_dot`'s oracle (`kernels/ref.py`) at each activation precision."""
    xe, _ = bank_case(5)
    packed, scale = ternary_bank(6)
    jp = {"w_packed": jnp.asarray(packed), "w_scale": jnp.asarray(scale)}
    tp = {"w_packed": tt(packed), "w_scale": tt(scale)}
    _, tc = cfgs(matmul_impl=impl, imc_abits=abits)
    got = taug.expert_proj(tp, "w", tt(xe), tc.amc, augmented=True)
    if impl == "imc":
        # the oracle called eagerly: jitted, XLA may take x * (1 / xs)
        # and move a quantization tie by one level
        want = jnp.stack([ref.imc_dot_ref(jnp.asarray(xe[e]),
                                          jp["w_packed"][e],
                                          jp["w_scale"][e], fmt="ternary",
                                          abits=abits)
                          for e in range(xe.shape[0])])
        tol = 2e-2
    else:
        jc, _ = cfgs(matmul_impl="dense")
        want = jaug.expert_proj(jp, "w", jnp.asarray(xe), jc.amc)
        tol = 1e-2
    assert got.shape == (4, 6, 64) and got.dtype == torch.bfloat16
    assert ref.rel_err(f32(got), f32(want)) < tol


@pytest.fixture(scope="module")
def dense_trees():
    """The reduced and 64-expert dense trees from the JAX initialiser."""
    out = {}
    for variant in VARIANTS:
        jc, _ = cfgs(variant, weight_mode="normal")
        out[variant] = jax.tree.map(np.asarray, jax_init(
            jm.abstract_params(jc), 7))
    return out


def _np_leaf(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("mode", ["ternary", "dual"])
def test_augment_and_dequant_params_match_jax(dense_trees, variant, mode):
    """The port of tests/test_imc.py:324: ternary mode packs the 4-D
    expert banks (bytes and scales bit-equal to JAX's); dual mode pairs
    wk/wv only and leaves the banks dense, as JAX does; the dequantized
    trees are bit-equal."""
    jc, tc = cfgs(variant, weight_mode=mode)
    dense = dense_trees[variant]
    # eager, as the JAX engine packs (compiled, XLA may take amax / 7 as
    # amax * (1 / 7) and move a scale by an ulp)
    jpk = jax.tree.map(np.asarray, jaug.augment_params(
        jc, jax.tree.map(jnp.asarray, dense)))
    tpk = taug.augment_params(tc, from_numpy_tree(dense, CPU))
    for g in ("attn", "moe"):
        assert sorted(tpk["layers"][g]) == sorted(jpk["layers"][g]), g
        for k, v in jpk["layers"][g].items():
            np.testing.assert_array_equal(
                _np_leaf(tpk["layers"][g][k]),
                v.astype(np.float32) if v.dtype.name == "bfloat16" else v,
                err_msg=f"{g}/{k}")
    moe_p = tpk["layers"]["moe"]
    if mode == "ternary":
        assert moe_p["w_up_packed"].dtype == torch.uint8
        assert moe_p["w_up_packed"].shape[-2] * 4 == tc.d_model
        assert "w_up" not in moe_p and "router" in moe_p
    else:
        assert "wkv_buf" in tpk["layers"]["attn"]
        for k in ("w_gate", "w_up", "w_down", "router"):
            assert torch.equal(moe_p[k], tt(dense["layers"]["moe"][k]))
    jd = jit(lambda t: jaug.dequant_params(jc, t),
             jax.tree.map(jnp.asarray, jpk))
    td = taug.dequant_params(tc, tpk)
    for g in ("attn", "moe"):
        for k, v in jd["layers"][g].items():
            np.testing.assert_array_equal(_np_leaf(td["layers"][g][k]),
                                          f32(v), err_msg=f"{g}/{k}")


# ---------------------------------------------------------------------------
# the expert GEMM's wrapper (the kernel runs only on the card)
# ---------------------------------------------------------------------------

def test_expert_matmul_plain_is_one_expert_at_a_time():
    """The plain version: each expert's rows are the one-expert plain
    products (`dense_matmul_plain` in f32 out, `ternary_matmul_plain`),
    and the f32 out is x.float() @ w.float() unrounded."""
    from repro_torch.kernels.ternary_matmul import (dense_matmul_plain,
                                                    expert_matmul_plain,
                                                    ternary_matmul_plain)
    xe, w = bank_case(8)
    xe, w = tt(xe), tt(w)
    f32 = expert_matmul_plain(xe, w, out_dtype=torch.float32)
    bf = ops.expert_matmul(xe, w)
    for e in range(xe.shape[0]):
        want = dense_matmul_plain(xe[e], w[e], out_dtype=torch.float32)
        assert torch.equal(f32[e], want)
        assert torch.equal(bf[e], want.to(torch.bfloat16))
    packed, scale = map(tt, ternary_bank(9))
    got = ops.expert_matmul(xe, packed, scale.reshape(4, -1))
    for e in range(xe.shape[0]):
        assert torch.equal(got[e], ternary_matmul_plain(xe[e], packed[e],
                                                        scale[e]))


def test_expert_matmul_wrapper_hands_the_library_its_operands(monkeypatch):
    """What the wrapper passes the C entry: the per-expert M, K, N, the
    split from (K, N) alone (the one-expert entries' split), E, the
    2-bit flag and the f32 flag; it refuses CPU tensors, a grid past
    65535 row tiles and K or N off the 64 tiles (grok's router, N = 8),
    and counts one launch a call."""
    from repro_torch.kernels import build
    from repro_torch.kernels import ternary_matmul as tmm
    calls = []

    class Fake:
        def expert_matmul(self, *args):
            assert len(args) == len(build.SIGNATURES["expert_matmul"])
            calls.append(args)
            return 0

        def dense_matmul(self, *args):
            assert len(args) == len(build.SIGNATURES["dense_matmul"])
            calls.append(args)
            return 0

    monkeypatch.setattr(tmm, "library", lambda: Fake())
    monkeypatch.setattr(tmm.torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0}))
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    before = tmm.expert_matmul_cuda.launches
    for E, M, K, N in ((128, 4, 2048, 768), (128, 16, 768, 2048),
                       (8, 1, 128, 64)):
        x = torch.zeros((E, M, K), dtype=torch.bfloat16)
        w = torch.zeros((E, K, N), dtype=torch.bfloat16)
        y = tmm.expert_matmul_cuda(x, w)
        assert y.shape == (E, M, N) and y.dtype == torch.bfloat16
        assert calls[-1][4:-1] == (M, K, N, tmm.split_plan(K, N), E, 0, 0)
        wt = torch.zeros((E, K // 4, N), dtype=torch.uint8)
        sc = torch.ones((E, N), dtype=torch.float32)
        y = tmm.expert_matmul_cuda(x, wt, sc, out_dtype=torch.float32)
        assert y.dtype == torch.float32
        assert calls[-1][2] == sc.data_ptr()
        assert calls[-1][4:-1] == (M, K, N, tmm.split_plan(K, N), E, 1, 1)
    assert tmm.expert_matmul_cuda.launches == before + 6
    for f32 in (0, 1):               # the router's f32 flag rides before y
        tmm.dense_matmul_cuda(torch.zeros((4, 2048), dtype=torch.bfloat16),
                              torch.zeros((2048, 128), dtype=torch.bfloat16),
                              out_dtype=(torch.float32 if f32
                                         else torch.bfloat16))
        assert calls[-1][2] == f32
        assert calls[-1][4:-1] == (4, 2048, 128, tmm.split_plan(2048, 128),
                                   0)
    with pytest.raises(ValueError, match="65535"):   # 32768 x 2 tiles
        tmm.expert_matmul_cuda(
            torch.zeros((1, 1, 64), dtype=torch.bfloat16).expand(
                32768, 65, 64),
            torch.zeros((1, 64, 64), dtype=torch.bfloat16).expand(
                32768, 64, 64))
    with pytest.raises(ValueError, match="multiples"):
        tmm.dense_matmul_cuda(torch.zeros((4, 6144), dtype=torch.bfloat16),
                              torch.zeros((6144, 8), dtype=torch.bfloat16),
                              out_dtype=torch.float32)
    monkeypatch.undo()
    with pytest.raises(ValueError, match="CUDA"):
        tmm.expert_matmul_cuda(torch.zeros((2, 4, 64), dtype=torch.bfloat16),
                               torch.zeros((2, 64, 64), dtype=torch.bfloat16))


# ---------------------------------------------------------------------------
# energy, store registry, the unified engine's pinned goldens
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "grok-1-314b"])
@pytest.mark.parametrize("mode", ["dual", "ternary", "normal"])
def test_model_decode_matmuls_match_jax(arch, mode):
    for full in (True, False):
        j, t = jax_get_arch(arch), get_arch(arch)
        if not full:
            j, t = j.reduced(), t.reduced()
        j = dataclasses.replace(j, amc=dataclasses.replace(
            j.amc, weight_mode=mode))
        t = dataclasses.replace(t, amc=dataclasses.replace(
            t.amc, weight_mode=mode))
        assert tenergy.model_decode_matmuls(t) == \
            jenergy.model_decode_matmuls(j)
        assert tenergy.decode_matmul_events(t, 3) == \
            jenergy.decode_matmul_events(j, 3)


def test_store_registry_gives_moe_the_paged_pool():
    """tests/test_state_store.py:284's moe row: a paged store with the
    whole interface, and the paged decode / prefill / verify steps."""
    cfg = get_arch(ARCH).reduced()
    store = make_store(cfg, max_batch=2, max_seq=32, device=CPU)
    assert store.kind == "paged"
    for name in ("can_admit_tokens", "admit_row", "ensure_position",
                 "release_row", "note_token_writes", "refresh_due",
                 "refresh", "max_augmented_age", "device_tables",
                 "read_value_counts", "write_value_counts",
                 "physical_bytes", "describe"):
        assert callable(getattr(store, name)), name
    assert store.budget_bytes > 0 and store.live_bytes == 0
    fns = make_step_fns(cfg)
    assert all(fns[k] is not None for k in ("decode", "prefill", "verify"))


def test_unified_engine_matches_pre_refactor_golden():
    """tests/test_scheduler.py:254's moe row: the JAX engine's seed-0
    weights (carried across), prompts default_rng(42) of lengths 5 and 9,
    max_batch 2, max_seq 32, chunk 8, 6 new tokens, dual weights and
    int4 KV as the config sets them: the pinned tokens, up to request
    1's fifth token. There the JAX engine's own two routes part: its
    top-1/top-2 margin is 0.031 on the kernel route (the pinned 300) and
    0.0, an exact bf16 tie, on its reference route (217, as the port's),
    so no token from that step on is bound across frameworks."""
    cfg = get_arch(ARCH).reduced()
    jcfg = jax_get_arch(ARCH).reduced()
    dense_cfg = dataclasses.replace(jcfg, amc=dataclasses.replace(
        jcfg.amc, weight_mode="normal"))
    params = from_numpy_tree(jax.tree.map(np.asarray, jax_init_params(
        jm.abstract_params(dense_cfg), jax.random.PRNGKey(0))), CPU)
    rng = np.random.default_rng(42)
    prompts = [rng.integers(0, cfg.vocab, size=(n,)).astype(np.int32)
               for n in (5, 9)]
    eng = ServeEngine(cfg, device="cpu", params=params, max_batch=2,
                      max_seq=32, prefill_chunk=8)
    outs = eng.generate([Request(prompt=p, max_new_tokens=6, id=i)
                         for i, p in enumerate(prompts)])
    assert outs[0] == [263, 390, 55, 55, 55, 55]
    assert outs[1][:4] == [300, 316, 217, 300]
