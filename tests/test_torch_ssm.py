"""The ssm family (mamba2-130m) in the port, and the slab store's
speculative snapshot / rollback and retention-fault machinery, held
against the JAX package at the reduced config (2 layers, d_model 128,
d_inner 256 in 16 heads of 16, state 16, conv 4, vocab 512) on JAX's
seed-0 weights: config, parameter tree, the decode step, the slab planes
and their integrity words, `slab_verify`, and the engine at every pool
mode, speculating, under retention faults and traced.

The JAX side runs its own code: the ssm family reaches no Pallas call
and `augment_params` leaves its weights dense, so every JAX engine runs
in this process. They block on every dispatch: the JAX engine's stepwise
prefill bumps its numpy positions right after a dispatch, and on the CPU
backend the step in flight may still read that buffer.

Tolerances: config fields, tree shapes, byte accounting, pool and fault
counters, planes after the row ops and integrity words exact; the decode
step's logits within one bf16 ulp of the largest logit, its float32
ssd_state within rel_err 1e-5 and its bf16 conv ring within one bf16 ulp
(the port follows the compiled JAX step's roundings, `layers.sigmoid`; the
float32 sums and exp differ in the last ulp between the frameworks, and
a conv value now and then rounds the other way); `slab_verify`'s logits
as the decode step's, the rows it commits and their planes exact; engine
tokens exact on the JAX tests' own prompt seeds (the logits agree bit for
bit at almost every step, so even exact bf16 ties resolve alike).
`F.softplus` returns x above 20 where `jax.nn.softplus` does not; the
port takes `logaddexp`, as JAX does, so the two agree there too.
"""
import dataclasses
import itertools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import get_arch as jax_get_arch
from repro.configs.base import AMCConfig as JaxAMC
from repro.configs.base import ShapeConfig
from repro.core import faults as jfaults
from repro.imc import energy as jenergy
from repro.kernels import ref
from repro.models import model as jm
from repro.models import ssm as jssm
from repro.models.params import init_params as jax_init_params
from repro.models.params import is_pspec
from repro.obs import make_engine_obs as jax_make_engine_obs
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxServeEngine
from repro.serve import state_store as jstore
from repro_torch import obs as tobs
from repro_torch.configs import get_arch
from repro_torch.configs.base import AMCConfig
from repro_torch.core import faults as tfaults
from repro_torch.imc import energy
from repro_torch.models import augment
from repro_torch.models import model as tm
from repro_torch.models import ssm as tssm
from repro_torch.models.params import (abstract_params, from_numpy_tree,
                                       init_params)
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve import state_store as tstore

CPU = torch.device("cpu")
ARCH = "mamba2-130m"
MESH = jax.make_mesh((1, 1), ("data", "model"),
                     axis_types=(AxisType.Auto, AxisType.Auto))
TORCH_DTYPE = {jnp.dtype(jnp.uint8): torch.uint8,
               jnp.dtype(jnp.int8): torch.int8,
               jnp.dtype(jnp.bfloat16): torch.bfloat16,
               jnp.dtype(jnp.float32): torch.float32}


def cfg_pair(fresh: bool = False, **amc):
    """(JAX, port) reduced configs: the arch's AMC settings, or with
    `fresh` a default AMCConfig as tests/test_faults.py builds it, with
    `amc` on top."""
    j, t = jax_get_arch(ARCH).reduced(), get_arch(ARCH).reduced()
    ja, ta = (JaxAMC(), AMCConfig()) if fresh else (j.amc, t.amc)
    return (dataclasses.replace(j, amc=dataclasses.replace(ja, **amc)),
            dataclasses.replace(t, amc=dataclasses.replace(ta, **amc)))


def to_t(tree):
    return from_numpy_tree(jax.tree.map(np.asarray, tree), CPU)


def as_np(x) -> np.ndarray:
    """A JAX or torch array as numpy, bf16 widened to float32."""
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16
                      else x)


def keyed(tree) -> dict:
    return {jax.tree_util.keystr(p): v
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def jax_params():
    """JAX's seed-0 weights of the reduced config (dense: the family's
    weights are never packed)."""
    cfg, _ = cfg_pair(weight_mode="normal")
    return jax_init_params(jm.abstract_params(cfg), jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def torch_params(jax_params):
    return to_t(jax_params)


# ---------------------------------------------------------------------------
# config and parameter tree
# ---------------------------------------------------------------------------

def test_config_matches_jax():
    for full in (True, False):
        j, t = jax_get_arch(ARCH), get_arch(ARCH)
        if not full:
            j, t = j.reduced(), t.reduced()
        for f in ("name", "family", "n_layers", "d_model", "n_heads",
                  "n_kv_heads", "d_ff", "vocab", "head_dim", "hd",
                  "vocab_padded", "norm_eps", "tie_embeddings", "act",
                  "source"):
            assert getattr(t, f) == getattr(j, f), f
        assert dataclasses.asdict(t.ssm) == dataclasses.asdict(j.ssm)
        for f in ("weight_mode", "kv_mode", "pool_mode", "state_bits",
                  "retention_steps", "resolved_pool_mode"):
            assert getattr(t.amc, f) == getattr(j.amc, f), f
    full = get_arch(ARCH)
    assert (full.n_layers, full.d_model, full.vocab, full.vocab_padded) \
        == (24, 768, 50280, 50432)
    assert (full.ssm.state_dim, full.ssm.head_dim, full.ssm.chunk) \
        == (128, 64, 256)
    red = full.reduced()
    assert (red.n_heads, red.n_kv_heads, red.head_dim, red.hd) \
        == (0, 0, None, 128)


def test_from_numpy_tree_carries_the_jax_ssm_tree(jax_params):
    """Every leaf of JAX's `layers/<name>` tree arrives under the same
    path, shape and dtype as the port declares it, values intact; the
    port's inits are JAX's PSpec inits."""
    cfg, tcfg = cfg_pair()
    tp = to_t(jax_params)
    spec = keyed(abstract_params(tcfg))
    jspec = {jax.tree_util.keystr(p): s for p, s in
             jax.tree_util.tree_flatten_with_path(
                 jm.abstract_params(cfg), is_leaf=is_pspec)[0]}
    got = keyed(tp)
    assert sorted(got) == sorted(spec) == sorted(jspec) \
        == sorted(keyed(jax_params))
    for k, v in keyed(jax_params).items():
        assert tuple(got[k].shape) == v.shape == spec[k].shape, k
        assert got[k].dtype == TORCH_DTYPE[v.dtype] == spec[k].dtype, k
        np.testing.assert_array_equal(as_np(got[k]), as_np(v), err_msg=k)
        assert spec[k].init == jspec[k].init, k
    # weight_mode "ternary" packs the dense family only, as in JAX
    assert tcfg.amc.weight_mode == "ternary"
    assert augment.augment_params(tcfg, tp) is tp
    mine = keyed(init_params(tcfg, seed=0, device="cpu"))
    for k in ("['layers']['a_log']", "['layers']['dt_bias']",
              "['layers']['norm']", "['layers']['gate_norm']",
              "['final_norm']"):
        assert not mine[k].any(), k
    assert (mine["['layers']['d_skip']"] == 1).all()


# ---------------------------------------------------------------------------
# the decode step
# ---------------------------------------------------------------------------

def random_cache(normal: dict, seed: int) -> dict:
    """Random contents for a slab tree: float leaves at mixed magnitudes,
    a couple of all-zero vectors (amax 0) included."""
    rng = np.random.default_rng(seed)

    def fill(x):
        v = rng.standard_normal(x.shape) * rng.uniform(
            0.01, 3.0, x.shape[:-1] + (1,))
        v.reshape(-1, x.shape[-1])[:2] = 0.0
        return jnp.asarray(v, x.dtype)
    return jax.tree.map(fill, normal)


def zero_cache(cfg, B):
    spec = jm.abstract_cache(cfg, ShapeConfig("t", 32, B, "decode"))
    return jax.tree.map(lambda s: jnp.zeros(s.shape, s.jdtype), spec,
                        is_leaf=is_pspec)


def ulp_bf16(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def test_decode_step_matches_jax(jax_params, torch_params):
    """8 chained steps from a random state: the port's logits and new
    state against `repro.models.ssm.decode_step` (compiled, as the JAX
    engine runs it) on the same inputs at every step; the cache given is
    never written into."""
    cfg, tcfg = cfg_pair()
    B, V = 3, cfg.vocab
    jc = random_cache(zero_cache(cfg, B), 1)
    tc = to_t(jc)
    step = jax.jit(lambda p, c, t: jssm.decode_step(cfg, p, c, t, None))
    toks = np.random.default_rng(2).integers(0, V, size=(B, 8))
    for s in range(8):
        tok = toks[:, s:s + 1].astype(np.int32)
        jl, jc2 = step(jax_params, jc, jnp.asarray(tok))
        before = {k: v.clone() for k, v in tc.items()}
        tl, tc2 = tssm.decode_step(tcfg, torch_params, tc,
                                   torch.from_numpy(tok), None)
        for k in tc:
            assert torch.equal(tc[k], before[k]), f"step {s} wrote {k}"
        jl, tl = as_np(jl)[..., :V], as_np(tl)[..., :V]
        # within one bf16 ulp of the largest logit
        assert np.abs(tl - jl).max() <= ulp_bf16(np.abs(jl).max()), s
        assert ref.rel_err(as_np(tc2["ssd_state"]),
                           as_np(jc2["ssd_state"])) < 1e-5, s
        jconv = as_np(jc2["conv_state"])
        assert (np.abs(as_np(tc2["conv_state"]) - jconv)
                <= ulp_bf16(jconv)).all(), s
        jc, tc = jc2, to_t(jc2)


# ---------------------------------------------------------------------------
# slab planes, integrity words, the verify scan
# ---------------------------------------------------------------------------

def slab_pools(pool_mode, state_bits, B=3, fresh=False, **kw):
    cfg, tcfg = cfg_pair(fresh, pool_mode=pool_mode, state_bits=state_bits)
    jp = jstore.AugmentedStatePool(
        cfg, jm.abstract_cache(cfg, ShapeConfig("t", 32, B, "decode")),
        max_batch=B, **kw)
    tp = tstore.AugmentedStatePool(tcfg, tm.abstract_cache(tcfg, B, 32),
                                   max_batch=B, device=CPU, **kw)
    return jp, tp


def assert_planes_equal(jstate, tstate, where=""):
    assert sorted(jstate) == sorted(tstate), where
    want, got = keyed(jstate["normal"]), keyed(tstate["normal"])
    assert sorted(got) == sorted(want), where
    for k in want:
        assert got[k].dtype == TORCH_DTYPE[want[k].dtype], (where, k)
        np.testing.assert_array_equal(as_np(got[k]), as_np(want[k]),
                                      err_msg=f"{where} normal {k}")
    for plane in ("packed", "scale"):
        if plane not in jstate:
            continue
        assert sorted(tstate[plane]) == sorted(jstate[plane]), where
        for k, v in jstate[plane].items():
            assert tstate[plane][k].dtype == TORCH_DTYPE[v.dtype], \
                (where, plane, k)
            np.testing.assert_array_equal(as_np(tstate[plane][k]),
                                          as_np(v),
                                          err_msg=f"{where} {plane} {k}")


@pytest.mark.parametrize("state_bits", [8, 4])
@pytest.mark.parametrize("pool_mode", ["normal-only", "always-augmented",
                                       "augment-on-pressure"])
def test_slab_bytes_and_plane_ops_match_jax(pool_mode, state_bits):
    """Byte accounting and describe(); store_back (write-masked, mixed
    slot modes), reconstitute and the reset / augment / promote /
    corrupt / restore row ops give planes bit-identical to JAX's."""
    jp, tp = slab_pools(pool_mode, state_bits)
    for f in ("slab_bytes_normal", "slab_bytes_aug", "values_per_slot",
              "budget_bytes", "mixed", "pool_mode", "state_bits"):
        assert getattr(tp, f) == getattr(jp, f), f
    assert tp.physical_bytes() == jp.physical_bytes()
    assert tp.describe() == {k: jp.describe()[k] for k in tp.describe()}
    assert_planes_equal(jp.state, tp.state, "zeros")
    cache = random_cache(jp.state["normal"], state_bits)
    mixed = pool_mode != "normal-only"
    modes = np.array([1, 0, 1], np.int32) if mixed else None
    write = np.array([True, False, True])
    jmodes = None if modes is None else jnp.asarray(modes)
    tmodes = None if modes is None else torch.from_numpy(modes)
    js = jstore.slab_store_back(jp.state, cache, jmodes, state_bits,
                                write=jnp.asarray(write))
    ts = tstore.slab_store_back(tp.state, to_t(cache), tmodes, state_bits,
                                write=torch.from_numpy(write))
    assert_planes_equal(js, ts, "store_back")
    jr = keyed(jstore.slab_reconstitute(js, jmodes, state_bits))
    tr = keyed(tstore.slab_reconstitute(ts, tmodes, state_bits))
    for k in jr:
        np.testing.assert_array_equal(as_np(tr[k]), as_np(jr[k]))
    js = jstore._reset_row_op(js, 1)
    tstore._reset_row_op(ts, 1)
    assert_planes_equal(js, ts, "reset")
    if not mixed:
        return
    js = jstore._augment_row_op(js, 1, bits=state_bits)
    tstore._augment_row_op(ts, 1, bits=state_bits)
    assert_planes_equal(js, ts, "augment")
    saved = {k: np.asarray(v[:, 2]) for k, v in js["packed"].items()}
    ssaved = {k: np.asarray(v[:, 2]) for k, v in js["scale"].items()}
    js = jstore._corrupt_row_op(js, 2, 0xA5)
    tstore._corrupt_row_op(ts, 2, 0xA5)
    assert_planes_equal(js, ts, "corrupt")
    js = jstore._restore_row_op(js, 2, saved, ssaved)
    tstore._restore_row_op(ts, 2, {k: torch.from_numpy(v.copy())
                                   for k, v in saved.items()},
                           to_t(ssaved))
    assert_planes_equal(js, ts, "restore")
    js = jstore._promote_row_op(js, 2, bits=state_bits)
    tstore._promote_row_op(ts, 2, bits=state_bits)
    assert_planes_equal(js, ts, "promote")


@pytest.mark.parametrize("state_bits", [8, 4])
def test_integrity_words_equal_the_numpy_word(state_bits):
    """The device words of `_slab_words` are `core.faults.integrity_word`
    (the port's and the JAX package's) of the slab's packed and scale
    bytes, and the JAX pool's `_unit_word`, on random planes."""
    jp, tp = slab_pools("always-augmented", state_bits)
    rng = np.random.default_rng(state_bits)
    for plane in ("packed", "scale"):
        for k, v in jp.state[plane].items():
            if plane == "packed":
                info = np.iinfo(np.dtype(v.dtype))
                a = rng.integers(info.min, info.max + 1, v.shape)
            else:
                a = rng.uniform(0.01, 9.0, v.shape)
            jp.state[plane][k] = jnp.asarray(a, v.dtype)
    tp.state = {**tp.state, "packed": to_t(jp.state["packed"]),
                "scale": to_t(jp.state["scale"])}
    rows = [2, 0, 1]
    words = tp._slab_words(rows)
    for row, word in zip(rows, words):
        payload = []
        for k in sorted(jp.state["packed"]):
            payload += [np.asarray(jp.state["packed"][k][:, row]),
                        np.asarray(jp.state["scale"][k][:, row])]
        assert word == tfaults.integrity_word(*payload) \
            == jfaults.integrity_word(*payload) == jp._unit_word(row), row
    assert len(set(words)) == 3


def stub_decode(xp):
    """A decode step exact in both frameworks, in place of the family's:
    every state value halves and adds a quarter of the row's token, and
    the logits' argmax is (5 * token + 3) % V. Isolates `slab_verify`'s
    scan, acceptance and commit from the model's arithmetic."""
    def step(cfg, params, cache, batch, **_):
        tok = batch["tokens"][:, 0]
        V = cfg.vocab_padded
        out = {}
        for k, leaf in cache.items():
            t = tok.reshape((1, -1) + (1,) * (leaf.ndim - 2))
            if xp is jnp:
                out[k] = leaf * 0.5 + (t * 0.25).astype(leaf.dtype)
            else:
                out[k] = leaf * 0.5 + (t * 0.25).to(leaf.dtype)
        nxt = (5 * tok + 3) % V
        if xp is jnp:
            lg = jax.nn.one_hot(nxt, V, dtype=jnp.float32)[:, None]
        else:
            lg = torch.nn.functional.one_hot(nxt.long(), V).float()[:, None]
        return lg, out
    return step


def verify_inputs(V, B=3, W=4):
    """Windows whose drafts match the verifier's argmax for 1, 4 and 3
    slots (rows 0-2, row 1 capped at 2 by its write mask)."""
    rng = np.random.default_rng(3)
    toks = np.zeros((B, W), np.int32)
    good = (0, 3, 2)
    for b in range(B):
        toks[b, 0] = rng.integers(0, 32)
        for w in range(1, W):
            nxt = (5 * int(toks[b, w - 1]) + 3) % V
            toks[b, w] = nxt if w <= good[b] else (nxt + 7) % V
    wmask = np.array([[1, 1, 1, 1], [1, 1, 0, 0], [1, 1, 1, 1]], bool)
    return toks, np.array([4, 9, 0], np.int32), wmask


@pytest.mark.parametrize("pool_mode", ["normal-only", "always-augmented"])
def test_slab_verify_commit_matches_jax(monkeypatch, pool_mode):
    """With an exact stub step in both packages, the port's `slab_verify`
    commits planes bit-identical to the JAX `slab_verify`'s from one
    state (rows accepting 1, 2 (capped) and 3 of 4 slots), with the same
    logits; a row outside the write mask keeps its planes."""
    jp, tp = slab_pools(pool_mode, 8)
    cache = random_cache(jp.state["normal"], 5)
    mixed = pool_mode != "normal-only"
    modes = np.array([1, 0, 1], np.int32)
    js = jstore.slab_store_back(jp.state, cache,
                                jnp.asarray(modes) if mixed else None, 8)
    ts = tstore.slab_store_back(tp.state, to_t(cache),
                                torch.from_numpy(modes) if mixed else None,
                                8)
    assert_planes_equal(js, ts, "start")
    monkeypatch.setattr(jm, "decode_step", stub_decode(jnp))
    monkeypatch.setattr(tm, "decode_step", stub_decode(torch))
    cfg, tcfg = cfg_pair(pool_mode=pool_mode)
    toks, starts, wmask = verify_inputs(cfg.vocab_padded)
    wmask[2] = False                        # row 2 writes nothing
    jb = {"tokens": jnp.asarray(toks), "positions": jnp.asarray(starts),
          "write_mask": jnp.asarray(wmask)}
    tb = {"tokens": torch.from_numpy(toks),
          "positions": torch.from_numpy(starts),
          "write_mask": torch.from_numpy(wmask)}
    if mixed:
        jb["slot_modes"] = jnp.asarray(modes)
        tb["slot_modes"] = torch.from_numpy(modes)
    jl, jout = jstore.make_step_fns(cfg, jp)["verify"](None, js, jb)
    tl, tout = tstore.make_step_fns(tcfg)["verify"](None, ts, tb)
    np.testing.assert_array_equal(as_np(tl), as_np(jl))
    assert_planes_equal(jout, tout, "commit")
    for plane, v in ts.items():
        for k, leaf in keyed(v).items():
            assert torch.equal(keyed(tout[plane])[k][:, 2], leaf[:, 2])


def test_slab_verify_matches_jax(jax_params, torch_params):
    """The real step: from one Normal state, the port's verify logits
    agree with the JAX verify's as the decode step's do, and it commits,
    row by row, the state after the accepted prefix: the planes of the
    port's own stepwise decode after that many tokens, bit for bit."""
    cfg, tcfg = cfg_pair()
    jp, tp = slab_pools("normal-only", 8)
    cache = random_cache(jp.state["normal"], 7)
    js = jstore.slab_store_back(jp.state, cache, None, 8)
    ts = tstore.slab_store_back(tp.state, to_t(cache), None, 8)
    V = cfg.vocab
    # drafts: the JAX verify's own argmax for a prefix, then a miss
    toks = np.random.default_rng(4).integers(0, V, size=(3, 4)) \
        .astype(np.int32)
    starts = np.zeros(3, np.int32)
    wmask = np.ones((3, 4), bool)
    jverify = jax.jit(jstore.make_step_fns(cfg, jp)["verify"])
    for _ in range(3):                  # one more matching slot a pass
        jl, _ = jverify(jax_params, js, {
            "tokens": jnp.asarray(toks), "positions": jnp.asarray(starts),
            "write_mask": jnp.asarray(wmask)})
        v = np.asarray(jnp.argmax(jl, axis=-1))
        toks[0, 1:] = v[0, :3]          # row 0 accepts every slot
        toks[1, 1] = v[1, 0]            # row 1 accepts 2
    tl, tout = tstore.make_step_fns(tcfg)["verify"](torch_params, ts, {
        "tokens": torch.from_numpy(toks),
        "positions": torch.from_numpy(starts),
        "write_mask": torch.from_numpy(wmask)})
    jl, jout = jverify(jax_params, js, {
        "tokens": jnp.asarray(toks), "positions": jnp.asarray(starts),
        "write_mask": jnp.asarray(wmask)})
    jl, tln = as_np(jl)[..., :V], as_np(tl)[..., :V]
    assert np.abs(tln - jl).max() <= ulp_bf16(np.abs(jl).max())
    v = tl.argmax(-1).numpy()
    mism = np.concatenate([toks[:, 1:] != v[:, :-1],
                           np.ones((3, 1), bool)], axis=1)
    n_acc = mism.argmax(axis=1) + 1
    assert n_acc[0] == 4 and n_acc[1] == 2
    decode = tstore.make_step_fns(tcfg)["decode"]
    for b in range(3):
        state = ts
        for w in range(n_acc[b]):
            _, state = decode(torch_params, state, {
                "tokens": torch.from_numpy(toks[:, w:w + 1]),
                "positions": torch.from_numpy(starts + w),
                "write_mask": torch.ones(3, dtype=torch.bool)})
        for k, leaf in keyed(state["normal"]).items():
            assert torch.equal(keyed(tout["normal"])[k][:, b], leaf[:, b]), \
                (b, k)
        jcommit = keyed(jout["normal"])
        got = as_np(keyed(tout["normal"])["['ssd_state']"])[:, b]
        want = as_np(jcommit["['ssd_state']"])[:, b]
        assert ref.rel_err(got, want) < 1e-5, b
        got = as_np(keyed(tout["normal"])["['conv_state']"])[:, b]
        want = as_np(jcommit["['conv_state']"])[:, b]
        assert (np.abs(got - want) <= ulp_bf16(want)).all(), b


def test_static_slab_scrub_from_master_matches_jax():
    """A static (write-once) slab store keeps host masters at its
    integrity flush: a corrupted slab is detected and scrubbed back in
    place, and with pin threshold 1 its row is pinned to the Normal
    plane; the planes, words and counters equal the JAX store's at every
    step."""
    jp, tp = slab_pools("augment-on-pressure", 4, static=True,
                        retention_steps=2)
    budget = jp.slab_bytes_normal + 2 * jp.slab_bytes_aug
    for p in (jp, tp):
        p.budget_bytes = budget
        fm = (jfaults if p is jp else tfaults).FaultModel(
            rate=1.0, seed=4, pin_threshold=1)
        p.attach_fault_model(fm)
    cache = random_cache(jp.state["normal"], 9)
    for step, row in enumerate((0, 1, 2)):
        assert jp.admit_row(row, 4, step) == tp.admit_row(row, 4, step)
    jp.state = jstore.slab_store_back(jp.state, cache, jnp.asarray(
        jp.slot_mode), 4)
    tp.state = tstore.slab_store_back(tp.state, to_t(cache),
                                      torch.from_numpy(tp.slot_mode), 4)
    assert_planes_equal(jp.state, tp.state, "filled")
    healed = 0
    for step in range(3, 9):
        got = []
        for p in (jp, tp):
            n = p.inject_faults(step)
            bad = p.scan_integrity(step)
            got.append((n, bad, [p.scrub_from_master(r) for r in bad]))
            for row in p.refresh_due(step):
                p.refresh(row, step)
        assert got[0] == got[1], step
        healed += sum(got[1][2])
        assert_planes_equal(jp.state, tp.state, f"step {step}")
        assert tp._words == jp._words
        np.testing.assert_array_equal(tp.slot_mode, jp.slot_mode)
        assert tp.fault_counters() == jp.fault_counters()
    assert healed > 0 and tp.stats["pinned_normal"] > 0
    assert tp.write_value_counts(np.arange(3), 1, np.zeros(3)) == (0, 0)
    assert tp.describe() == {k: jp.describe()[k] for k in tp.describe()}


def test_energy_events_match_jax():
    for reduced in (False, True):
        j, t = jax_get_arch(ARCH), get_arch(ARCH)
        if reduced:
            j, t = j.reduced(), t.reduced()
        for impl in ("dense", "packed", "imc"):
            for abits in (1, 8):
                kw = dict(matmul_impl=impl, imc_abits=abits)
                tc = dataclasses.replace(t, amc=dataclasses.replace(
                    t.amc, **kw))
                jc = dataclasses.replace(j, amc=dataclasses.replace(
                    j.amc, **kw))
                assert energy.model_decode_matmuls(tc) \
                    == jenergy.model_decode_matmuls(jc)
                for n in (1, 7):
                    assert energy.decode_matmul_events(tc, n) \
                        == jenergy.decode_matmul_events(jc, n)


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------

def _gen_prompts(seed=11):
    """tests/test_speculative.py's `_gen` requests: (prompt, max_new)."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 512, size=(n,)).astype(np.int32), m)
            for n, m in [(5, 9), (9, 6), (3, 7)]]


def _reqs(n, plen, max_new, seed=0):
    """tests/test_faults.py's and test_obs.py's `_reqs`."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 512, size=(plen,)).astype(np.int32), max_new)
            for _ in range(n)]


def _negate(fn):
    """tests/test_speculative.py's draft wrapper: argmax-inverted logits,
    so (near-certainly) every draft is rejected and each round rolls the
    slabs back and accepts only the verify's first token."""
    def wrapped(params, state, batch):
        lg, new_state = fn(params, state, batch)
        return -lg, new_state
    return wrapped


SPEC_ENGINE = {"max_batch": 2, "max_seq": 40, "prefill_chunk": 8}
# a Normal slab is 36224 B, an int8 Augmented one 10956 B: this budget
# holds one Normal slab and nothing beside it, so admitting a second row
# augments the coldest
PRESSURE = {**SPEC_ENGINE, "pool_budget_bytes": 36224 + 5000}
FAULT_AMC = {"pool_mode": "always-augmented", "kv_mode": "int4"}
# name -> (fresh AMCConfig, AMC fields, engine kwargs, requests, draft
# wrapper)
CELLS = {
    "auto": (False, {}, SPEC_ENGINE, _gen_prompts(), None),
    "always-augmented": (False, {"pool_mode": "always-augmented"},
                         SPEC_ENGINE, _gen_prompts(), None),
    "augment-on-pressure": (False, {"pool_mode": "augment-on-pressure"},
                            PRESSURE, _gen_prompts(), None),
    "spec": (False, {"spec_k": 3}, SPEC_ENGINE, _gen_prompts(), None),
    "reject": (False, {"spec_k": 3}, SPEC_ENGINE, _gen_prompts(), _negate),
    "reject_pressure": (False, {"spec_k": 3,
                                "pool_mode": "augment-on-pressure"},
                        PRESSURE, _gen_prompts(), _negate),
    # tests/test_faults.py's chaos cell (golden and faulted), traced
    "chaos_golden": (True, FAULT_AMC, {"max_batch": 2, "max_seq": 64,
                                       "prefill_chunk": 16,
                                       "retention_steps": 4},
                     _reqs(3, 5, 8), None),
    "chaos": (True, {**FAULT_AMC, "fault_rate": 1.0, "fault_seed": 1,
                     "trace": True, "metrics": True},
              {"max_batch": 2, "max_seq": 64, "prefill_chunk": 16,
               "retention_steps": 4}, _reqs(3, 5, 8), None),
    # tests/test_faults.py's slab repeat offender
    "pinned": (True, {**FAULT_AMC, "fault_rate": 1.0, "fault_seed": 2,
                      "fault_pin_threshold": 1},
               {"max_batch": 2, "max_seq": 32, "retention_steps": 4},
               _reqs(3, 5, 8), None),
    # tests/test_obs.py's slab mode-mix case
    "mode_mix": (True, {"pool_mode": "always-augmented", "trace": True,
                        "metrics": True},
                 {"max_batch": 2, "max_seq": 32, "prefill_chunk": 8},
                 _reqs(3, 6, 6), None),
}


def _clock():
    tick = itertools.count()
    return lambda: next(tick) * 1e-3


class BlockingEngine(JaxServeEngine):
    """The JAX engine, waiting for every dispatch (see the docstring)."""

    def _dispatch(self, fn, batch):
        logits = super()._dispatch(fn, batch)
        jax.block_until_ready(logits)
        return logits


def _obs_record(eng) -> dict:
    """The trace and metrics, as JSON (tuples and lists alike)."""
    m = eng.obs.metrics
    return json.loads(json.dumps({
        "events": eng.obs.tracer.chrome_trace()["traceEvents"],
        "counters": dict(m.counters), "gauges": dict(m.gauges),
        "series": m.dump_timeseries()}))


def _run(which: str, name: str, params) -> dict:
    fresh, amc, engine, reqs, wrap = CELLS[name]
    jcfg, tcfg = cfg_pair(fresh, **amc)
    traced = amc.get("trace", False)
    if which == "jax":
        obs = jax_make_engine_obs(jcfg.amc, clock=_clock()) if traced \
            else None
        eng = BlockingEngine(jcfg, MESH, params=params, obs=obs, **engine)
        R = JaxRequest
    else:
        obs = tobs.make_engine_obs(tcfg.amc, clock=_clock()) if traced \
            else None
        eng = ServeEngine(tcfg, device="cpu", params=params, obs=obs,
                          **engine)
        R = Request
    if wrap is not None:
        eng._draft_decode = wrap(eng._draft_decode)
    out = eng.generate([R(prompt=p, max_new_tokens=m, id=i)
                        for i, (p, m) in enumerate(reqs)])
    st = eng.stats()
    rec = {"tokens": {k: [int(t) for t in v] for k, v in out.items()},
           "failed": dict(eng.failed),
           "pool": {k: v for k, v in st["pool"].items()
                    if isinstance(v, (int, float, str))},
           "faults": st["faults"], "spec": st["spec"],
           "dispatches": eng.dispatch_count, "engine": eng,
           "imc": {g: d["events"] for g, d in st["imc"]["groups"].items()}}
    if traced:
        rec["obs"] = _obs_record(eng)
    return rec


@pytest.fixture(scope="module")
def runs(jax_params, torch_params):
    """Each cell served by the JAX engine and the port's, made once."""
    cache = {}

    def get(which, name):
        if (which, name) not in cache:
            cache[(which, name)] = _run(
                which, name, jax_params if which == "jax" else torch_params)
        return cache[(which, name)]
    return get


@pytest.mark.parametrize("name", ["auto", "always-augmented",
                                  "augment-on-pressure"])
def test_engine_matches_jax(runs, name):
    """Tokens, dispatches (every prompt token but the last is one decode
    dispatch), the slab pool's stats and the ledger's events equal the
    JAX engine's at every pool mode."""
    want, got = runs("jax", name), runs("torch", name)
    assert got["tokens"] == want["tokens"]
    assert got["dispatches"] == want["dispatches"]
    assert got["pool"] == {k: want["pool"][k] for k in got["pool"]}
    assert got["imc"] == want["imc"]
    if name == "augment-on-pressure":
        assert got["pool"]["augment_events"] > 0
    elif name == "always-augmented":
        assert got["pool"]["slabs_live_augmented"] == 0 \
            and got["pool"]["peak_live_bytes"] \
            == 2 * got["pool"]["slab_bytes_aug"]


def test_spec_decode_token_identical_to_stepwise(runs):
    """tests/test_speculative.py's ssm case: spec_k=3 emits the stepwise
    tokens (and the JAX engine's speculative ones), through queueing and
    row retirement, with its counters equal to the JAX engine's."""
    got = runs("torch", "spec")
    assert got["tokens"] == runs("torch", "auto")["tokens"] \
        == runs("jax", "spec")["tokens"]
    keys = ("spec_rounds", "draft_dispatches", "verify_dispatches",
            "accepted_tokens")
    assert {k: got["spec"][k] for k in keys} \
        == {k: runs("jax", "spec")["spec"][k] for k in keys}
    assert got["spec"]["verify_dispatches"] > 0
    assert got["spec"]["accepted_tokens"] >= got["spec"]["spec_rounds"]
    assert got["pool"] == {k: runs("jax", "spec")["pool"][k]
                           for k in got["pool"]}


@pytest.mark.parametrize("name,stepwise", [
    ("reject", "auto"), ("reject_pressure", "augment-on-pressure")])
def test_spec_forced_rejection_rolls_back_slab_state(runs, name, stepwise):
    """tests/test_speculative.py's forced rejection: every draft wrong,
    every round rolls back, and the tokens are the stepwise run's and the
    JAX engine's; under augment-on-pressure too (slabs augmented at
    admission, before any snapshot)."""
    got, want = runs("torch", name), runs("jax", name)
    assert got["tokens"] == runs("torch", stepwise)["tokens"] \
        == want["tokens"]
    pool = got["pool"]
    assert pool["spec_snapshots"] > 0
    assert pool["spec_rollbacks"] == pool["spec_snapshots"] \
        == want["pool"]["spec_snapshots"]
    assert got["spec"]["accepted_tokens"] < got["spec"]["spec_rounds"] * 3
    assert pool == {k: want["pool"][k] for k in pool}
    if name == "reject_pressure":
        assert pool["augment_events"] > 0


@pytest.mark.parametrize("pool_mode,budget", [
    ("auto", None), ("augment-on-pressure", 36224 + 5000),
    ("augment-on-pressure", 36224 + 10956)])
def test_snapshot_is_never_written_between_drafts(torch_params, pool_mode,
                                                  budget):
    """The snapshot holds the live planes by reference: every plane it
    holds keeps its bits through the drafts up to the restore, with
    rejected drafts, on Normal slabs, on slabs augmented at admission,
    and on one Normal and one Augmented slab side by side."""
    _, tcfg = cfg_pair(spec_k=3, pool_mode=pool_mode)
    eng = ServeEngine(tcfg, device="cpu", params=torch_params,
                      pool_budget_bytes=budget, **SPEC_ENGINE)
    eng._draft_decode = _negate(eng._draft_decode)
    store, checks, modes = eng.store, [], set()
    snap, restore = store.speculative_snapshot, store.speculative_restore

    def snapshot():
        snap()
        modes.add(tuple(store.slot_mode[store.slot_alloc]))
        checks.append({k: (v, v.clone()) for k, v in
                       keyed(store._spec_snapshot).items()})

    def restored():
        for k, (live, copy) in checks[-1].items():
            assert torch.equal(live, copy), k
        restore()
    store.speculative_snapshot, store.speculative_restore = snapshot, \
        restored
    eng.generate([Request(prompt=p, max_new_tokens=m, id=i)
                  for i, (p, m) in enumerate(_gen_prompts())])
    assert len(checks) == store.stats["spec_rollbacks"] > 0
    if budget == 36224 + 10956:
        assert (0, 1) in modes or (1, 0) in modes


def test_chaos_cell_matches_jax(runs):
    """tests/test_faults.py's mamba2 chaos cell (always-augmented int4
    planes, retention 4, fault rate 1.0, seed 1): tokens and every fault
    counter equal the JAX engine's, every fault detected or masked, and
    recovery (a stepwise re-prefill) restores the fault-free tokens."""
    got, want = runs("torch", "chaos"), runs("jax", "chaos")
    fl = got["faults"]
    assert fl["faults_injected"] > 0
    assert fl["faults_injected"] == fl["faults_detected"] \
        + fl["faults_masked"]
    assert fl["faults_pending"] == 0 and fl["zero_silent_corruption"]
    assert fl["recovered_recompute"] > 0
    skip = {"straggler_mitigations", "recovery_energy_fj"}
    assert {k: v for k, v in fl.items() if k not in skip} \
        == {k: v for k, v in want["faults"].items() if k not in skip}
    assert fl["recovery_energy_fj"] == pytest.approx(
        want["faults"]["recovery_energy_fj"], rel=1e-12)
    assert got["tokens"] == want["tokens"] \
        == runs("torch", "chaos_golden")["tokens"] \
        == runs("jax", "chaos_golden")["tokens"]
    assert not got["failed"] and not want["failed"]
    assert got["pool"] == {k: want["pool"][k] for k in got["pool"]}


def test_slab_offender_pinned_to_normal_mode(runs):
    """tests/test_faults.py's slab repeat offender (threshold 1): the
    detected slab's row is pinned to the static Normal plane; counters
    equal the JAX engine's."""
    got, want = runs("torch", "pinned"), runs("jax", "pinned")
    fl = got["faults"]
    assert fl["faults_detected"] > 0 and fl["pinned_normal"] > 0
    assert fl["zero_silent_corruption"]
    skip = {"straggler_mitigations", "recovery_energy_fj"}
    assert {k: v for k, v in fl.items() if k not in skip} \
        == {k: v for k, v in want["faults"].items() if k not in skip}
    assert got["tokens"] == want["tokens"]
    assert got["pool"] == {k: want["pool"][k] for k in got["pool"]}


def test_faulted_slab_trace_matches_jax(runs):
    """The chaos cell traced under one counter clock: the port's Chrome
    trace equals the JAX engine's event for event (inject, detect and
    heal instants of the fault lane included), and so do its counters,
    gauges and sampled series."""
    got, want = runs("torch", "chaos")["obs"], runs("jax", "chaos")["obs"]
    injects = [e for e in got["events"] if e.get("name") == "inject"]
    assert len(injects) == runs("torch", "chaos")["faults"][
        "faults_injected"] > 0
    assert all(e["args"]["unit"].startswith("slab") for e in injects)
    for i, (a, b) in enumerate(zip(got["events"], want["events"])):
        assert a == b, f"event {i}"
    assert len(got["events"]) == len(want["events"])
    assert got["counters"] == want["counters"]
    assert got["gauges"] == want["gauges"]
    assert got["series"] == want["series"]


def test_mode_mix_counters_match_reduction_on_slab_store(runs):
    """tests/test_obs.py's slab mode-mix case on mamba2: the O(1) mode
    counters equal describe()'s reduction, the Augmented series is
    sampled, and the trace equals the JAX engine's."""
    got = runs("torch", "mode_mix")
    eng = got["engine"]
    pool = eng.stats()["pool"]
    assert eng.store.mode_mix() == (pool["slabs_live_normal"],
                                    pool["slabs_live_augmented"])
    series = got["obs"]["series"]
    assert any(v > 0 for _, v in series["mode_augmented"])
    assert all(v == 0 for _, v in series["mode_normal"])
    assert got["obs"]["events"] == runs("jax", "mode_mix")["obs"]["events"]
    assert got["tokens"] == runs("jax", "mode_mix")["tokens"]
