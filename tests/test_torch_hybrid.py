"""The hybrid family (recurrentgemma-9b) in the port, held against the JAX
package at the reduced config (one macro-block (rec, rec, attn) and a
trailing rec layer, lru_width 128, a 16-slot ring): config, parameter
tree, the LRU step, the contiguous ring-KV attention block, the whole
decode step, the slab planes of `AugmentedStatePool`, and the engine.

The JAX side runs its reference paths. kv_impl="dequant" reaches no
Pallas call on this path (the ring KV is packed by the jnp packer), so it
runs in this process; kv_impl="kernel" reaches `packed_kv_attention`,
which this jax interprets only with `pltpu.TPUCompilerParams` aliased, so
those oracles run in a child process (the alias never enters this one).

Tolerances: config fields, tree shapes, slab planes, byte accounting and
value counts exact; the attention block's ring bytes, scales and output
bit-identical given the same input and cache; the LRU state h within
1e-6 (float32 exp / logistic / softplus differ in the last ulp between
the frameworks), conv tails exact; logits rel_err < 0.05 (as
tests/test_augmented_model.py); engine tokens exact on prompts whose JAX
top-1/top-2 logit margin exceeds MIN_MARGIN at every emitting decode step
(checked; int8 ring KV, where a flipped level moves a logit less than at
int4).
"""
import dataclasses
import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import get_arch as jax_get_arch
from repro.kernels import ref
from repro.models import hybrid as jhybrid
from repro.models import model as jm
from repro.models import transformer as jtransformer
from repro.models.params import init_params as jax_init_params
from repro.models.params import is_pspec
from repro.serve import state_store as jstore
from repro_torch.configs import get_arch
from repro_torch.models import hybrid as thybrid
from repro_torch.models import transformer as ttransformer
from repro_torch.models.params import abstract_params, from_numpy_tree
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve import state_store as tstore

CPU = torch.device("cpu")
REPO = Path(__file__).resolve().parents[1]
ARCH = "recurrentgemma-9b"
# the port's logits sit up to ~0.03 from JAX's on this path (bf16 hidden
# states a few ulps apart after the recurrent layers, gelu rounded once
# where JAX rounds after each op); a step whose top-1/top-2 margin is under
# that is a near-tie, not a test of the port
MIN_MARGIN = 0.04


def jcfg_of(**amc):
    cfg = jax_get_arch(ARCH).reduced()
    return dataclasses.replace(cfg, amc=dataclasses.replace(cfg.amc, **amc))


def tcfg_of(**amc):
    cfg = get_arch(ARCH).reduced()
    return dataclasses.replace(cfg, amc=dataclasses.replace(cfg.amc, **amc))


def to_t(tree):
    return from_numpy_tree(jax.tree.map(np.asarray, tree), CPU)


def as_np(x) -> np.ndarray:
    """A JAX or torch array as numpy, bf16 widened to float32."""
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16
                      else x)


def leaf(tree, key):
    for part in key[2:-2].split("']['"):
        tree = tree[part]
    return tree


def keyed(tree) -> dict:
    return {jax.tree_util.keystr(p): v
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def dense_params():
    """JAX's seed-0 weights of the reduced config, as the JAX engine makes
    them (the hybrid family keeps them dense)."""
    cfg = jcfg_of(weight_mode="normal")
    return jax_init_params(jm.abstract_params(cfg), jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def torch_params(dense_params):
    return to_t(dense_params)


# ---------------------------------------------------------------------------
# config and parameter tree
# ---------------------------------------------------------------------------

def test_config_matches_jax():
    for full in (True, False):
        j, t = jax_get_arch(ARCH), get_arch(ARCH)
        if not full:
            j, t = j.reduced(), t.reduced()
        for f in ("name", "family", "n_layers", "d_model", "n_heads",
                  "n_kv_heads", "d_ff", "vocab", "hd", "vocab_padded",
                  "qkv_bias", "rope_theta", "norm_eps", "tie_embeddings",
                  "act", "source"):
            assert getattr(t, f) == getattr(j, f), f
        for f in ("lru_width", "window", "pattern"):
            assert getattr(t.hybrid, f) == getattr(j.hybrid, f), f
        for f in ("weight_mode", "kv_mode", "kv_impl", "pool_mode",
                  "state_bits", "retention_steps", "aug_bits",
                  "resolved_pool_mode"):
            assert getattr(t.amc, f) == getattr(j.amc, f), f
    assert get_arch(ARCH).hybrid.window == 2048


def test_from_numpy_tree_carries_the_jax_hybrid_tree(dense_params):
    """Every leaf of JAX's nested `blocks/rec_a/...` tree arrives under the
    same path, shape and dtype as the port declares it, values intact."""
    tp = to_t(dense_params)
    spec = {k: v for k, v in keyed(abstract_params(get_arch(ARCH).reduced()
                                                   )).items()}
    got = keyed(tp)
    assert sorted(got) == sorted(spec) == sorted(keyed(dense_params))
    for k, v in keyed(dense_params).items():
        assert tuple(got[k].shape) == spec[k].shape == v.shape, k
        assert got[k].dtype == spec[k].dtype, k
        np.testing.assert_array_equal(as_np(got[k]), as_np(v), err_msg=k)


def test_augment_params_passes_hybrid_trees_through(torch_params):
    from repro_torch.models import augment
    cfg = get_arch(ARCH).reduced()
    assert cfg.amc.weight_mode == "dual"
    assert augment.augment_params(cfg, torch_params) is torch_params
    assert not augment.is_augmented(torch_params)


# ---------------------------------------------------------------------------
# model pieces
# ---------------------------------------------------------------------------

def _layer(tree, i):
    return {k: v[i] for k, v in tree.items()}


def test_rec_step_matches_jax(dense_params):
    """One RG-LRU step with nontrivial gates: h within 1e-6 of JAX's, the
    conv tail bit-identical, y within rel_err 1e-2 (bf16 of y @ out on an
    h that differs in the last float32 ulp)."""
    rng = np.random.default_rng(1)
    p = dict(_layer(dense_params["blocks"]["rec_a"], 0))
    for k in ("w_r", "b_r", "w_i", "b_i"):
        p[k] = jnp.asarray(rng.standard_normal(p[k].shape), jnp.bfloat16)
    x = jnp.asarray(rng.standard_normal((2, 128)), jnp.bfloat16)
    h = jnp.asarray(rng.standard_normal((2, 128)), jnp.float32)
    c = jnp.asarray(rng.standard_normal((2, 3, 128)), jnp.bfloat16)
    jcfg, tcfg = jcfg_of(), tcfg_of()
    jy, jh, jc = jax.jit(lambda *a: jhybrid.rec_step(jcfg, *a))(p, x, h, c)
    ty, th, tc = thybrid.rec_step(tcfg, to_t(p), to_t(x), to_t(h), to_t(c))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(as_np(tc), as_np(jc))
    assert ref.rel_err(as_np(ty), as_np(jy)) < 1e-2


def ring_levels(q: np.ndarray, kv_mode: str) -> np.ndarray:
    """Packed ring bytes (int4 pairs or int8) as integer levels."""
    if kv_mode == "int4":
        b = q.astype(np.uint8)
        q = np.stack([b.view(np.int8) >> 4, (b << 4).view(np.int8) >> 4],
                     axis=-1).reshape(*b.shape[:-1], -1)
    return q.astype(np.int32)


def _zero_cache(jcfg, B):
    return jax.tree.map(lambda s: jnp.zeros(s.shape, s.jdtype),
                        jhybrid.abstract_cache(jcfg, B, 32),
                        is_leaf=is_pspec)


@pytest.mark.parametrize("kv_mode", ["int4", "int8", "normal"])
def test_attn_block_decode_matches_jax(dense_params, kv_mode):
    """The contiguous ring-KV attention block, 24 steps on a 16-slot ring
    (the two rows 5 positions apart, so both wrap), each step from the
    same input and cache on both sides: the packed ring bytes and scales
    written are bit-identical to JAX's (int4, int8); a bf16 ring (normal)
    within one bf16 ulp (RoPE's float32 cos / sin differ in the last ulp
    between the frameworks); the output within rel_err 1e-2 of JAX's
    dequant route, on the port's dequant route and on its kernel route
    (the kernel's plain version on CPU), which write the same cache."""
    jcfg = jcfg_of(kv_mode=kv_mode, kv_impl="dequant")
    W = jcfg.hybrid.window
    p = _layer(dense_params["blocks"]["attn"], 0)
    tp = to_t(p)
    step = jax.jit(lambda p, x, c, pos: jtransformer.attn_block_decode(
        jcfg, p, x, c, pos, window=W))
    cache = {k: v[0] for k, v in _zero_cache(jcfg, 2)["blocks"].items()
             if k.startswith(("k", "v"))}
    rng = np.random.default_rng(2)
    for s in range(24):
        x = jnp.asarray(rng.standard_normal((2, 1, 128)), jnp.bfloat16)
        pos = np.array([s, s + 5], np.int32)
        jo, jc = step(p, x, cache, jnp.asarray(pos))
        for impl in ("dequant", "kernel"):
            to, tc = ttransformer.attn_block_decode(
                tcfg_of(kv_mode=kv_mode, kv_impl=impl), tp, to_t(x),
                to_t(cache), torch.from_numpy(pos), window=W)
            for k in jc:
                if kv_mode == "normal":
                    np.testing.assert_allclose(as_np(tc[k]), as_np(jc[k]),
                                               rtol=2.0 ** -7, atol=0,
                                               err_msg=f"{k} step {s}")
                else:
                    np.testing.assert_array_equal(
                        as_np(tc[k]), as_np(jc[k]), err_msg=f"{k} step {s}")
            assert ref.rel_err(as_np(to), as_np(jo)) < 1e-2, (impl, s)
        cache = jc


@pytest.mark.parametrize("kv_mode", ["int4", "int8", "normal"])
def test_decode_step_matches_jax(dense_params, torch_params, kv_mode):
    """The whole decode step, 24 positions past the 16-slot window, run
    both ways. From JAX's cache each step: logits < 0.05; the new cache's
    LRU states, conv tails and scales < 0.05; K/V come out of float
    projections computed in two frameworks (bf16 hidden states a few ulps
    apart after the recurrent layers), so a value near a rounding boundary
    moves its level: int4 ring levels within one level of JAX's, under 1%
    of them moved (measured: 0.4% at most), int8 ring values (level x
    scale) < 0.05 (measured: 0.019). Each framework on its own cache
    throughout: logits < 0.05 at int8 and normal; at int4 < 0.1, since
    one flipped int4 level is 1/7 of its row's range and the flips of
    earlier steps stay in the ring (measured: 0.057)."""
    jcfg = jcfg_of(kv_mode=kv_mode, kv_impl="dequant")
    tcfg = tcfg_of(kv_mode=kv_mode)
    step = jax.jit(lambda p, c, t, pos: jhybrid.decode_step(jcfg, p, c, t,
                                                            pos))
    jc = _zero_cache(jcfg, 2)
    tc_own = to_t(jc)
    rng = np.random.default_rng(3)
    V = jcfg.vocab
    for s in range(24):
        tok = rng.integers(0, V, size=(2, 1)).astype(np.int32)
        pos = np.array([s, s + 3], np.int32)
        jl, jc2 = step(dense_params, jc, jnp.asarray(tok), jnp.asarray(pos))
        tl, tc2 = thybrid.decode_step(tcfg, torch_params, to_t(jc),
                                      torch.from_numpy(tok),
                                      torch.from_numpy(pos))
        assert ref.rel_err(as_np(tl)[..., :V], as_np(jl)[..., :V]) < 0.05
        got, want = keyed(tc2), keyed(jc2)
        for k in want:
            if k.endswith(("['k']", "['v']")) and kv_mode != "normal":
                sk = k[:-2] + "_scale']"
                la, lb = (ring_levels(as_np(t[k]), kv_mode)
                          for t in (got, want))
                if kv_mode == "int4":
                    moved = np.abs(la - lb)
                    assert moved.max() <= 1 and moved.mean() < 0.01, (k, s)
                else:
                    assert ref.rel_err(la * as_np(got[sk]),
                                       lb * as_np(want[sk])) < 0.05, (k, s)
            else:
                assert ref.rel_err(as_np(got[k]), as_np(want[k])) < 0.05, \
                    (k, s)
        tl_own, tc_own = thybrid.decode_step(tcfg, torch_params, tc_own,
                                             torch.from_numpy(tok),
                                             torch.from_numpy(pos))
        assert ref.rel_err(as_np(tl_own)[..., :V], as_np(jl)[..., :V]) \
            < (0.1 if kv_mode == "int4" else 0.05), s
        jc = jc2


# ---------------------------------------------------------------------------
# slab planes of the state store
# ---------------------------------------------------------------------------

def slab_pools(pool_mode, state_bits, kv_mode="int4", B=3, **kw):
    from repro.configs.base import ShapeConfig
    from repro_torch.models import model as tm
    jcfg = jcfg_of(pool_mode=pool_mode, state_bits=state_bits,
                   kv_mode=kv_mode, kv_impl="dequant")
    tcfg = tcfg_of(pool_mode=pool_mode, state_bits=state_bits,
                   kv_mode=kv_mode)
    jp = jstore.AugmentedStatePool(
        jcfg, jm.abstract_cache(jcfg, ShapeConfig("t", 32, B, "decode")),
        max_batch=B, **kw)
    tp = tstore.AugmentedStatePool(tcfg, tm.abstract_cache(tcfg, B, 32),
                                   max_batch=B, device=CPU, **kw)
    return jp, tp


TORCH_DTYPE = {jnp.dtype(jnp.uint8): torch.uint8,
               jnp.dtype(jnp.int8): torch.int8,
               jnp.dtype(jnp.bfloat16): torch.bfloat16,
               jnp.dtype(jnp.float32): torch.float32}


def assert_planes_equal(jstate, tstate, where=""):
    assert sorted(jstate) == sorted(tstate), where
    want = keyed(jstate["normal"])
    got = keyed(tstate["normal"])
    assert sorted(got) == sorted(want), where
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, (where, k)
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


def random_cache(normal: dict, seed: int) -> dict:
    """Random contents for every slab leaf: float leaves at mixed
    magnitudes (exact zeros included), integer leaves anywhere in range,
    trailing-dim-1 scale leaves positive."""
    rng = np.random.default_rng(seed)

    def fill(x):
        shape, dt = x.shape, x.dtype
        if jnp.issubdtype(dt, jnp.integer):
            info = jnp.iinfo(dt)
            return jnp.asarray(rng.integers(info.min, info.max + 1, shape),
                               dt)
        if shape[-1] == 1:
            return jnp.asarray(rng.uniform(0.01, 2.0, shape), dt)
        v = rng.standard_normal(shape) * rng.uniform(
            0.01, 40.0, shape[:-1] + (1,))
        v.reshape(-1, shape[-1])[:2] = 0.0      # all-zero vectors: amax 0
        return jnp.asarray(v, dt)
    return jax.tree.map(fill, normal)


@pytest.mark.parametrize("state_bits", [8, 4])
@pytest.mark.parametrize("pool_mode", ["normal-only", "always-augmented"])
def test_slab_plane_ops_match_jax(pool_mode, state_bits):
    """store_back (write-masked, mixed slot modes), reconstitute, and the
    reset / augment / promote row ops give planes bit-identical to the
    JAX package's; integer ring leaves and their trailing-dim-1 scale
    leaves pass through the packed plane untouched."""
    jp, tp = slab_pools(pool_mode, state_bits)
    assert_planes_equal(jp.state, tp.state, "zeros")
    if pool_mode == "always-augmented":
        assert all(not k.endswith("_scale']") for k in tp.state["packed"])
        assert "['blocks']['k']" not in tp.state["packed"]
    cache = random_cache(jp.state["normal"], state_bits)
    mixed = pool_mode != "normal-only"
    modes = np.array([1, 0, 1], np.int32) if mixed else None
    write = np.array([True, False, True])
    jm_ = None if modes is None else jnp.asarray(modes)
    tm_ = None if modes is None else torch.from_numpy(modes)
    js = jstore.slab_store_back(jp.state, cache, jm_, state_bits,
                                write=jnp.asarray(write))
    ts = tstore.slab_store_back(tp.state, to_t(cache), tm_, state_bits,
                                write=torch.from_numpy(write))
    assert_planes_equal(js, ts, "store_back")
    jr = jstore.slab_reconstitute(js, jm_, state_bits)
    tr = tstore.slab_reconstitute(ts, tm_, state_bits)
    want, got = keyed(jr), keyed(tr)
    for k in want:
        np.testing.assert_array_equal(as_np(got[k]), as_np(want[k]),
                                      err_msg=f"reconstitute {k}")
        if not k.endswith(("_scale']",)) and jnp.issubdtype(
                want[k].dtype, jnp.integer):
            # packed ring bytes of written rows read back as written
            np.testing.assert_array_equal(
                as_np(got[k])[:, write], as_np(keyed(cache)[k])[:, write])
    js = jstore._reset_row_op(js, 1)
    tstore._reset_row_op(ts, 1)
    assert_planes_equal(js, ts, "reset")
    if mixed:
        js = jstore._augment_row_op(js, 1, bits=state_bits)
        tstore._augment_row_op(ts, 1, bits=state_bits)
        assert_planes_equal(js, ts, "augment")
        js = jstore._promote_row_op(js, 2, bits=state_bits)
        tstore._promote_row_op(ts, 2, bits=state_bits)
        assert_planes_equal(js, ts, "promote")


@pytest.mark.parametrize("kv_mode", ["int4", "int8", "normal"])
def test_slab_byte_accounting_matches_jax(kv_mode):
    for pool_mode in ("normal-only", "always-augmented",
                      "augment-on-pressure"):
        for bits in (8, 4):
            jp, tp = slab_pools(pool_mode, bits, kv_mode)
            for f in ("slab_bytes_normal", "slab_bytes_aug",
                      "values_per_slot", "budget_bytes", "mixed",
                      "pool_mode", "state_bits"):
                assert getattr(tp, f) == getattr(jp, f), (pool_mode, f)
            assert tp.physical_bytes() == jp.physical_bytes()
            td, jd = tp.describe(), jp.describe()
            assert {k: jd[k] for k in td} == td


def test_slab_pool_policy_and_value_counts_match_jax():
    """The host-side policy of the slab pool, step by step against the
    JAX pool (augment-on-pressure, room for one Normal and one Augmented
    slab, retention 2): admission that augments the coldest slab, release,
    refresh passes that restamp and then promote, with the read / write
    value counts the energy ledger bills after every step."""
    jp0, _ = slab_pools("augment-on-pressure", 8)
    budget = jp0.slab_bytes_normal + jp0.slab_bytes_aug + 1
    jp, tp = slab_pools("augment-on-pressure", 8, budget_bytes=budget,
                        retention_steps=2)
    script = [("admit", 0), ("can",), ("admit", 1), ("can",), ("note", 1),
              ("refresh",), ("refresh",), ("admit", 2), ("release", 0),
              ("refresh",), ("note", 2), ("refresh",), ("refresh",),
              ("release", 1), ("can",), ("admit", 0), ("refresh",)]
    rows, lens = np.array([0, 1, 2]), np.array([3, 5, 7])
    for step, op in enumerate(script):
        got = []
        for p in (jp, tp):
            if op[0] == "admit":
                got.append(p.admit_row(op[1], 4, step))
            elif op[0] == "can":
                got.append(p.can_admit_tokens(4))
            elif op[0] == "note":
                p.note_token_writes(np.array([op[1]]), np.array([9]), step)
            elif op[0] == "release":
                p.release_row(op[1])
            else:
                for key in p.refresh_due(step):
                    p.refresh(key, step)
        assert got[:1] == got[1:], (step, op, got)
        np.testing.assert_array_equal(tp.slot_mode, jp.slot_mode)
        np.testing.assert_array_equal(tp.slot_alloc, jp.slot_alloc)
        assert tp.live_bytes == jp.live_bytes, (step, op)
        assert sorted(tp.policies) == sorted(jp.policies), (step, op)
        assert tp.read_value_counts(rows, lens) \
            == jp.read_value_counts(rows, lens)
        assert tp.write_value_counts(rows, 1, lens) \
            == jp.write_value_counts(rows, 1, lens)
        assert_planes_equal(jp.state, tp.state, f"step {step} {op}")
    td, jd = tp.describe(), jp.describe()
    assert {k: jd[k] for k in td} == td
    assert td["augment_events"] > 0 and td["promote_events"] > 0 \
        and td["refreshes"] > td["promote_events"]


def test_speculative_decoding_on_slabs_raises():
    """Slab snapshot / rollback is not ported: spec_k > 1 on the hybrid
    family refuses instead of silently serving stepwise."""
    with pytest.raises(NotImplementedError, match="speculative"):
        ServeEngine(get_arch(ARCH).reduced(), device="cpu", max_batch=1,
                    max_seq=16, spec_k=4)


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------

# 4 requests on 2 rows (queueing, row reuse, slab reset), prompts past the
# 16-slot window (the ring wraps and lengths pass S) and int8 ring KV.
# Under augment-on-pressure a budget of 6000 B (a slab is 4928 B Normal,
# 2648 B Augmented at int8 KV, state_bits 8) holds one Normal slab and no
# second one, so admitting the second row augments the coldest. (Every
# decode step rewrites each running row's slab, so no slab expires here:
# the pool-level test above drives refresh and promotion.)
# The prompt seed keeps every emitting step's JAX top-1/top-2 margin >=
# 0.0547 under the dequant route in all three pool modes.
SPEC = {
    "engine": {"max_batch": 2, "max_seq": 48, "kv_mode": "int8"},
    "budget": {"augment-on-pressure": 6000},
    "prompt_lens": [21, 9, 26, 14],
    "prompt_seed": 94,
    "max_new": 4,
}
POOL_MODES = ("auto", "always-augmented", "augment-on-pressure")


def prompts():
    rng = np.random.default_rng(SPEC["prompt_seed"])
    return [rng.integers(0, 512, size=n).astype(np.int32)
            for n in SPEC["prompt_lens"]]


def _jax_hybrid_oracle(kv_impl, pool_mode, params, spec, prompts):
    """Serve `prompts` with the JAX engine at the reduced hybrid config;
    return tokens, the smallest top-1/top-2 margin of any emitting decode
    step, the dispatch count, pool stats, byte accounting and the ledger's
    events. Runs both here and, by source, in the child process."""
    import dataclasses
    import jax
    import numpy as np
    from jax.sharding import AxisType
    from repro.configs import get_arch
    from repro.serve import Request, ServeEngine

    class RecordingEngine(ServeEngine):
        min_margin = float("inf")

        def _step_all_decode(self):
            self._emitting = True
            try:
                return super()._step_all_decode()
            finally:
                self._emitting = False

        def _dispatch(self, fn, batch):
            logits = super()._dispatch(fn, batch)
            # wait for the step: the engine's stepwise prefill bumps its
            # numpy positions right after the dispatch, and on the CPU
            # backend the in-flight step may still read that buffer
            jax.block_until_ready(logits)
            if getattr(self, "_emitting", False):
                rows = np.asarray(batch["write_mask"])
                lg = np.asarray(logits[:, -1, :self.cfg.vocab],
                                np.float32)[rows]
                if lg.size:
                    top = np.sort(lg, axis=-1)[:, -2:]
                    self.min_margin = min(self.min_margin,
                                          float((top[:, 1] - top[:, 0]).min()))
            return logits

    cfg = get_arch("recurrentgemma-9b").reduced()
    cfg = dataclasses.replace(cfg, amc=dataclasses.replace(
        cfg.amc, kv_impl=kv_impl, pool_mode=pool_mode))
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    eng = RecordingEngine(cfg, mesh, params=params,
                          pool_budget_bytes=spec["budget"].get(pool_mode),
                          **spec["engine"])
    out = eng.generate([Request(prompt=np.asarray(p, np.int32),
                                max_new_tokens=spec["max_new"], id=i)
                        for i, p in enumerate(prompts)])
    st = eng.stats()
    imc = st["imc"]
    return {"tokens": {str(k): [int(t) for t in v] for k, v in out.items()},
            "min_margin": eng.min_margin,
            "dispatches": eng.dispatch_count,
            "pool": {k: v for k, v in st["pool"].items()
                     if isinstance(v, (int, float, str))},
            "bytes": {k: int(st[k]) for k in (
                "weight_bytes_logical", "weight_bytes_physical",
                "cache_bytes_logical", "cache_bytes_physical")},
            "weight_mode": st["weight_mode"],
            "imc_events": {g: {c: int(n) for c, n in d["events"].items()}
                           for g, d in imc["groups"].items()},
            "imc_tokens": int(imc["tokens"])}


CHILD = """
import json, sys
import numpy as np
from jax.experimental.pallas import tpu as pltpu
pltpu.TPUCompilerParams = pltpu.CompilerParams
import jax, jax.numpy as jnp
args = json.loads(sys.argv[1])
flat = np.load(args["params"])
params = {}
for key in flat.files:
    a = flat[key]
    if a.dtype == np.uint16:
        a = a.view(jnp.bfloat16)
    node = params
    *path, leaf = key.split("/")
    for k in path:
        node = node.setdefault(k, {})
    node[leaf] = jnp.asarray(a)
%s
out = {pm: _jax_hybrid_oracle("kernel", pm, params, args["spec"],
                              args["prompts"]) for pm in args["pool_modes"]}
with open(args["out"], "w") as f:
    json.dump(out, f)
"""


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.fixture(scope="module")
def oracles(dense_params, tmp_path_factory):
    """JAX results for every (kv_impl, pool_mode): kv_impl="kernel" from the
    child process (started first), "dequant" in this process meanwhile."""
    tmp = tmp_path_factory.mktemp("hybrid_oracle")
    np_params = {k: (np.asarray(v).view(np.uint16)
                     if np.asarray(v).dtype.name == "bfloat16"
                     else np.asarray(v))
                 for k, v in _flatten(jax.tree.map(np.asarray,
                                                   dense_params))}
    np.savez(tmp / "params.npz", **np_params)
    ps = [p.tolist() for p in prompts()]
    args = {"params": str(tmp / "params.npz"), "out": str(tmp / "kernel.json"),
            "spec": SPEC, "prompts": ps, "pool_modes": list(POOL_MODES)}
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join(
               [str(REPO / "src"), os.environ.get("PYTHONPATH", "")])}
    child = subprocess.Popen(
        [sys.executable, "-c",
         CHILD % inspect.getsource(_jax_hybrid_oracle), json.dumps(args)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        res = {("dequant", pm): _jax_hybrid_oracle("dequant", pm,
                                                   dense_params, SPEC, ps)
               for pm in POOL_MODES}
        log, _ = child.communicate(timeout=600)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    assert child.returncode == 0, log[-4000:]
    with open(tmp / "kernel.json") as f:
        for pm, r in json.load(f).items():
            res[("kernel", pm)] = r
    return res


@pytest.mark.parametrize("pool_mode", POOL_MODES)
@pytest.mark.parametrize("kv_impl", ["dequant", "kernel"])
def test_engine_matches_jax(oracles, torch_params, kv_impl, pool_mode):
    """Tokens, dispatch counts (every prompt token but the last is one
    decode dispatch), slab pool stats, byte accounting and the ledger's
    events equal the JAX engine's, at both kv_impl routes and every pool
    mode; the kernel route takes kernel 6's plain version here."""
    want = oracles[(kv_impl, pool_mode)]
    assert want["min_margin"] > MIN_MARGIN, \
        f"prompt set sits on an argmax near-tie ({want['min_margin']})"
    cfg = tcfg_of(kv_impl=kv_impl, pool_mode=pool_mode)
    eng = ServeEngine(cfg, device="cpu", params=torch_params,
                      pool_budget_bytes=SPEC["budget"].get(pool_mode),
                      **SPEC["engine"])
    out = eng.generate([Request(prompt=p, max_new_tokens=SPEC["max_new"],
                                id=i) for i, p in enumerate(prompts())])
    assert {str(k): v for k, v in out.items()} == want["tokens"]
    assert eng.dispatch_count == want["dispatches"] \
        == sum(SPEC["prompt_lens"]) - len(SPEC["prompt_lens"]) \
        + eng.step_idx
    st = eng.stats()
    assert {k: want["pool"][k] for k in st["pool"]} == st["pool"]
    assert {k: st[k] for k in want["bytes"]} == want["bytes"]
    assert st["weight_mode"] == want["weight_mode"] == "normal"
    imc = st["imc"]
    assert {g: d["events"] for g, d in imc["groups"].items()} \
        == want["imc_events"]
    assert imc["tokens"] == want["imc_tokens"]
    if pool_mode == "augment-on-pressure":
        assert st["augment_events"] > 0
    assert eng.scheduler.stats["enqueued"] == len(SPEC["prompt_lens"])
    assert not eng.active.any() and not eng.scheduler.queue


def test_engine_reproduces_the_pinned_hybrid_golden(torch_params):
    """`_PRE_REFACTOR_GOLDENS["recurrentgemma-9b"]` of the JAX package's
    tests/test_scheduler.py (its engine at seed 0, max_batch=2,
    max_seq=32, prompts default_rng(42) of lengths 5 and 9, 6 new tokens),
    served by the port on JAX's seed-0 weights through the default
    routes (kernel 6's plain version here)."""
    cfg = get_arch(ARCH).reduced()
    rng = np.random.default_rng(42)
    ps = [rng.integers(0, cfg.vocab, size=(n,)).astype(np.int32)
          for n in (5, 9)]
    eng = ServeEngine(cfg, device="cpu", params=torch_params, max_batch=2,
                      max_seq=32, prefill_chunk=8)
    outs = eng.generate([Request(prompt=p, max_new_tokens=6, id=i)
                         for i, p in enumerate(ps)])
    assert outs == {0: [430, 373, 307, 305, 84, 392],
                    1: [392, 336, 316, 170, 10, 316]}
