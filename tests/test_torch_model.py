"""The port's dense model over the paged pool, held against the JAX
package at the reduced config: one chunked-prefill dispatch and one
decode step, logits and pool contents compared, through the JAX
reference paths (kv_impl="dequant", matmul_impl="dense") on an Auto-axis
mesh built here. The JAX side runs at kv_mode="int8" in this process;
int4 goes through the engine oracle in tests/test_torch_serve.py.

Tolerances: page tables exact; logits rel_err < 0.05 (as
tests/test_augmented_model.py); the gathered KV caches rel_err < 0.05,
since K/V come out of float projections computed in two frameworks and a
quantization level may move by one where a value sits on a boundary.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import get_arch as jax_get_arch
from repro.kernels import ref
from repro.launch.mesh import mesh_context
from repro.models import augment as jaug
from repro.models import model as jm
from repro.models.params import init_params as jax_init_params
from repro.serve import cache_pool as jpool_mod
from repro_torch.configs import get_arch
from repro_torch.kernels.paged_kv_attention import paged_gather_kv
from repro_torch.models import model as tm
from repro_torch.models.params import from_numpy_tree
from repro_torch.serve import cache_pool as tpool_mod

CPU = torch.device("cpu")
B, C, MAX_SEQ = 2, 8, 48


def ref_cfg(cfg):
    return dataclasses.replace(cfg, amc=dataclasses.replace(
        cfg.amc, kv_impl="dequant", matmul_impl="dense"))


@pytest.fixture(scope="module")
def mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))


@pytest.fixture(scope="module")
def packed_params():
    """Ternary-packed weights made by the JAX package, as numpy."""
    cfg = jax_get_arch("qwen1.5-0.5b").reduced()
    dense_cfg = dataclasses.replace(cfg, amc=dataclasses.replace(
        cfg.amc, weight_mode="normal"))
    dense = jax_init_params(jm.abstract_params(dense_cfg),
                            jax.random.PRNGKey(3))
    return jax.tree.map(np.asarray, jaug.augment_params(cfg, dense))


def pools(pool_mode):
    jcfg = ref_cfg(jax_get_arch("qwen1.5-0.5b").reduced())
    jcfg = dataclasses.replace(jcfg, amc=dataclasses.replace(
        jcfg.amc, pool_mode=pool_mode))
    tcfg = get_arch("qwen1.5-0.5b").reduced()
    tcfg = dataclasses.replace(tcfg, amc=dataclasses.replace(
        tcfg.amc, pool_mode=pool_mode))
    jp = jpool_mod.PagedKVPool(jcfg, max_batch=B, max_seq=MAX_SEQ)
    tp = tpool_mod.PagedKVPool(tcfg, max_batch=B, max_seq=MAX_SEQ,
                               device=CPU)
    for p in (jp, tp):
        assert p.admit_row(0, C + 1, step=0)
        assert p.admit_row(1, C - 3, step=0)
    return jcfg, tcfg, jp, tp


def assert_tables_equal(jp, tp):
    jt, tt_ = jp.device_tables(), tp.device_tables()
    np.testing.assert_array_equal(tt_["page_table"].numpy(),
                                  np.asarray(jt["page_table"]))
    np.testing.assert_array_equal(tt_["page_modes"].numpy(),
                                  np.asarray(jt["page_modes"]))


def gathered(jcfg, jp, tp):
    jt, tt_ = jp.device_tables(), tp.device_tables()
    a = jp.arenas
    jk, jv = ref.paged_gather_kv_ref(
        a["kn"][0], a["vn"][0], a["kp"][0], a["vp"][0], a["ks"][0],
        a["vs"][0], jt["page_table"], jt["page_modes"],
        kv_bits=jcfg.amc.aug_bits)
    t = tp.arenas
    tk, tv = paged_gather_kv(t["kn"][0], t["vn"][0], t["kp"][0], t["vp"][0],
                             t["ks"][0], t["vs"][0], tt_["page_table"],
                             tt_["page_modes"], kv_bits=jcfg.amc.aug_bits)
    return (np.asarray(jk), np.asarray(jv)), (tk.numpy(), tv.numpy())


@pytest.mark.parametrize("pool_mode", ["always-augmented", "normal-only",
                                       "augment-on-pressure"])
def test_prefill_chunk_and_decode_step_match_jax(mesh, packed_params,
                                                 pool_mode):
    jcfg, tcfg, jp, tp = pools(pool_mode)
    assert_tables_equal(jp, tp)
    tparams = from_numpy_tree(packed_params, CPU)
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, jcfg.vocab, size=(B, C)).astype(np.int32)
    starts = np.zeros(B, np.int32)
    wmask = np.ones(B, bool)

    def jbatch(extra):
        return {**jp.device_tables(), **{k: jnp.asarray(v)
                                         for k, v in extra.items()}}

    def tbatch(extra):
        return {**tp.device_tables(), **{k: torch.from_numpy(v)
                                         for k, v in extra.items()}}

    pre = {"tokens": tokens, "positions": starts, "write_mask": wmask}
    with mesh_context(mesh):
        jl, jp.arenas = jax.jit(lambda p, s, b: jm.paged_prefill_step(
            jcfg, p, s, b))(packed_params, jp.arenas, jbatch(pre))
    tl, _ = tm.paged_prefill_step(tcfg, tparams, tp.arenas, tbatch(pre))
    V = jcfg.vocab
    assert ref.rel_err(tl.numpy()[..., :V], np.asarray(jl)[..., :V]) < 0.05
    (jk, jv), (tk, tv) = gathered(jcfg, jp, tp)
    # only the written slots: both rows wrote C tokens into their first
    # page; the rest of the logical cache is unwritten
    assert ref.rel_err(tk[:, :, :C], jk[:, :, :C]) < 0.05
    assert ref.rel_err(tv[:, :, :C], jv[:, :, :C]) < 0.05

    if pool_mode == "augment-on-pressure":
        # move row 0's first page to the Augmented plane on both sides
        jp.augment_page(0, 0, step=1)
        tp.augment_page(0, 0, step=1)
        assert_tables_equal(jp, tp)

    nxt = np.asarray(jl)[:, -1, :V].argmax(-1).astype(np.int32)[:, None]
    dec = {"tokens": nxt, "positions": np.full(B, C, np.int32),
           "write_mask": wmask}
    with mesh_context(mesh):
        jl2, jp.arenas = jax.jit(lambda p, s, b: jm.paged_decode_step(
            jcfg, p, s, b))(packed_params, jp.arenas, jbatch(dec))
    tl2, _ = tm.paged_decode_step(tcfg, tparams, tp.arenas, tbatch(dec))
    assert ref.rel_err(tl2.numpy()[..., :V], np.asarray(jl2)[..., :V]) < 0.05
    (jk, jv), (tk, tv) = gathered(jcfg, jp, tp)
    assert ref.rel_err(tk[:, :, :C + 1], jk[:, :, :C + 1]) < 0.05
    assert ref.rel_err(tv[:, :, :C + 1], jv[:, :, :C + 1]) < 0.05


def test_kernel_route_matches_plain_route_on_cpu(packed_params):
    """On CPU tensors the default routes (kv_impl="kernel",
    matmul_impl="packed") take the kernels' plain versions; they must
    agree with the dequant/dense reference routes."""
    tparams = from_numpy_tree(packed_params, CPU)
    cfg = get_arch("qwen1.5-0.5b").reduced()
    out = []
    for c in (cfg, ref_cfg(cfg)):
        tp = tpool_mod.PagedKVPool(c, max_batch=B, max_seq=MAX_SEQ,
                                   device=CPU)
        for r in range(B):
            tp.admit_row(r, C + 1, step=0)
        tokens = torch.arange(B * C, dtype=torch.int32).reshape(B, C)
        b = {**tp.device_tables(), "tokens": tokens,
             "positions": torch.zeros(B, dtype=torch.int32),
             "write_mask": torch.ones(B, dtype=torch.bool)}
        tm.paged_prefill_step(c, tparams, tp.arenas, b)
        b.update(tokens=tokens[:, -1:], positions=torch.full(
            (B,), C, dtype=torch.int32))
        logits, _ = tm.paged_decode_step(c, tparams, tp.arenas, b)
        out.append(logits[..., :cfg.vocab].numpy())
    assert ref.rel_err(out[0], out[1]) < 0.05


def jbf16(t: torch.Tensor):
    """A bf16 torch tensor as the same jnp bf16 array (exact via f32)."""
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


@pytest.mark.parametrize("aug_bits", [8, 4])
def test_page_ops_match_jax_primitives(aug_bits):
    """Augment (Normal -> Augmented), promote (back) and zero move one
    physical page between planes: bytes and scales equal the JAX pack,
    the promoted page equals the JAX unpack, other pages untouched."""
    from repro.models import layers as jl
    cfg = get_arch("qwen1.5-0.5b").reduced()
    cfg = dataclasses.replace(cfg, amc=dataclasses.replace(
        cfg.amc, kv_mode="int4" if aug_bits == 4 else "int8",
        pool_mode="augment-on-pressure"))
    tp = tpool_mod.PagedKVPool(cfg, max_batch=1, max_seq=64, device=CPU)
    gen = torch.Generator().manual_seed(aug_bits)
    for k in ("kn", "vn"):
        tp.arenas[k][:] = torch.randn(tp.arenas[k].shape, generator=gen
                                      ).to(torch.bfloat16)
    before = {k: v.clone() for k, v in tp.arenas.items()}
    tpool_mod._augment_page_op(tp.arenas, 1, 2, cfg=cfg)
    pack = ref.quantize_pack_kv_ref if aug_bits == 4 else jl.pack_kv_int8
    for plane, packed, scale in (("kn", "kp", "ks"), ("vn", "vp", "vs")):
        jp_, js_ = pack(jbf16(before[plane][:, 1]))
        np.testing.assert_array_equal(tp.arenas[packed][:, 2].numpy(),
                                      np.asarray(jp_))
        np.testing.assert_array_equal(
            tp.arenas[scale][:, 2].float().numpy(),
            np.asarray(js_[..., 0].astype(jnp.bfloat16).astype(jnp.float32)))
    for k in ("kn", "vn", "kp", "vp"):
        keep = torch.ones(tp.arenas[k].shape[1], dtype=torch.bool)
        keep[2 if k in ("kp", "vp") else 1] = False
        assert torch.equal(tp.arenas[k][:, keep], before[k][:, keep])
    tpool_mod._promote_page_op(tp.arenas, 2, 3, aug_bits=aug_bits)
    unpack = jl.unpack_kv_int4 if aug_bits == 4 else jl.unpack_kv_int8
    jd = unpack(jnp.asarray(tp.arenas["kp"][:, 2].numpy()),
                jbf16(tp.arenas["ks"][:, 2])[..., None])
    np.testing.assert_array_equal(tp.arenas["kn"][:, 3].float().numpy(),
                                  np.asarray(jd.astype(jnp.float32)))
    tpool_mod._zero_page_op(tp.arenas, 3, mode=0)
    tpool_mod._zero_page_op(tp.arenas, 2, mode=1)
    assert not tp.arenas["kn"][:, 3].any() and not tp.arenas["kp"][:, 2].any()
    assert not tp.arenas["ks"][:, 2].float().any()
