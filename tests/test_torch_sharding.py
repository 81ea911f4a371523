"""The port's sharding rules held to the JAX package's, decision for
decision: `Rules.resolve` of every logical axis and the pspec of every
leaf of the parameter trees (dense and packed: ternary, dual), the decode
caches and the optimizer state (AdamW, AMC-Adam), for all 10 archs x the
4 assigned shapes on production, fleet and test meshes; the configs'
analytic counts (`param_count`, `active_param_count`, `model_flops`); and
the rules tests of tests/test_distributed.py run on the port.

`Rules` reads only the mesh's axis sizes, so a stand-in mesh with a
`shape` dict serves both packages; the port's rules take the JAX
package's 16 GiB device memory (`hbm_bytes`) so that the inference
profile decides as the TPU one does. Both packages run in this process:
nothing here touches a device or a process group.
"""
import dataclasses

import pytest

from repro.configs import get_arch as jax_arch
from repro.configs import get_shape as jax_shape
from repro.distributed.sharding import Rules as JaxRules
from repro.distributed.sharding import tree_pspecs as jax_tree_pspecs
from repro.models import augment as jax_augment
from repro.models import model as jax_model
from repro.train import step as jax_step
from repro_torch.configs import ARCHS, SHAPES, get_arch, get_shape
from repro_torch.configs.registry import all_cells
from repro_torch.distributed.sharding import (DEFAULT_RULES, Rules,
                                              tree_pspecs)
from repro_torch.models import augment, params as tparams
from repro_torch.models import model as tmodel
from repro_torch.train import step as step_lib

GiB16 = 16 * 1024 ** 3
MESHES = ([{"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16}]
          + [{"data": 1, "model": m} for m in (1, 2, 3, 4, 5, 7, 8)]
          + [{"data": 2, "model": 2}, {"data": 4, "model": 1}])
MESH_IDS = ["x".join(f"{k}{v}" for k, v in m.items()) for m in MESHES]


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape


def _norm(spec):
    """A pspec as a tuple with one-axis entries as the bare name (the
    form jax's PartitionSpec keeps)."""
    return tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a
                 for a in spec)


def _flat(tree, prefix=()):
    """{path: leaf} of nested dicts and NamedTuples."""
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(_flat(tree[k], prefix + (k,)))
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = {}
        for k, v in zip(tree._fields, tree):
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


def _weight_modes(cfg_t, cfg_j):
    for wm in ("normal", "ternary", "dual"):
        yield wm, (dataclasses.replace(cfg_t, amc=dataclasses.replace(
            cfg_t.amc, weight_mode=wm)), dataclasses.replace(
            cfg_j, amc=dataclasses.replace(cfg_j.amc, weight_mode=wm)))


def _kv_modes(cfg_t, cfg_j):
    for kv in ("normal", "int4", "int8"):
        yield kv, (dataclasses.replace(cfg_t, amc=dataclasses.replace(
            cfg_t.amc, kv_mode=kv)), dataclasses.replace(
            cfg_j, amc=dataclasses.replace(cfg_j.amc, kv_mode=kv)))


def _same_specs(tag, tree_t, tree_j, rules_t, rules_j):
    ft, fj = _flat(tree_t), _flat(tree_j)
    assert ft.keys() == fj.keys(), (tag, set(ft) ^ set(fj))
    for path in ft:
        a, b = ft[path], fj[path]
        assert a.shape == b.shape and a.axes == b.axes, (tag, path, a, b)
        assert _norm(rules_t.pspec(*a.axes)) == tuple(
            rules_j.pspec(*b.axes)), (tag, path, a.axes)


@pytest.mark.parametrize("mesh", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_rules_and_leaf_specs_match_jax(arch, mesh):
    fake = FakeMesh(mesh)
    cfg_t, cfg_j = get_arch(arch), jax_arch(arch)
    for sname in SHAPES:
        shape_t, shape_j = get_shape(sname), jax_shape(sname)
        rt = Rules.make(fake, cfg_t, shape_t, hbm_bytes=GiB16)
        rj = JaxRules.make(fake, cfg_j, shape_j)
        assert rt.sizes == rj.sizes and rt.table == rj.table, sname
        for logical in list(DEFAULT_RULES) + [None, "unknown"]:
            got, want = rt.resolve(logical), rj.resolve(logical)
            assert got == want, (sname, logical, got, want)
        for wm, (ct, cj) in _weight_modes(cfg_t, cfg_j):
            at = augment.augment_pspecs(ct, tparams.abstract_params(ct))
            aj = jax_augment.augment_pspecs(cj,
                                            jax_model.abstract_params(cj))
            _same_specs(f"{sname}/{wm}/params", at, aj, rt, rj)
        ap_t = tparams.abstract_params(cfg_t)
        ap_j = jax_model.abstract_params(cfg_j)
        got = {k: _norm(v)
               for k, v in _flat(tree_pspecs(ap_t, rt)).items()}
        want = {k: tuple(v) for k, v in _flat(jax_tree_pspecs(ap_j,
                                                              rj)).items()}
        assert got == want, sname
        for opt in ("adamw", "amc_adamw"):
            _same_specs(f"{sname}/{opt}", step_lib.opt_abstract(ap_t, opt),
                        jax_step.opt_abstract(ap_j, opt), rt, rj)
        for kv, (ct, cj) in _kv_modes(cfg_t, cfg_j):
            _same_specs(f"{sname}/{kv}/cache",
                        tmodel.abstract_cache(ct, shape_t.global_batch,
                                              shape_t.seq_len),
                        jax_model.abstract_cache(cj, shape_j), rt, rj)
            got = {k: _norm(v) for k, v in _flat(step_lib.cache_pspecs(
                ct, shape_t, rt)).items()}
            want = {k: tuple(v) for k, v in _flat(jax_step.cache_pspecs(
                cj, shape_j, rj)).items()}
            assert got == want, (sname, kv)
        got = {k: _norm(v) for k, v in step_lib.batch_pspecs(
            cfg_t, shape_t, rt).items()}
        want = {k: tuple(v) for k, v in jax_step.batch_pspecs(
            cfg_j, shape_j, rj).items()}
        assert got == want, sname


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_counts_and_flops_match_jax(arch):
    cfg_t, cfg_j = get_arch(arch), jax_arch(arch)
    for c_t, c_j in ((cfg_t, cfg_j), (cfg_t.reduced(), cfg_j.reduced())):
        assert c_t.param_count() == c_j.param_count()
        assert c_t.active_param_count() == c_j.active_param_count()
        assert c_t.nonembed_param_count() == c_j.nonembed_param_count()
        assert (c_t.nonembed_active_param_count()
                == c_j.nonembed_active_param_count())
        assert c_t.sub_quadratic == c_j.sub_quadratic
        assert c_t.attention_free == c_j.attention_free
        for sname in SHAPES:
            assert c_t.model_flops(get_shape(sname)) == c_j.model_flops(
                jax_shape(sname))


def test_cells_match_jax():
    from repro.configs import all_cells as jax_cells
    got = [(c.name, s.name, ok, why) for c, s, ok, why in all_cells()]
    want = [(c.name, s.name, ok, why) for c, s, ok, why in jax_cells()]
    assert sorted(got) == sorted(want) and len(got) == 40


def test_inference_profile_follows_device_memory():
    """The one departure: FSDP stays for serving where the TP-sharded
    weights take half the device's memory or more. grok-1 (316 B params,
    39.5 GiB a rank at TP 16) keeps it at 16 GiB and at the H100's 80 GB
    drops it; qwen3-moe (61 GB over 16) drops it at both."""
    mesh = FakeMesh({"data": 16, "model": 16})
    shape = get_shape("decode_32k")
    grok, qwen3 = get_arch("grok-1-314b"), get_arch("qwen3-moe-30b-a3b")
    assert Rules.make(mesh, grok, shape, hbm_bytes=GiB16).resolve(
        "embed") == ("data",)
    assert Rules.make(mesh, grok, shape).resolve("embed") is None
    for hbm in (GiB16, 80 * 10 ** 9):
        assert Rules.make(mesh, qwen3, shape, hbm_bytes=hbm).resolve(
            "embed") is None
    # training keeps FSDP whatever the memory
    assert Rules.make(mesh, grok, get_shape("train_4k")).resolve(
        "embed") == ("data",)


def test_pspec_shape_assertion():
    with pytest.raises(AssertionError):
        tparams.PSpec((4, 4), ("embed",))


# ---------------------------------------------------------------------------
# the rules tests of tests/test_distributed.py, on the port
# ---------------------------------------------------------------------------

def _rules(cfg, shape_name, mesh_shape=None):
    mesh = FakeMesh(mesh_shape or {"data": 16, "model": 16})
    return Rules.make(mesh, cfg, get_shape(shape_name))


def test_rules_head_tp_disabled_for_indivisible_heads():
    r = _rules(get_arch("minicpm-2b"), "train_4k")       # 36 heads
    assert r.resolve("heads") is None
    assert r.resolve("mlp") == ("model",)                 # 5760 % 16 == 0
    r2 = _rules(get_arch("whisper-tiny"), "train_4k")     # 6 heads
    assert r2.resolve("heads") is None
    r3 = _rules(get_arch("granite-3-2b"), "train_4k")     # 32 heads
    assert r3.resolve("heads") == ("model",)


def test_rules_heads_degrade_to_replication_on_fleet_submeshes():
    cfg = get_arch("granite-3-2b")                        # 32 heads
    for model_axis, want in [(1, ("model",)), (2, ("model",)),
                             (4, ("model",)), (3, None), (5, None),
                             (7, None)]:
        r = _rules(cfg, "train_4k", {"data": 1, "model": model_axis})
        assert r.resolve("heads") == want, \
            f"32 heads over model={model_axis}: got {r.resolve('heads')}"
    r = _rules(get_arch("minicpm-2b"), "train_4k",        # 36 heads
               {"data": 1, "model": 8})
    assert r.resolve("heads") is None
    assert r.resolve("mlp") == ("model",)                  # 5760 % 8 == 0


def test_rules_single_device_array_replicates_trivially():
    r = _rules(get_arch("granite-3-2b"), "train_4k",
               {"data": 1, "model": 1})
    assert r.resolve("heads") == ("model",)
    assert r.resolve("mlp") == ("model",)


def test_rules_kv_vs_cache_seq_exclusive():
    r = _rules(get_arch("qwen1.5-0.5b"), "decode_32k")    # kv 16 / 16
    assert r.resolve("kv_heads") == ("model",)
    assert r.resolve("cache_seq") is None
    r2 = _rules(get_arch("granite-3-2b"), "decode_32k")   # kv 8 / 16
    assert r2.resolve("kv_heads") is None
    assert r2.resolve("cache_seq") == ("model",)


def test_rules_batch_not_sharded_when_too_small():
    r = _rules(get_arch("mamba2-130m"), "long_500k")      # batch 1
    assert r.resolve("batch") is None


def test_rules_moe_modes():
    r = _rules(get_arch("qwen3-moe-30b-a3b"), "train_4k")
    assert r.resolve("experts") == ("model",)              # EP: 128/16
    r2 = _rules(get_arch("grok-1-314b"), "train_4k")
    assert r2.resolve("experts") is None                   # TP: 8 experts
    assert r2.resolve("mlp") == ("model",)


def test_param_and_opt_spec_trees_align():
    from repro_torch.tree import flatten
    ap = tparams.abstract_params(get_arch("qwen3-moe-30b-a3b"))
    oa = step_lib.opt_abstract(ap, "amc_adamw")
    # the int8 moments and the scales have the parameters' structure
    assert flatten(oa.m_q)[1] == flatten(ap)[1]
    assert flatten(oa.v_scale)[1] == flatten(ap)[1]
    for m, p in zip(flatten(oa.m_scale)[0], flatten(ap)[0]):
        assert m.shape == p.shape[:-1] + (1,)
        assert m.axes == p.axes[:-1] + (None,)
