"""The port's dry run (`repro_torch.launch.dryrun`, `op_analysis`,
`report`, `configs.input_specs` and the kernels' meta route) held to the
JAX package's dry run.

- The analyzer is calibrated as tests/test_dryrun.py calibrates the HLO
  analysis: a loop-free product, a loop of 10 and nested loops of 5 x 3,
  FLOPs equal to the analytic count and to `analyze_hlo` of the same
  function (JAX compiled here, on the CPU).
- `input_specs`, per-device argument bytes (parameters, optimizer
  state, cache, inputs), skip records and `model_flops` per device equal
  JAX's in every cell of both production meshes: the JAX side from its
  pspecs on an `AbstractMesh` (no devices), the port's rules at JAX's
  16 GiB device memory so that they decide as JAX's do.
- A meta trace's FLOPs equal `FlopCounterMode`'s on the same reduced
  step run on real CPU tensors (each family's train, prefill and decode
  steps, and the chunked prefill of the transformer families), and the
  meta trace's kernel launches equal the real run's calls of the same
  entries' plain versions.
- Traced FLOPs of the reduced qwen train and prefill steps are within 1%
  of `analyze_hlo` of the same step compiled by JAX on a (1, 1) mesh;
  other families' ratios are pinned with their reasons.
- granite-3-2b train_4k is traced whole at (16, 16) within 20 s, the
  contiguous int4 decode counts one kernel-6 launch a layer, the report
  renders.
Nothing here allocates more than a reduced model on the CPU.
"""
import dataclasses
import json
import time

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh, AxisType
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import cell_applicable as jax_cell_applicable
from repro.configs import get_arch as jax_arch
from repro.configs import get_shape as jax_shape
from repro.configs import input_specs as jax_input_specs
from repro.configs.base import ShapeConfig as JaxShape
from repro.distributed.sharding import Rules as JaxRules
from repro.launch.hlo_analysis import analyze_hlo
from repro.launch.mesh import mesh_context
from repro.models import model as jax_model
from repro.models.params import to_shape_dtype
from repro.train import step as jax_step
from repro_torch.configs import (ARCHS, SHAPES, cell_applicable, get_arch,
                                 get_shape, input_specs)
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed.sharding import Rules
from repro_torch.kernels import ops
from repro_torch.launch import dryrun, report
from repro_torch.launch.op_analysis import analyze
from repro_torch.models import model as M
from repro_torch.models.params import abstract_params, init_params
from repro_torch.optim import adamw
from repro_torch.train import step as step_lib

GiB16 = 16 * 1024 ** 3
MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}
JAX_DTYPE = {"bf16": torch.bfloat16, "f32": torch.float32,
             "u8": torch.uint8, "i8": torch.int8, "i32": torch.int32}
TORCH_OF = {jnp.dtype(jnp.bfloat16): torch.bfloat16,
            jnp.dtype(jnp.float32): torch.float32,
            jnp.dtype(jnp.int32): torch.int32}


# ---------------------------------------------------------------------------
# The analyzer
# ---------------------------------------------------------------------------

def _meta(*shape):
    return torch.empty(shape, device="meta")


def _jax_flops(f, *shapes) -> float:
    args = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    return analyze_hlo(jax.jit(f).lower(*args).compile().as_text())["flops"]


def test_analyzer_matches_jax_loop_free():
    _, r = analyze(lambda x, w: torch.tanh(x @ w), _meta(128, 256),
                   _meta(256, 512))
    assert r["flops"] == 2 * 128 * 256 * 512
    assert r["flops"] == _jax_flops(lambda x, w: jnp.tanh(x @ w),
                                    (128, 256), (256, 512))
    # mm reads x, w and writes y; tanh reads y and writes its result
    assert r["bytes_accessed"] == 4 * (128 * 256 + 256 * 512
                                       + 3 * 128 * 512)
    assert r["ops_by_name"] == {"mm": 1, "tanh": 1}


def test_analyzer_multiplies_loops():
    def f(x, w):
        for _ in range(10):
            x = torch.tanh(x @ w)
        return x

    def g(x, w):
        def body(c, _):
            return jnp.tanh(c @ w), None
        return jax.lax.scan(body, x, None, length=10)[0]
    _, r = analyze(f, _meta(128, 256), _meta(256, 256))
    assert r["flops"] == 2 * 128 * 256 * 256 * 10
    assert r["flops"] == _jax_flops(g, (128, 256), (256, 256))
    assert r["ops_by_name"] == {"mm": 10, "tanh": 10}


def test_analyzer_nested_loops():
    def f(x, w):
        for _ in range(3):
            for _ in range(5):
                x = x @ w
            x = torch.tanh(x)
        return x
    _, r = analyze(f, _meta(64, 128), _meta(128, 128))
    assert r["flops"] == 2 * 64 * 128 * 128 * 15


def test_analyzer_skips_views_and_watches_shapes():
    """Views and allocations move no bytes; a watched (shape, dtype)
    matches a made tensor (an allocation too, not a view) in any dim
    order, and only at its dtype."""
    x = torch.empty((4, 8), dtype=torch.bfloat16, device="meta")

    def f(x):
        y = x.t().reshape(8, 4)                    # views only
        z = y.float() + 1                          # (8, 4) f32
        return torch.empty((4, 8), device="meta"), z.to(torch.bfloat16)
    _, r = analyze(f, x, watch=[((8, 4), torch.bfloat16),
                                ((4, 8), torch.float32)])
    # _to_copy 64 B in + 128 out, add 128 + 128, _to_copy 128 + 64
    assert r["bytes_accessed"] == 64 + 128 + 256 + 192
    assert r["shapes"][0] == {"_to_copy": 1}
    assert r["shapes"][1] == {"_to_copy": 1, "add": 1, "empty": 1}


def test_analyzer_peak_live_bytes():
    """A result is live from its op until it is freed; a result written
    into an operand (in place) is not new."""
    def f(x, w):
        y = x @ w                                  # 256 KiB
        z = torch.tanh(y)                          # 256 KiB, y still live
        del y
        z.add_(1)
        x.add_(1)
        u = z * 2                                  # 256 KiB, y freed
        return u.sum()                             # 4 B beside z and u
    _, r = analyze(f, _meta(128, 256), _meta(256, 512))
    assert r["peak_live_bytes"] == 2 * 128 * 512 * 4 + 4


# ---------------------------------------------------------------------------
# The kernels' meta route
# ---------------------------------------------------------------------------

def _kernel_calls():
    """(counter name, `ops` entry, CPU args, kwargs) of each kernel entry
    at a small shape."""
    g = torch.Generator().manual_seed(0)
    bf = lambda *s: torch.randn(s, generator=g).to(torch.bfloat16)
    u8 = lambda *s: torch.randint(0, 255, s, generator=g, dtype=torch.uint8)
    f32 = lambda *s: torch.rand(s, generator=g) + 0.5
    B, KV, Hg, D, S, page, maxP = 2, 2, 2, 32, 16, 8, 2
    table = torch.tensor([[1, 2], [3, 0]], dtype=torch.int32)
    modes = torch.tensor([[1, 0], [1, 1]], dtype=torch.int32)
    pool = dict(kn=bf(4, KV, page, D), vn=bf(4, KV, page, D),
                kp=u8(4, KV, page, D // 2), vp=u8(4, KV, page, D // 2),
                k_scale=bf(4, KV, page).abs(), v_scale=bf(4, KV, page).abs())
    return [
        ("ternary_matmul", ops.ternary_matmul,
         (bf(3, 64), u8(16, 32), f32(1, 32)), {}),
        ("dense_matmul", ops.dense_matmul, (bf(2, 3, 64), bf(64, 32)), {}),
        ("expert_matmul", ops.expert_matmul, (bf(4, 3, 64), bf(4, 64, 32)),
         {}),
        ("dual_plane_matmul", ops.dual_plane_matmul,
         (bf(3, 64), u8(64, 32), f32(1, 32), f32(1, 32)), {}),
        ("imc_dot", ops.imc_dot, (bf(3, 64), u8(16, 32), f32(1, 32)), {}),
        ("imc_dual_dot", ops.imc_dual_dot,
         (bf(3, 64), u8(64, 32), f32(1, 32), f32(1, 32)), {}),
        ("packed_kv_attention", ops.packed_kv_attention,
         (bf(B, KV, Hg, D), u8(B, KV, S, D // 2), u8(B, KV, S, D // 2),
          bf(B, KV, S).abs(), bf(B, KV, S).abs(),
          torch.tensor([5, 16], dtype=torch.int32)), {"bs": 16}),
        ("paged_kv_attention", ops.paged_kv_attention,
         (bf(B, KV, Hg, D), *pool.values(),
          torch.tensor([9, 12], dtype=torch.int32), table, modes), {}),
        ("paged_kv_attention_window", ops.paged_kv_attention_window,
         (bf(B, KV, 3, Hg, D), *pool.values(),
          torch.tensor([4, 9], dtype=torch.int32), table, modes), {}),
        ("quantize_pack_kv", ops.quantize_pack_kv, (bf(2, 3, D),), {}),
        ("quantize_pack_kv_masked", ops.quantize_pack_kv,
         (bf(2, 3, D), torch.tensor([[True, False, True]] * 2)), {}),
    ]


@pytest.mark.parametrize("name", [c[0] for c in _kernel_calls()])
def test_meta_route_shapes_launches_and_report(name):
    """On `meta` each entry returns what its plain version returns on the
    CPU, in shape and dtype, and reports one launch to the active
    analyzer; the card's launch counters stay as they were (neither the
    CPU call nor the meta call launches anything)."""
    _, fn, args, kw = next(c for c in _kernel_calls() if c[0] == name)
    ops.reset_launch_counts()
    want = fn(*args, **kw)
    assert ops.launch_counts()[name] == 0
    margs = [a.to("meta") for a in args]
    got, r = analyze(fn, *margs, **kw)
    assert ops.launch_counts()[name] == 0
    assert r["kernels"][name]["launches"] == 1
    assert r["kernels"][name]["bytes"] > 0
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert [(t.shape, t.dtype) for t in got] == \
        [(t.shape, t.dtype) for t in want]
    assert all(t.device.type == "meta" for t in got)


def test_meta_route_paged_write_counts_one_launch():
    B, T, KV, D, page = 2, 3, 2, 32, 8
    table = torch.tensor([[1, 2], [3, 0]], dtype=torch.int32)
    m = lambda *s, dt=torch.bfloat16: torch.empty(s, dtype=dt, device="meta")
    ops.reset_launch_counts()
    _, r = analyze(ops.paged_kv_write, m(4, KV, page, D), m(4, KV, page, D),
                   m(4, KV, page, D // 2, dt=torch.uint8),
                   m(4, KV, page, D // 2, dt=torch.uint8), m(4, KV, page),
                   m(4, KV, page), m(B, T, KV, D), m(B, T, KV, D),
                   m(B, T, dt=torch.int32), m(B, T, dt=torch.bool), None,
                   table.to("meta"), table.to("meta"), page_size=page,
                   policy="always-augmented", aug_bits=4)
    assert r["kernels"]["paged_kv_write"]["launches"] == 1
    assert ops.launch_counts()["paged_kv_write"] == 0
    # reads: K/V rows, positions, mask, both table rows; writes: packed
    # rows and their scales
    assert r["kernels"]["paged_kv_write"]["bytes"] == \
        2 * B * T * KV * D * 2 + B * T * 4 + B * T + 2 * 2 * 2 * 4 \
        + 2 * B * T * KV * (D // 2 + 2)


def test_route_takes_the_card_off_cpu_and_meta():
    """A device that is neither the CPU nor meta takes the CUDA wrapper,
    which raises there: the meta route is no way round the card."""
    class Dev:
        class device:
            type = "xpu"
    assert ops._route(Dev(), "plain", "cuda", "meta") == "cuda"
    assert ops._route(Dev(), "plain", "cuda", "meta", True) == "plain"
    assert ops._route(_meta(1), "plain", "cuda", "meta") == "meta"
    assert ops._route(torch.zeros(1), "plain", "cuda", "meta") == "plain"


# ---------------------------------------------------------------------------
# input_specs, bytes and skips against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list(ARCHS))
def test_input_specs_match_jax(arch):
    for name in SHAPES:
        got = input_specs(get_arch(arch), get_shape(name))
        want = jax_input_specs(jax_arch(arch), jax_shape(name))
        assert sorted(got) == sorted(want)
        for k, t in got.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == want[k].shape
            assert t.dtype == TORCH_OF[jnp.dtype(want[k].dtype)]


def _jax_bytes(tree, specs, sizes) -> int:
    leaves = jax.tree.leaves(tree, is_leaf=lambda x: hasattr(x, "axes"))
    pspecs = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))
    assert len(leaves) == len(pspecs)
    total = 0
    for l, p in zip(leaves, pspecs):
        spec = [(a,) if isinstance(a, str) else a for a in
                tuple(p) + (None,) * (len(l.shape) - len(p))]
        total += dryrun.shard_nbytes(l.shape, JAX_DTYPE[l.dtype], spec,
                                     sizes)
    return total


def _jax_cell_bytes(cfg, shape, mesh, optimizer) -> dict:
    """JAX's per-device argument bytes of the cell, from its pspecs (the
    trees and specs `repro.launch.dryrun.build_cell` shards)."""
    rules = JaxRules.make(mesh, cfg, shape)
    sizes = dict(mesh.shape)
    ap = jax_model.abstract_params(cfg)
    out = {"params": _jax_bytes(ap, jax_step.param_pspecs(ap, rules),
                                sizes), "opt": 0, "cache": 0}
    if shape.kind == "train":
        oa = jax_step.opt_abstract(ap, optimizer)
        out["opt"] = _jax_bytes(oa, jax_step.param_pspecs(oa, rules), sizes)
    elif shape.kind == "decode":
        ca = jax_model.abstract_cache(cfg, shape)
        out["cache"] = _jax_bytes(ca, jax_step.param_pspecs(ca, rules),
                                  sizes)
    specs = jax_step.batch_pspecs(cfg, shape, rules)
    out["inputs"] = 0
    for k, s in jax_input_specs(cfg, shape).items():
        spec = [(a,) if isinstance(a, str) else a for a in tuple(specs[k])]
        spec += [None] * (len(s.shape) - len(spec))
        out["inputs"] += dryrun.shard_nbytes(
            s.shape, TORCH_OF[jnp.dtype(s.dtype)], spec, sizes)
    return out


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_cell_bytes_skips_and_model_flops_match_jax(arch, mesh_name):
    shape_t, names = MESHES[mesh_name]
    jmesh = AbstractMesh(shape_t, names,
                         axis_types=(AxisType.Auto,) * len(names))
    tmesh = dryrun.StandInMesh(dict(zip(names, shape_t)))
    n = tmesh.n_devices
    for name in SHAPES:
        cfg, shape = get_arch(arch), get_shape(name)
        jcfg, jshape = jax_arch(arch), jax_shape(name)
        ok, reason = cell_applicable(cfg, shape)
        assert (ok, reason) == jax_cell_applicable(jcfg, jshape)
        if not ok:
            continue
        settings = dryrun.default_settings(cfg)
        rules = Rules.make(tmesh, cfg, shape, hbm_bytes=GiB16)
        got = dryrun.cell_bytes(cfg, shape, rules, settings)
        want = _jax_cell_bytes(jcfg, jshape, jmesh, settings.optimizer)
        assert got.pop("step") == (4 if shape.kind == "train" else 0)
        assert got == want, (arch, name)
        assert cfg.model_flops(shape) / n == jcfg.model_flops(jshape) / n


def test_skip_record_is_jaxs(tmp_path):
    rec = dryrun.run_cell("qwen1.5-0.5b", "long_500k", out_dir=str(tmp_path))
    ok, reason = jax_cell_applicable(jax_arch("qwen1.5-0.5b"),
                                     jax_shape("long_500k"))
    assert rec == {"arch": "qwen1.5-0.5b", "shape": "long_500k",
                   "skipped": True, "reason": reason} and not ok
    assert json.loads((tmp_path / "qwen1.5-0.5b_long_500k_pod.json")
                      .read_text()) == rec


# ---------------------------------------------------------------------------
# Meta traces against real runs, and against JAX
# ---------------------------------------------------------------------------

FAMILIES = {"dense": "qwen1.5-0.5b", "moe": "qwen3-moe-30b-a3b",
            "ssm": "mamba2-130m", "hybrid": "recurrentgemma-9b",
            "audio": "whisper-tiny", "vlm": "llama-3.2-vision-11b"}
B, S = 2, 32
SETTINGS = step_lib.TrainSettings(q_chunk=16)


def _real_batch(cfg, kind: str) -> dict:
    g = torch.Generator().manual_seed(3)
    batch = {}
    for k, t in input_specs(cfg, ShapeConfig("t", S, B, kind)).items():
        if t.dtype == torch.int32:
            hi = S - 1 if k == "positions" else cfg.vocab
            batch[k] = torch.randint(0, hi, t.shape, generator=g,
                                     dtype=torch.int32)
        else:
            batch[k] = torch.randn(t.shape, generator=g).to(t.dtype)
    return batch


def _steps(cfg, kind: str, device: str):
    """(step fn, arguments) of the reduced cell on `device` ("meta": the
    dry run's, `dryrun.cell_step`; "cpu": initialised tensors). "chunk"
    is one 8-token prefill chunk over a zeroed cache of S tokens."""
    if device == "meta" and kind != "chunk":
        return dryrun.cell_step(cfg, ShapeConfig("t", S, B, kind), SETTINGS)
    ab = M.abstract_cache(cfg, B, S)
    if device == "meta":
        params, cache = dryrun._on_meta(abstract_params(cfg)), \
            dryrun._on_meta(ab)
    else:
        params, cache = init_params(cfg, seed=0, device="cpu"), _zeros(ab)
    if kind == "chunk":
        chunk = {"tokens": torch.zeros((B, 8), dtype=torch.int32),
                 "positions": torch.zeros((B,), dtype=torch.int32)}
        return step_lib.make_chunk_step(cfg), (
            params, cache, {k: v.to(device) for k, v in chunk.items()})
    batch = _real_batch(cfg, kind)
    if kind == "train":
        state = step_lib.TrainState(params, adamw.adamw_init(params),
                                    torch.zeros((), dtype=torch.int32))
        return step_lib.make_train_step(cfg, SETTINGS), (state, batch)
    if kind == "prefill":
        return step_lib.make_prefill_step(cfg, SETTINGS), (params, batch)
    return step_lib.make_decode_step(cfg), (params, cache, batch)


def _zeros(abstract):
    from repro_torch.tree import tree_map
    return tree_map(lambda l: torch.zeros(l.shape, dtype=l.dtype), abstract)


CELLS = [(f, k) for f in FAMILIES for k in ("train", "prefill", "decode")] \
    + [("dense", "chunk"), ("moe", "chunk")]


@pytest.mark.parametrize("family,kind", CELLS)
def test_meta_trace_flops_equal_a_real_run(family, kind):
    """The meta trace (kernel routes' meta counterparts) against
    FlopCounterMode on the same reduced step run on CPU tensors (the
    plain versions): FLOPs equal exactly, and each kernel the trace
    counts is a call the real run made of the same entry."""
    cfg = get_arch(FAMILIES[family]).reduced()
    fn, args = _steps(cfg, kind, "meta")
    _, r = dryrun.trace(fn, args)
    fn, args = _steps(cfg, kind, "cpu")
    calls = {}

    def counted(name, plain):
        def f(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return plain(*a, **kw)
        return f
    with pytest.MonkeyPatch.context() as mp:
        for name in ("packed_kv_attention", "quantize_pack_kv"):
            mp.setattr(ops, f"{name}_plain",
                       counted(name, getattr(ops, f"{name}_plain")))
        with FlopCounterMode(display=False) as fc:
            out = fn(*args)
    assert r["flops"] == fc.get_total_flops() > 0
    assert {k: v["launches"] for k, v in r["kernels"].items()} == calls
    if kind == "decode" and family != "ssm":
        assert calls["packed_kv_attention"] >= 1
    logits = out[1] if kind == "train" else out[0]
    assert torch.isfinite(logits.float()).all()


# traced FLOPs / JAX's analyze_hlo, reduced configs at B=2, S=32: within
# 1% (JAX's loss reads the target logit as a dot with a one-hot, 2 * B *
# S * V FLOPs more in a train step), pinned to 1e-3 where the programs
# differ
JAX_RATIO = {(f, k): None for f in FAMILIES for k in ("train", "prefill")}
# the JAX MoE dispatches and combines the tokens with one-hot einsums
# (dots, `repro/models/moe.py:105, :134`); the port gathers
JAX_RATIO[("moe", "train")] = 0.8393
JAX_RATIO[("moe", "prefill")] = 0.8049


@pytest.mark.parametrize("family,kind", list(JAX_RATIO))
def test_traced_flops_against_jax(family, kind):
    arch = FAMILIES[family]
    jcfg = jax_arch(arch).reduced()
    jshape = JaxShape("t", S, B, kind)
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    rules = JaxRules.make(mesh, jcfg, jshape)
    js = jax_step.TrainSettings(q_chunk=SETTINGS.q_chunk)
    ap = jax_model.abstract_params(jcfg)
    with mesh_context(mesh):
        if kind == "train":
            st = jax_step.TrainState(
                to_shape_dtype(ap),
                to_shape_dtype(jax_step.opt_abstract(ap, "adamw")),
                jax.ShapeDtypeStruct((), jnp.int32))
            low = jax.jit(jax_step.make_train_step(jcfg, js, rules)).lower(
                st, jax_input_specs(jcfg, jshape))
        else:
            low = jax.jit(jax_step.make_prefill_step(jcfg, js, rules)).lower(
                to_shape_dtype(ap), jax_input_specs(jcfg, jshape))
    want = analyze_hlo(low.compile().as_text())["flops"]
    fn, args = _steps(get_arch(arch).reduced(), kind, "meta")
    ratio = dryrun.trace(fn, args)[1]["flops"] / want
    pinned = JAX_RATIO[(family, kind)]
    if pinned is None:
        assert abs(ratio - 1) < 0.01, ratio
    else:
        assert abs(ratio - pinned) < 1e-3, ratio


# ---------------------------------------------------------------------------
# A production cell, launches, the no-bf16-cache check, the report
# ---------------------------------------------------------------------------

def test_one_production_cell_traced(tmp_path):
    """granite-3-2b x train_4k on the (16, 16) stand-in, whole: the
    counterpart of tests/test_dryrun.py's compiled cell."""
    t0 = time.time()
    rec = dryrun.run_cell("granite-3-2b", "train_4k", out_dir=str(tmp_path))
    assert time.time() - t0 <= 20
    assert not rec["skipped"] and rec["n_devices"] == 256
    assert rec["memory"]["arguments"]["params"] == 29958144
    assert rec["flops_per_device"] > rec["model_flops_per_device"] > 0
    assert rec["collectives"] is None and rec["kernels"] == {}
    assert rec["memory"]["fits_80gb"]
    saved = json.loads((tmp_path / "granite-3-2b_train_4k_pod.json")
                       .read_text())
    assert saved["flops_per_device"] == rec["flops_per_device"]


def _int4(cfg, kv_impl="kernel"):
    return dataclasses.replace(cfg, amc=dataclasses.replace(
        cfg.amc, kv_mode="int4", kv_impl=kv_impl))


def test_contiguous_int4_launches_per_layer():
    """The reduced qwen int4 contiguous decode: one kernel-6 launch a
    layer; its chunked prefill: two kernel-3 launches a layer (K, V).
    The prediction is the analyzer's; the card's counters stay at 0."""
    cfg = _int4(get_arch("qwen1.5-0.5b").reduced())
    ops.reset_launch_counts()
    _, r = dryrun.trace(*_steps(cfg, "decode", "meta"))
    assert r["kernels"] == {"packed_kv_attention": {
        "launches": cfg.n_layers, "flops": r["kernels"][
            "packed_kv_attention"]["flops"],
        "bytes": r["kernels"]["packed_kv_attention"]["bytes"]}}
    _, r = dryrun.trace(*_steps(cfg, "chunk", "meta"))
    assert {k: v["launches"] for k, v in r["kernels"].items()} == \
        {"quantize_pack_kv": 2 * cfg.n_layers}
    assert not any(ops.launch_counts().values())


@pytest.mark.parametrize("kv_mode", ["int4", "int8"])
def test_kernel_route_decode_makes_no_dense_cache(kv_mode):
    """`tests/test_augmented_model.py:138, :154` on the meta trace: the
    kernel route's decode step makes no bf16 (B, S, KV, hd) tensor in
    either dim order (at int8 no float32 one either); the dequant route,
    the positive control, does."""
    cfg = get_arch("qwen1.5-0.5b").reduced()
    cfg = dataclasses.replace(cfg, amc=dataclasses.replace(
        cfg.amc, kv_mode=kv_mode))
    dims = (B, S, cfg.n_kv_heads, cfg.hd)
    watch = [(dims, torch.bfloat16), (dims, torch.float32)]
    _, r = dryrun.trace(*_steps(cfg, "decode", "meta"), watch=watch)
    assert r["shapes"][0] == {} and r["shapes"][1] == {}
    deq = dataclasses.replace(cfg, amc=dataclasses.replace(
        cfg.amc, kv_impl="dequant"))
    _, r = dryrun.trace(*_steps(deq, "decode", "meta"), watch=watch)
    assert sum(r["shapes"][0].values()) + sum(r["shapes"][1].values()) > 0


def test_report_renders(tmp_path):
    for a, s in [("whisper-tiny", "decode_32k"), ("qwen1.5-0.5b",
                                                   "long_500k")]:
        dryrun.run_cell(a, s, out_dir=str(tmp_path))
    dryrun.run_cell("whisper-tiny", "decode_32k", multi_pod=True,
                    out_dir=str(tmp_path))
    text = report.summarize(str(tmp_path))
    assert text.startswith("Records: 3 (2 traced, 1 recorded skips)")
    assert "| whisper-tiny | decode_32k | ok |" in text
    assert "packed_kv_attention 4" in text
    assert "| qwen1.5-0.5b | long_500k | SKIP" in text
    assert "### Roofline terms" in text and "### Per-device bytes" in text


def test_node_layout_records_through_run_cell(tmp_path, monkeypatch):
    """The single-pod CLI writes each cell at (16, 16) and, through
    `run_cell(mesh=dryrun.NODE_MESH)`, at (32, 8); the second record's
    argument bytes are the port's rules at (32, 8), its traced totals the
    first's (one trace a cell), and the report pairs the two."""
    monkeypatch.setattr("sys.argv", [
        "dryrun", "--arch", "whisper-tiny", "--shape", "decode_32k",
        "--out", str(tmp_path)])
    dryrun.main()
    pod, node = (json.loads((tmp_path / f"whisper-tiny_decode_32k_{t}.json")
                            .read_text()) for t in ("pod", "32x8"))
    cfg, shape = get_arch("whisper-tiny"), get_shape("decode_32k")
    mesh = dryrun.StandInMesh(dryrun.NODE_MESH)
    assert node["mesh"] == {"data": 32, "model": 8}
    assert node["n_devices"] == pod["n_devices"] == 256
    assert node["memory"]["arguments"] == dryrun.cell_bytes(
        cfg, shape, Rules.make(mesh, cfg, shape), dryrun.default_settings(cfg))
    assert node["memory"]["argument_bytes"] != \
        pod["memory"]["argument_bytes"]
    for k in ("flops_per_device", "bytes_per_device", "kernels"):
        assert node[k] == pod[k]
    assert node["memory"]["temp_bytes"] == pod["memory"]["temp_bytes"]
    recs = report.load_records(str(tmp_path))
    assert [r["_layout"] for r in recs] == ["32x8", "pod"]
    table = report.layout_table(recs)
    assert (f"| whisper-tiny | decode_32k | "
            f"{pod['memory']['total_gib_per_device']:.3f} | "
            f"{node['memory']['total_gib_per_device']:.3f} |") in table
    # the (32, 8) record stays out of the single-pod and roofline tables
    assert report.dryrun_table(recs, multipod=False).count(
        "| whisper-tiny |") == 1
    assert report.roofline_table(recs).count("| whisper-tiny |") == 1
