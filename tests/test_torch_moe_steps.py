"""The moe family's paged steps held against the JAX package: one
chunked-prefill dispatch (2 rows of 8: one routing group of 16), one
decode step and one verify window of W=3 (both routed per token) of the
reduced qwen3-moe-30b-a3b and of a 64-expert variant (which turns on
qwen3's q/k norm), dual and ternary weights, at the config's kv int4.

The JAX package runs its reference routes (kv_impl="dequant",
matmul_impl="dense") and records each step's inputs and logits; the port
takes its kernel routes (their plain versions here) on the same inputs,
logits rel_err < 0.05 (tests/test_torch_model.py's tolerance). JAX's
int4 pool packs through its Pallas kernel even on the reference path, so
its side runs in CHILD processes (one a variant, side by side) that alias
`pltpu.TPUCompilerParams` to `pltpu.CompilerParams` before they import
`repro`, as tests/test_torch_serve.py does.
"""
import dataclasses
import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.kernels import ref
from repro.models import model as jm
from repro.models.params import init_params as jax_init_params
from repro_torch.configs import get_arch
from repro_torch.models import augment as taug
from repro_torch.models import model as tm
from repro_torch.models.params import from_numpy_tree
from repro_torch.serve import cache_pool as tpool_mod

CPU = torch.device("cpu")
REPO = Path(__file__).resolve().parents[1]
ARCH = "qwen3-moe-30b-a3b"
VARIANTS = {"reduced": {}, "e64": {"n_experts": 64, "top_k": 8}}
MODES = ("dual", "ternary")
STEPS = {"B": 2, "C": 8, "W": 3, "max_seq": 48}


def _jax_steps(params: dict, variants: dict, modes, steps: dict) -> dict:
    """Prefill, decode and verify of every (variant, mode) on the JAX
    package's reference routes: name -> the step's inputs and float32
    logits. Runs by source in the child processes."""
    import dataclasses
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import AxisType
    from repro.configs import get_arch
    from repro.launch.mesh import mesh_context
    from repro.models import augment, model as M
    from repro.serve.cache_pool import PagedKVPool

    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    out = {}
    B, C, W = steps["B"], steps["C"], steps["W"]
    for variant, moe in variants.items():
        for mode in modes:
            c = get_arch("qwen3-moe-30b-a3b").reduced()
            cfg = dataclasses.replace(
                c, moe=dataclasses.replace(c.moe, **moe),
                amc=dataclasses.replace(c.amc, kv_impl="dequant",
                                        matmul_impl="dense",
                                        weight_mode=mode, kv_mode="int4"))
            with mesh_context(mesh):
                packed = augment.augment_params(cfg, params[variant])
            pool = PagedKVPool(cfg, max_batch=B, max_seq=steps["max_seq"])
            pool.admit_row(0, C + 1 + W, step=0)
            pool.admit_row(1, C + W, step=0)
            rng = np.random.default_rng(len(variant) + len(mode))
            V = cfg.vocab
            tag = f"{variant}/{mode}"

            def run(fn, name, extra):
                b = {**pool.device_tables(),
                     **{k: jnp.asarray(v) for k, v in extra.items()}}
                with mesh_context(mesh):
                    lg, pool.arenas = jax.jit(
                        lambda p, s, b_: fn(cfg, p, s, b_))(
                        packed, pool.arenas, b)
                for k, v in extra.items():
                    out[f"{tag}/{name}/in/{k}"] = v
                out[f"{tag}/{name}"] = np.asarray(lg, np.float32)[..., :V]
                return out[f"{tag}/{name}"]

            lg = run(M.paged_prefill_step, "prefill", {
                "tokens": rng.integers(0, V, size=(B, C)).astype(np.int32),
                "positions": np.zeros(B, np.int32),
                "write_mask": np.ones(B, bool)})
            lg = run(M.paged_decode_step, "decode", {
                "tokens": lg[:, -1].argmax(-1).astype(np.int32)[:, None],
                "positions": np.full(B, C, np.int32),
                "write_mask": np.ones(B, bool)})
            win = rng.integers(0, V, size=(B, W)).astype(np.int32)
            win[:, 0] = lg[:, -1].argmax(-1)
            run(M.paged_verify_step, "verify", {
                "tokens": win, "positions": np.full(B, C + 1, np.int32),
                "write_mask": np.ones((B, W), bool)})
    return out


CHILD = """
import json, sys
import numpy as np
from jax.experimental.pallas import tpu as pltpu
pltpu.TPUCompilerParams = pltpu.CompilerParams
import jax, jax.numpy as jnp
args = json.loads(sys.argv[1])
params = {}
for variant, path in args["params"].items():
    flat = np.load(path)
    tree = params.setdefault(variant, {})
    for key in flat.files:
        a = flat[key]
        if a.dtype == np.uint16:
            a = a.view(jnp.bfloat16)
        node = tree
        *parts, leaf = key.split("/")
        for k in parts:
            node = node.setdefault(k, {})
        node[leaf] = jnp.asarray(a)
%s
np.savez(args["out"], **_jax_steps(params, args["variants"], args["modes"],
                                   args["steps"]))
"""


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.fixture(scope="module")
def dense_params():
    """Dense weights of each variant from the JAX initialiser."""
    out = {}
    for variant, moe in VARIANTS.items():
        c = jax_get_arch(ARCH).reduced()
        c = dataclasses.replace(c, moe=dataclasses.replace(c.moe, **moe),
                                amc=dataclasses.replace(
                                    c.amc, weight_mode="normal"))
        out[variant] = jax.tree.map(np.asarray, jax.jit(
            lambda k, c=c: jax_init_params(jm.abstract_params(c), k))(
            jax.random.PRNGKey(5)))
    return out


@pytest.fixture(scope="module")
def oracles(dense_params, tmp_path_factory):
    """The JAX steps at int4, one child process a variant, side by side."""
    tmp = tmp_path_factory.mktemp("moe_steps")
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join(
               [str(REPO / "src"), os.environ.get("PYTHONPATH", "")])}
    children = []
    for variant, tree in dense_params.items():
        path = str(tmp / f"{variant}.npz")
        np.savez(path, **{
            k: (v.view(np.uint16) if v.dtype.name == "bfloat16" else v)
            for k, v in _flatten(tree)})
        args = {"params": {variant: path},
                "variants": {variant: VARIANTS[variant]},
                "modes": list(MODES), "steps": STEPS,
                "out": str(tmp / f"{variant}.int4.npz")}
        children.append((subprocess.Popen(
            [sys.executable, "-c", CHILD % inspect.getsource(_jax_steps),
             json.dumps(args)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), args["out"]))
    out = {}
    try:
        for child, path in children:
            log, _ = child.communicate(timeout=600)
            assert child.returncode == 0, log[-4000:]
            out.update(np.load(path))
    finally:
        for child, _ in children:
            if child.poll() is None:
                child.kill()
                child.wait()
    return out


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("mode", MODES)
def test_paged_steps_match_jax(oracles, dense_params, variant, mode):
    want = oracles
    c = get_arch(ARCH).reduced()
    cfg = dataclasses.replace(
        c, moe=dataclasses.replace(c.moe, **VARIANTS[variant]),
        amc=dataclasses.replace(c.amc, weight_mode=mode, kv_mode="int4"))
    params = taug.augment_params(cfg, from_numpy_tree(dense_params[variant],
                                                      CPU))
    B, C, W = STEPS["B"], STEPS["C"], STEPS["W"]
    pool = tpool_mod.PagedKVPool(cfg, max_batch=B, max_seq=STEPS["max_seq"],
                                 device=CPU)
    assert pool.admit_row(0, C + 1 + W, step=0)
    assert pool.admit_row(1, C + W, step=0)
    tag = f"{variant}/{mode}"
    for name, fn in (("prefill", tm.paged_prefill_step),
                     ("decode", tm.paged_decode_step),
                     ("verify", tm.paged_verify_step)):
        batch = {k.rsplit("/", 1)[1]: torch.from_numpy(np.asarray(v))
                 for k, v in want.items()
                 if k.startswith(f"{tag}/{name}/in/")}
        assert set(batch) >= {"tokens", "positions", "write_mask"}
        lg, _ = fn(cfg, params, pool.arenas,
                   {**pool.device_tables(), **batch})
        assert ref.rel_err(lg.numpy()[..., :cfg.vocab],
                           want[f"{tag}/{name}"]) < 0.05, name
