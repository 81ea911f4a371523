"""JAX side of tests/test_torch_distributed.py, run as a child process on
4 forced host devices:

    XLA_FLAGS="--xla_force_host_platform_device_count=4
               --xla_allow_excess_precision=false" \
    JAX_PLATFORMS=cpu python tests/torch_dist_oracle.py OUT.npz CKPT_DIR

Writes to OUT.npz, for each arch case of `torch_dist_worker.CASES` (the
reduced configs), the initial parameters (`init_params` at key 0), the
batch, the loss and the gradients of `loss_fn` under the rules of a
(2, 2) ("data", "model") mesh, and the losses of 3 steps of the JAX
`Trainer` on that mesh; the compressed all-reduce at pod=2
(`shard_map`, one gradient a pod); and `pipeline_forward` at 1, 2 and 4
stages. Every mesh has Auto axes (an Explicit mesh fails on the
installed jax).
"""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_dist_worker import (BATCH, CASES, COLL, PIPE,  # noqa: E402
                               TRAINER, batch_of)

from repro.configs import get_arch  # noqa: E402
from repro.configs.base import ShapeConfig  # noqa: E402
from repro.distributed import collectives as jcoll  # noqa: E402
from repro.distributed.pipeline import pipeline_forward  # noqa: E402
from repro.distributed.sharding import Rules  # noqa: E402
from repro.launch.mesh import mesh_context  # noqa: E402
from repro.models import model as M  # noqa: E402
from repro.models.params import init_params  # noqa: E402
from repro.train import step as step_lib  # noqa: E402
from repro.train.trainer import Trainer, TrainerConfig  # noqa: E402

try:
    from jax import shard_map
except ImportError:
    from jax.experimental.shard_map import shard_map


def auto_mesh(shape, names, devices=None):
    return jax.make_mesh(shape, names, devices=devices,
                         axis_types=(AxisType.Auto,) * len(shape))


def put(out, prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "name", k)))
                       for k in path)
        a = np.asarray(leaf)
        out[f"{prefix}/{key}"] = (a.view(np.uint16)
                                  if a.dtype.name == "bfloat16" else a)


def case_cfg(name):
    arch, kw = CASES[name]
    c = get_arch(arch).reduced()
    c = dataclasses.replace(c, amc=dataclasses.replace(
        c.amc, weight_mode="normal"))
    return dataclasses.replace(c, **kw)


def main(out_path, ckpt_dir):
    out = {}
    mesh = auto_mesh((2, 2), ("data", "model"))
    B, S = BATCH["B"], BATCH["S"]
    shape = ShapeConfig("t", S, B, "train")
    for name in CASES:
        cfg = case_cfg(name)
        rules = Rules.make(mesh, cfg, shape)
        ap = M.abstract_params(cfg)
        params = init_params(ap, jax.random.PRNGKey(0))
        put(out, f"{name}/params", params)
        batch = batch_of(cfg)
        for k, v in batch.items():
            out[f"{name}/batch/{k}"] = v
        p_sh = step_lib.param_shardings(ap, rules)
        b_sh = {k: NamedSharding(mesh, v) for k, v in
                step_lib.batch_pspecs(cfg, shape, rules).items()}
        with mesh_context(mesh):
            sp = jax.tree.map(jax.device_put, params, p_sh)
            jb = {k: jax.device_put(jnp.asarray(v), b_sh[k])
                  for k, v in batch.items()}
            loss, grads = jax.jit(jax.value_and_grad(
                lambda p, b: M.loss_fn(cfg, p, b, rules=rules,
                                       remat_policy="nothing",
                                       q_chunk=BATCH["q_chunk"])))(sp, jb)
        out[f"{name}/loss"] = np.asarray(loss)
        put(out, f"{name}/grads", grads)
        settings = step_lib.TrainSettings(lr=TRAINER["lr"],
                                          q_chunk=BATCH["q_chunk"])
        tcfg = TrainerConfig(total_steps=TRAINER["steps"],
                             ckpt_every=100, warmup=TRAINER["warmup"],
                             ckpt_dir=os.path.join(ckpt_dir, name), seed=0)
        tr = Trainer(cfg, shape, mesh, settings, tcfg)
        # the Trainer leaves its optimizer state where opt_init made it
        # (replicated), which its own jit refuses on a multi-device mesh
        # with the installed jax: place the state at its shardings first
        tr.state = jax.tree.map(jax.device_put, tr.state, tr.state_shardings)
        out[f"{name}/trainer/losses"] = np.asarray(tr.train(), np.float64)
        tr.close()

    # the compressed all-reduce at pod=2: one gradient (and residual) a pod
    pod = auto_mesh((2,), ("pod",), devices=jax.devices()[:2])
    rng = np.random.default_rng(COLL["seed"])
    g = (rng.standard_normal((2,) + COLL["shape"]) * 1e-3).astype(np.float32)
    res = (rng.standard_normal((2,) + COLL["shape"]) * 1e-5).astype(
        np.float32)
    spec = P("pod", None, None)

    def f(gl, rl):
        o, r = jcoll.compressed_allreduce_mean(gl[0], "pod", rl[0])
        return o[None], r[None]

    with mesh_context(pod):
        o, r = jax.jit(shard_map(f, mesh=pod, in_specs=(spec, spec),
                                 out_specs=(spec, spec)))(g, res)
    out["coll/g"], out["coll/res"] = g, res
    out["coll/out"], out["coll/new_res"] = np.asarray(o), np.asarray(r)

    # the pipeline at 1, 2 and 4 stages
    rng = np.random.default_rng(PIPE["seed"])
    xs = rng.standard_normal((PIPE["n_micro"], PIPE["mb"], PIPE["d"])
                             ).astype(np.float32)
    out["pipe/xs"] = xs
    for n in (1, 2, 4):
        w = (rng.standard_normal((n, PIPE["d"], PIPE["d"]))
             / np.sqrt(PIPE["d"])).astype(np.float32)
        m = auto_mesh((n,), ("pod",), devices=jax.devices()[:n])
        fn = pipeline_forward(m, lambda p, x: jnp.tanh(x @ p),
                              n_micro=PIPE["n_micro"])
        with mesh_context(m):
            y = fn(jnp.asarray(w), jnp.asarray(xs))
        out[f"pipe/{n}/w"], out[f"pipe/{n}/out"] = w, np.asarray(y)
    np.savez(out_path, **out)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
