"""The port's training side held against the JAX package: the full-sequence
forward, loss and gradients of the dense and moe families (reduced
qwen1.5-0.5b and qwen3-moe-30b-a3b), one `make_train_step` step, and 12
steps of the `Trainer`; in the port alone, gradient accumulation, the
four remat policies and the train CLI.

Every JAX run happens in ONE child process with
`XLA_FLAGS=--xla_allow_excess_precision=false` (without it XLA's CPU
compiler skips bf16 roundings the port performs) and an Auto-axis mesh
for the JAX `Trainer` (`make_local_mesh()`'s Explicit axes fail on the
installed jax). The child draws the weights with the JAX initialiser and
writes them with its results; the port takes them through
`from_numpy_tree`.

Tolerances (`ref.rel_err`: max |a - b| / max |b|):
- bf16 params: logits < 0.05, loss |d| < 2e-2, every gradient leaf < 0.05.
- float32 params: loss |d| < 1e-3; the full chain's logits and gradients
  < 1e-2. The JAX forward casts the embedding to bf16 whatever the
  parameters' dtype, so a float32 tree still runs a bf16 residual
  stream: a float32 sum that the two libraries order differently lands
  on the other side of a bf16 rounding now and then (2 of 8192 residual
  entries after the first attention block, 315 after two layers), and
  the chain carries each flip on. Each block alone, fed the JAX
  residual it saw, is held to 1e-3 (`test_blocks_match_jax_f32`).
- One train step (bf16, AdamW): loss |d| < 2e-2. Adam's first step moves
  every entry by about +-lr whatever its gradient's size, so an entry
  whose gradient is noise (all of `bk`: a key bias shifts every score of
  a query alike, so its true gradient is 0) may move the other way:
  every entry within 2.5 lr of JAX's, and >= 99% of all entries bit for
  bit equal (99.9% measured; `bk` 80%).
- Trainer: 12 losses within 2e-2 absolute, step by step.
"""
import dataclasses
import inspect
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.kernels.ref import rel_err
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.models import model as tm
from repro_torch.models import transformer as tt
from repro_torch.models.params import from_numpy_tree
from repro_torch.optim import adamw
from repro_torch.train import step as step_lib
from repro_torch.train.trainer import Trainer, TrainerConfig

CPU = torch.device("cpu")
REPO = Path(__file__).resolve().parents[1]
ARCHS = ("qwen1.5-0.5b", "qwen3-moe-30b-a3b")
DTYPES = ("f32", "bf16")
FWD = {"B": 2, "S": 32, "q_chunk": 16}
STEP = {"B": 4, "S": 32, "lr": 1e-3}
TRAINER = {"steps": 12, "seq": 64, "batch": 4, "lr": 5e-3, "q_chunk": 16,
           "ckpt_every": 4, "warmup": 2}


def _jax_train_oracle(out_path: str, tmp: str, fwd: dict, step: dict,
                      trainer: dict) -> None:
    """Runs by source in the child: every JAX result the tests compare."""
    import dataclasses
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import AxisType
    from repro.configs import get_arch
    from repro.configs.base import ShapeConfig
    from repro.models import model as M
    from repro.models import transformer as T
    from repro.models.params import init_params
    from repro.optim import adamw
    from repro.train import step as step_lib
    from repro.train.trainer import Trainer, TrainerConfig

    out = {}

    def put(prefix, tree):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            key = "/".join(str(getattr(k, "key", getattr(k, "name", k)))
                           for k in path)
            a = np.asarray(leaf)
            out[f"{prefix}/{key}"] = (a.view(np.uint16)
                                      if a.dtype.name == "bfloat16" else a)

    def dense(arch):
        c = get_arch(arch).reduced()
        return dataclasses.replace(c, amc=dataclasses.replace(
            c.amc, weight_mode="normal"))

    B, S = fwd["B"], fwd["S"]
    for arch in ("qwen1.5-0.5b", "qwen3-moe-30b-a3b"):
        cfg = dense(arch)
        rng = np.random.default_rng(1)
        batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
                 "targets": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
        for dt_name, dt in (("f32", jnp.float32), ("bf16", None)):
            tag = f"{arch}/{dt_name}"
            params = init_params(M.abstract_params(cfg), jax.random.PRNGKey(0),
                                 dtype_override=dt)
            jb = {k: jnp.asarray(v) for k, v in batch.items()}
            logits = jax.jit(lambda p, b: M.forward(
                cfg, p, b, q_chunk=fwd["q_chunk"]))(params, jb)
            loss, grads = jax.jit(jax.value_and_grad(lambda p, b: M.loss_fn(
                cfg, p, b, remat_policy="nothing",
                q_chunk=fwd["q_chunk"])))(params, jb)
            put(f"{tag}/params", params)
            put(f"{tag}/grads", grads)
            out[f"{tag}/logits"] = np.asarray(logits)[..., :cfg.vocab]
            out[f"{tag}/loss"] = np.asarray(loss)
            for k, v in batch.items():
                out[f"{tag}/batch/{k}"] = v
            if dt_name != "f32":
                continue
            # each block on the JAX residual it sees (teacher forcing)
            x = jnp.take(params["embed"], jb["tokens"], axis=0).astype(
                jnp.bfloat16)
            pos = jnp.arange(S)
            attn = jax.jit(lambda x, lp: T.attn_block(
                cfg, lp["attn"], x, pos, q_chunk=fwd["q_chunk"])[0])
            ffn = jax.jit(lambda x, lp: T.ffn_dispatch(cfg, lp, x))
            for i in range(cfg.n_layers):
                lp = jax.tree.map(lambda a: a[i], params["layers"])
                a = attn(x, lp)
                out[f"{tag}/block{i}/x"] = np.asarray(x).view(np.uint16)
                out[f"{tag}/block{i}/attn"] = np.asarray(a).view(np.uint16)
                x = x + a
                f = ffn(x, lp)
                out[f"{tag}/block{i}/mid"] = np.asarray(x).view(np.uint16)
                out[f"{tag}/block{i}/ffn"] = np.asarray(f).view(np.uint16)
                x = x + f

    # one train step, AdamW, at grad_accum 1 and 2 (bf16 params)
    cfg = dense("qwen1.5-0.5b")
    params = init_params(M.abstract_params(cfg), jax.random.PRNGKey(0))
    rng = np.random.default_rng(2)
    batch = {"tokens": rng.integers(0, cfg.vocab, (step["B"], step["S"]))
             .astype(np.int32),
             "targets": rng.integers(0, cfg.vocab, (step["B"], step["S"]))
             .astype(np.int32)}
    for k, v in batch.items():
        out[f"step/batch/{k}"] = v
    for n in (1, 2):
        settings = step_lib.TrainSettings(lr=step["lr"], q_chunk=16,
                                          grad_accum=n)
        state = step_lib.TrainState(params, adamw.adamw_init(params),
                                    jnp.zeros((), jnp.int32))
        new, loss = jax.jit(step_lib.make_train_step(cfg, settings, None))(
            state, {k: jnp.asarray(v) for k, v in batch.items()})
        put(f"step/accum{n}/params", new.params)
        out[f"step/accum{n}/loss"] = np.asarray(loss)

    # the Trainer, 12 steps, on the Auto mesh
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    cfg = get_arch("qwen1.5-0.5b").reduced()
    put("trainer/init", init_params(M.abstract_params(cfg),
                                    jax.random.PRNGKey(0)))
    shape = ShapeConfig("t", trainer["seq"], trainer["batch"], "train")
    settings = step_lib.TrainSettings(lr=trainer["lr"],
                                      q_chunk=trainer["q_chunk"])
    tcfg = TrainerConfig(total_steps=trainer["steps"],
                         ckpt_every=trainer["ckpt_every"], ckpt_dir=tmp,
                         warmup=trainer["warmup"], seed=0)
    tr = Trainer(cfg, shape, mesh, settings, tcfg)
    out["trainer/losses"] = np.asarray(tr.train(), np.float64)
    tr.close()
    np.savez(out_path, **out)


CHILD = """
import json, sys
%s
args = json.loads(sys.argv[1])
_jax_train_oracle(**args)
"""


def child_env() -> dict:
    return {**os.environ, "JAX_PLATFORMS": "cpu",
            "XLA_FLAGS": "--xla_allow_excess_precision=false",
            "PYTHONPATH": os.pathsep.join(
                [str(REPO / "src"), os.environ.get("PYTHONPATH", "")])}


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_oracle")
    args = {"out_path": str(tmp / "oracle.npz"), "tmp": str(tmp / "ckpt"),
            "fwd": FWD, "step": STEP, "trainer": TRAINER}
    res = subprocess.run(
        [sys.executable, "-c", CHILD % inspect.getsource(_jax_train_oracle),
         json.dumps(args)], env=child_env(), capture_output=True, text=True,
        timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    return dict(np.load(args["out_path"]))


def tree_of(want: dict, prefix: str) -> dict:
    """The numpy tree stored under `prefix/` (bf16 leaves as uint16)."""
    tree: dict = {}
    for key, a in want.items():
        if not key.startswith(prefix + "/"):
            continue
        node = tree
        *parts, leaf = key[len(prefix) + 1:].split("/")
        for k in parts:
            node = node.setdefault(k, {})
        node[leaf] = a
    return tree


def leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from leaves(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


def bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)


def as_f32(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return t.astype(np.float32)


def dense_cfg(arch: str):
    c = get_arch(arch).reduced()
    return dataclasses.replace(c, amc=dataclasses.replace(
        c.amc, weight_mode="normal"))


def batch_of(want: dict, prefix: str) -> dict:
    return {k: torch.from_numpy(want[f"{prefix}/batch/{k}"])
            for k in ("tokens", "targets")}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_grads_match_jax(oracle, arch, dtype):
    tag = f"{arch}/{dtype}"
    cfg = dense_cfg(arch)
    params = from_numpy_tree(tree_of(oracle, f"{tag}/params"), CPU)
    batch = batch_of(oracle, tag)
    tol = {"f32": (1e-2, 1e-3, 1e-2), "bf16": (0.05, 2e-2, 0.05)}[dtype]
    with torch.no_grad():
        logits = tm.forward(cfg, params, batch, q_chunk=FWD["q_chunk"])
    assert logits.dtype == torch.float32
    assert rel_err(logits.numpy()[..., :cfg.vocab],
                   oracle[f"{tag}/logits"]) < tol[0]
    loss, grads = step_lib.value_and_grad(
        lambda p, b: tm.loss_fn(cfg, p, b, remat_policy="nothing",
                                q_chunk=FWD["q_chunk"]), params, batch)
    assert abs(float(loss) - float(oracle[f"{tag}/loss"])) < tol[1]
    want = dict(leaves(tree_of(oracle, f"{tag}/grads")))
    got = dict(leaves(grads))
    assert set(got) == set(want)
    for name, g in got.items():
        w = want[name]
        w = bf16(w).float().numpy() if w.dtype == np.uint16 else w
        assert g.dtype == params_dtype(params, name), name
        assert rel_err(as_f32(g), w) < tol[2], name


def params_dtype(params: dict, name: str) -> torch.dtype:
    node = params
    for k in name.split("/"):
        node = node[k]
    return node.dtype


@pytest.mark.parametrize("arch", ARCHS)
def test_blocks_match_jax_f32(oracle, arch):
    """Each layer's attention block and FFN of a float32 tree, fed the
    residual the JAX block saw: output rel_err < 1e-3."""
    tag = f"{arch}/f32"
    cfg = dense_cfg(arch)
    params = from_numpy_tree(tree_of(oracle, f"{tag}/params"), CPU)
    pos = torch.arange(FWD["S"])
    with torch.no_grad():
        for i in range(cfg.n_layers):
            lp = tt._layer_groups(params["layers"], i)
            x = bf16(oracle[f"{tag}/block{i}/x"])
            a, _ = tt.attn_block(cfg, lp["attn"], x, pos,
                                 q_chunk=FWD["q_chunk"])
            want = bf16(oracle[f"{tag}/block{i}/attn"]).float().numpy()
            assert rel_err(as_f32(a), want) < 1e-3, (i, "attn")
            mid = bf16(oracle[f"{tag}/block{i}/mid"])
            f = tt.ffn_dispatch(cfg, lp, mid, fixed_order=False,
                                norm_fixed=False)
            want = bf16(oracle[f"{tag}/block{i}/ffn"]).float().numpy()
            assert rel_err(as_f32(f), want) < 1e-3, (i, "ffn")


def clone(tree):
    if isinstance(tree, dict):
        return {k: clone(v) for k, v in tree.items()}
    return tree.clone()


def fresh_state(params: dict):
    """A TrainState over a copy of `params` (the update writes in place)."""
    p = clone(params)
    return step_lib.TrainState(p, adamw.adamw_init(p),
                               torch.zeros((), dtype=torch.int32))


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_step_matches_jax(oracle, grad_accum):
    cfg = dense_cfg("qwen1.5-0.5b")
    params = from_numpy_tree(tree_of(oracle, "trainer/init"), CPU)
    # the step's weights are the trainer's initial draw (same key, config)
    settings = step_lib.TrainSettings(lr=STEP["lr"], q_chunk=16,
                                      grad_accum=grad_accum)
    state = fresh_state(params)
    new, loss = step_lib.make_train_step(cfg, settings)(
        state, batch_of(oracle, "step"))
    assert int(new.step) == 1 and int(new.opt.step) == 1
    assert abs(float(loss) - float(oracle[f"step/accum{grad_accum}/loss"])) \
        < 2e-2
    want = dict(leaves(tree_of(oracle, f"step/accum{grad_accum}/params")))
    same = total = 0
    for name, p in leaves(new.params):
        w = bf16(want[name])
        assert (p.float() - w.float()).abs().max() < 2.5 * STEP["lr"], name
        same += int((p.view(torch.int16) == w.view(torch.int16)).sum())
        total += p.numel()
    assert same >= 0.99 * total, (same, total)


def test_grad_accum_equals_one_batch(oracle):
    """grad_accum=2 over the 4-row batch (float32 params): its gradients
    are the two 2-row microbatches' gradients summed in float32 and
    halved, bit for bit, and they equal the one-batch gradients within
    rel_err 1e-2, the loss within 1e-4. A row's bf16 activations may
    round differently in a 2-row and a 4-row product (the CPU GEMM
    blocks by row count), which is the only gap to the one-batch step
    (0.002 measured)."""
    cfg = dense_cfg("qwen1.5-0.5b")
    params = from_numpy_tree(tree_of(oracle, "qwen1.5-0.5b/f32/params"), CPU)
    batch = batch_of(oracle, "step")

    def loss(p, b):
        return tm.loss_fn(cfg, p, b, remat_policy="nothing", q_chunk=16)

    l1, g1 = step_lib.accumulated_grads(loss, params, batch, 1)
    l2, g2 = step_lib.accumulated_grads(loss, params, batch, 2)
    halves = [step_lib.value_and_grad(loss, params,
                                      {k: t[i:i + 2] for k, t in
                                       batch.items()}) for i in (0, 2)]
    assert torch.equal(l2, (halves[0][0] + halves[1][0]) / 2)
    assert abs(float(l1) - float(l2)) < 1e-4
    ga, gb = dict(leaves(halves[0][1])), dict(leaves(halves[1][1]))
    g2 = dict(leaves(g2))
    for name, g in leaves(g1):
        assert g2[name].dtype == torch.float32
        assert torch.equal(g2[name], (ga[name].float() + gb[name].float())
                           / 2), name
        assert rel_err(as_f32(g2[name]), as_f32(g)) < 1e-2, name


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_policies_bit_equal(oracle, arch):
    cfg = dense_cfg(arch)
    params = from_numpy_tree(tree_of(oracle, f"{arch}/bf16/params"), CPU)
    batch = batch_of(oracle, f"{arch}/bf16")
    ref = None
    for policy in ("none", "everything", "nothing", "dots"):
        loss, grads = step_lib.value_and_grad(
            lambda p, b: tm.loss_fn(cfg, p, b, remat_policy=policy,
                                    q_chunk=FWD["q_chunk"]), params, batch)
        got = (loss, dict(leaves(grads)))
        if ref is None:
            ref = got
            continue
        assert torch.equal(got[0], ref[0]), policy
        for name, g in got[1].items():
            assert torch.equal(g, ref[1][name]), (policy, name)


def test_trainer_matches_jax(oracle, tmp_path):
    cfg = get_arch("qwen1.5-0.5b").reduced()
    params = from_numpy_tree(tree_of(oracle, "trainer/init"), CPU)
    shape = ShapeConfig("t", TRAINER["seq"], TRAINER["batch"], "train")
    settings = step_lib.TrainSettings(lr=TRAINER["lr"],
                                      q_chunk=TRAINER["q_chunk"])
    tcfg = TrainerConfig(total_steps=TRAINER["steps"],
                         ckpt_every=TRAINER["ckpt_every"],
                         ckpt_dir=str(tmp_path), warmup=TRAINER["warmup"],
                         seed=0)
    tr = Trainer(cfg, shape, settings, tcfg, device=CPU, params=params)
    losses = tr.train()
    tr.close()
    want = oracle["trainer/losses"]
    assert len(losses) == len(want) == TRAINER["steps"]
    np.testing.assert_allclose(losses, want, rtol=0, atol=2e-2)


def test_train_cli(tmp_path):
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(REPO / "src"), os.environ.get("PYTHONPATH", "")])}
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "qwen1.5-0.5b", "--reduced", "--device", "cpu", "--steps", "6",
           "--batch", "4", "--seq", "32", "--ckpt-dir", str(tmp_path / "c")]
    res = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert re.search(r"^\[train\] qwen1\.5-0\.5b-reduced: step 6 loss "
                     r"\d+\.\d{4} -> \d+\.\d{4}$", res.stdout, re.M), \
        res.stdout
    res = subprocess.run(cmd + ["--mesh", "pod"], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 2, (res.stdout, res.stderr)
    assert "--mesh pod" in res.stderr
