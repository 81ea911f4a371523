"""The port's distributed layer on 4 CPU ranks (gloo) against the port's
unsharded path and the JAX package on 4 forced host devices.

Every multi-rank run is spawned by tests/torch_dist_worker.py in a
subprocess (no process group is ever initialised in the pytest process;
the ranks meet through a file store under tmp_path, and a rank not
joined within 120 s fails the run). Every JAX computation runs in ONE
child (tests/torch_dist_oracle.py, `XLA_FLAGS=--xla_force_host_platform_
device_count=4 --xla_allow_excess_precision=false`, Auto meshes).

Cases: reduced qwen1.5-0.5b (dense), qwen3-moe-30b-a3b (EP: experts over
"model"), granite-3-2b with one KV head (q heads over "model", the KV
replicated), mamba2-130m and recurrentgemma-9b ("lru" over "model"), on a
(2, 2) ("data", "model") mesh with the batch over "data", FSDP over
"data" and the residual stream sequence-parallel over "model".

Tolerances (`rel_err`: max |a - b| / max |b|):
- against the port's unsharded step: the loss within 1e-3 (bf16 and
  float32 master trees); gradient leaves < 2e-2 on a float32 master tree
  and < 0.05 on a bf16 one (a reordered sum flips bf16 roundings of the
  residual stream and of bf16 gradients: measured worst 1.1e-2 and
  1.6e-2, recurrentgemma's tied embedding); AdamW's and AMC-Adam's
  updates of the sharded gradients byte for byte those of the same
  gradients whole;
- against JAX's own sharded-against-unsharded gap on the same mesh,
  parameters and batch (condition (i)): the port's worst leaf at most
  twice JAX's, bf16 and float32 masters, case by case;
- against JAX's sharded `Trainer` and `loss_fn` on the same mesh:
  3 losses within 2e-2, gradient leaves < 0.05 (tests/test_torch_train.py's
  bf16 tolerances);
- checkpoints cross mesh shapes bit for bit; the compressed all-reduce
  is JAX's bit for bit; the pipeline within 1e-6 of JAX's and of the
  direct product.
"""
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tests"))
from torch_dist_worker import CASES, tree_of  # noqa: E402

from repro_torch.tree import flatten  # noqa: E402


def _env(**extra) -> dict:
    return {**os.environ, "JAX_PLATFORMS": "cpu", **extra,
            "PYTHONPATH": os.pathsep.join(
                [str(REPO / "src"), os.environ.get("PYTHONPATH", "")])}


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    """The JAX child, started once: its OUT.npz as soon as it is written.
    The child goes on to JAX's own gradient gaps (`jax_gap`) while the
    ranks run."""
    tmp = tmp_path_factory.mktemp("dist_oracle")
    out, log = tmp / "oracle.npz", tmp / "oracle.log"
    with open(log, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, str(REPO / "tests" / "torch_dist_oracle.py"),
             str(out), str(tmp / "ckpt"), str(tmp / "gap.npz")],
            env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=4 "
                               "--xla_allow_excess_precision=false"),
            stdout=subprocess.DEVNULL, stderr=err)
    try:
        t0 = time.monotonic()
        while not out.exists():
            assert proc.poll() is None, log.read_text()[-4000:]
            assert time.monotonic() - t0 < 600, "oracle timed out"
            time.sleep(0.5)
        yield {"path": str(out), "data": dict(np.load(out)), "proc": proc,
               "gap": tmp / "gap.npz", "log": log}
    finally:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def jax_gap(oracle):
    """{case/bf16 | case/f32: JAX's per-leaf sharded-vs-unsharded
    gradient gaps} from the oracle child's second part."""
    assert oracle["proc"].wait(timeout=600) == 0, \
        oracle["log"].read_text()[-4000:]
    return dict(np.load(oracle["gap"]))


def run_ranks(case: str, tmp_path, oracle_path=None) -> dict:
    """The worker's CASE on 4 spawned ranks; rank 0's result."""
    out = tmp_path / case.replace(":", "_")
    cmd = [sys.executable, str(REPO / "tests" / "torch_dist_worker.py"),
           case, str(out)] + ([oracle_path] if oracle_path else [])
    res = subprocess.run(cmd, env=_env(), capture_output=True, text=True,
                         timeout=240)
    errors = "".join(p.read_text() for p in out.glob("error*.txt"))
    assert res.returncode == 0, (errors or res.stderr)[-4000:]
    return torch.load(out / "result.pt", weights_only=False)


def rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-6))


def as_f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    if a.dtype == np.uint16:        # bf16 words
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).float().numpy()
    return a.astype(np.float32)


def jax_leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from jax_leaves(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


@pytest.fixture(scope="module")
def train_results(oracle, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_train")
    return {name: run_ranks(f"train:{name}", tmp, oracle["path"])
            for name in CASES}


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_matches_unsharded(train_results, name):
    r = train_results[name]
    assert abs(r["loss_sharded"] - r["loss_unsharded"]) < 1e-3, r
    s32, u32 = r["f32_loss"]
    assert abs(s32 - u32) < 1e-3
    assert max(r["f32_grad_err"]) < 2e-2, r["f32_grad_err"]
    assert max(r["grad_err"]) < 0.05, r["grad_err"]


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_optimizer_updates_byte_equal(train_results, name):
    """AdamW's float32 moments and AMC-Adam's int8 moments and per-row
    scales (the amax over a sharded last dim reduces across shards: a
    max, exact), and the updated parameters, of the sharded gradients ==
    those of the same gradients whole."""
    for kind, equal in train_results[name]["updates_equal"].items():
        assert all(equal), (kind, [i for i, e in enumerate(equal)
                                   if not e])


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_matches_jax(train_results, oracle, name):
    r, want = train_results[name], oracle["data"]
    assert abs(r["loss_sharded"] - float(want[f"{name}/loss"])) < 2e-2
    got = flatten(r["grads"])[0]
    ref = [a for _, a in jax_leaves(tree_of(want, f"{name}/grads"))]
    assert len(got) == len(ref)
    for (path, b), a in zip(jax_leaves(tree_of(want, f"{name}/grads")),
                            got):
        assert rel_err(as_f32(a), as_f32(b)) < 0.05, path
    losses = np.asarray(r["trainer_losses"])
    jl = want[f"{name}/trainer/losses"]
    assert losses.shape == jl.shape and np.abs(losses - jl).max() < 2e-2, \
        (losses, jl)


@pytest.fixture(scope="module")
def ckpt_result(tmp_path_factory):
    return run_ranks("ckpt", tmp_path_factory.mktemp("dist_ckpt"))


@pytest.mark.parametrize("opt", ["adamw", "amc_adamw"])
def test_checkpoint_crosses_mesh_shapes(ckpt_result, opt):
    """A 2x2 Trainer's checkpoint resumed by an unsharded Trainer, and an
    unsharded one's resumed on the 2x2 mesh (every leaf a DTensor again):
    step, parameters and optimizer state bit for bit."""
    step, equal = ckpt_result[f"{opt}/to_unsharded"]
    assert step == 2 and all(equal)
    step, placed, equal = ckpt_result[f"{opt}/to_sharded"]
    assert step == 2 and placed and all(equal)


@pytest.fixture(scope="module")
def steps_result(tmp_path_factory):
    return run_ranks("steps", tmp_path_factory.mktemp("dist_steps"))


@pytest.mark.parametrize("name", ["qwen", "granite"])
def test_sharded_contiguous_steps_match_unsharded(steps_result, name):
    """The int4 chunked prefill (kernel 3's plain version on the CPU, on
    each rank's K / V rows) and the decode steps (kernel 6's, on each
    rank's cache shard) against the unsharded steps: logits within 1e-2
    (the row-parallel wo / w_down sum their float32 partials across the
    model axis: the bf16 product rounds once either way, but from a sum
    in another order), the cache as good as equal. qwen shards its KV
    heads with its q heads; granite (one KV head) replicates both for
    the read."""
    r = steps_result[name]
    assert max(r["logit_err"]) < 1e-2, r["logit_err"]
    assert min(r["cache_equal_share"].values()) > 0.99, r
    if name == "granite":
        assert r["kv_heads"] is None and r["heads"] == ("model",)
    else:
        assert r["kv_heads"] == ("model",)


def test_compressed_allreduce_bit_equal_to_jax(oracle, tmp_path):
    """At pod=2 (the pod axis of a (2, 2) ("pod", "data") mesh) each
    rank's mean and residual == JAX's shard_map, on every rank; the tree
    form gives the leaf's; no pod-size-2 "model" axis -> None."""
    r = run_ranks("coll", tmp_path, oracle["path"])
    assert r["out_equal"] and r["res_equal"] and r["tree_equal"]
    assert r["all_ranks"] == [1, 1, 1]
    assert r["data_axis_none"]


def test_compressed_allreduce_absent_at_pod_size_one():
    from repro_torch.distributed.collectives import (
        make_compressed_grad_allreduce)

    class FakeMesh:
        shape = {"pod": 1, "data": 4}
    assert make_compressed_grad_allreduce(FakeMesh(), "pod") is None
    assert make_compressed_grad_allreduce(FakeMesh(), "model") is None


def test_compressed_quantization_bounded_and_unbiased():
    from repro_torch.distributed.collectives import _q8
    g = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (64, 256)).astype(np.float32) * 1e-3)
    q, scale = _q8(g)
    deq = q.float() * scale
    err = (deq - g).abs()
    assert (err <= scale * 0.5 + 1e-9).all()
    res = g - deq
    assert torch.allclose(res + deq, g, atol=1e-7)


@pytest.fixture(scope="module")
def pipe_result(oracle, tmp_path_factory):
    return run_ranks("pipe", tmp_path_factory.mktemp("dist_pipe"),
                     oracle["path"])


@pytest.mark.parametrize("n_stages", [1, 2, 4])
def test_pipeline_matches_jax(pipe_result, n_stages):
    """GPipe over 1, 2 and 4 stages (a (1, 4), (2, 2) and (4,) mesh's pod
    axis), 3 microbatches: every rank's output against JAX's and the
    stages applied in order."""
    r = pipe_result[n_stages]
    assert r["vs_jax"] < 1e-6 and r["vs_direct"] < 1e-6, r


def test_mesh_needs_a_process_group():
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import make_local_mesh, make_mesh
    from repro_torch.train.step import TrainSettings
    from repro_torch.train.trainer import Trainer, TrainerConfig
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh((2, 2), ("data", "model"), "cpu")
    with pytest.raises(RuntimeError, match="process group"):
        make_local_mesh("cpu")

    class FakeMesh:
        shape = {"data": 2, "model": 2}
        device_type = "cpu"
    with pytest.raises(RuntimeError, match="process group"):
        Trainer(get_arch("qwen1.5-0.5b").reduced(),
                ShapeConfig("t", 32, 4, "train"), TrainSettings(),
                TrainerConfig(), device="cpu", mesh=FakeMesh())


def _cli(args, env, timeout=300):
    return subprocess.run(args, env=env, capture_output=True, text=True,
                          timeout=timeout, cwd=REPO)


def test_cli_mesh_pod_exits_naming_the_world():
    base = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            "qwen1.5-0.5b", "--reduced", "--device", "cpu", "--steps", "2"]
    for mesh, need in (("pod", 256), ("multipod", 512)):
        res = _cli(base + ["--mesh", mesh], _env())
        assert res.returncode == 2, (res.stdout, res.stderr)
        assert f"{need} ranks" in res.stderr and "not ported" not in \
            res.stderr


def test_cli_mesh_local(tmp_path):
    """--mesh local at world 1 is the unsharded Trainer (the printed line
    is the in-process Trainer's); under torchrun's 2 ranks it trains on
    the (2, 1) mesh, whose losses are the same run's within 1e-3."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.train.step import TrainSettings
    from repro_torch.train.trainer import Trainer, TrainerConfig
    flags = ["--arch", "qwen1.5-0.5b", "--reduced", "--device", "cpu",
             "--steps", "4", "--batch", "4", "--seq", "32"]
    res = _cli([sys.executable, "-m", "repro_torch.launch.train", *flags,
                "--ckpt-dir", str(tmp_path / "a")], _env())
    assert res.returncode == 0, res.stderr[-3000:]
    tr = Trainer(get_arch("qwen1.5-0.5b").reduced(),
                 ShapeConfig("train", 32, 4, "train"),
                 TrainSettings(lr=1e-3, q_chunk=32),
                 TrainerConfig(total_steps=4, ckpt_dir=str(tmp_path / "b"),
                               warmup=2, ckpt_every=5), device="cpu")
    losses = tr.train()
    tr.close()
    want = (f"[train] qwen1.5-0.5b-reduced: step 4 "
            f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    assert want in res.stdout, (res.stdout, want)
    res = _cli([sys.executable, "-m", "torch.distributed.run",
                "--standalone", "--nproc-per-node", "2",
                "-m", "repro_torch.launch.train", *flags, "--mesh", "local",
                "--ckpt-dir", str(tmp_path / "c")],
               _env(OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stderr[-3000:]
    line = [l for l in res.stdout.splitlines() if l.startswith("[train]")]
    assert len(line) == 1, res.stdout
    first, last = (float(x) for x in line[0].split("loss ")[1].split(" -> "))
    assert abs(first - losses[0]) < 1e-3 and abs(last - losses[-1]) < 1e-3


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_gradient_gap_is_jaxs_own(train_results, jax_gap, name):
    """Condition (i) (ROADMAP queue 3): the port's worst gradient leaf,
    2x2 sharded against unsharded, beside JAX's own on the same mesh,
    parameters and batch (the oracle child's gap part), on bf16 and on
    float32 master trees. JAX's gap is of the same size (its bf16 worst
    above the port's in every case), so the port is held to at most
    twice JAX's, case by case, besides the bounds of
    `test_sharded_step_matches_unsharded`."""
    r = train_results[name]
    port = {"bf16": max(r["grad_err"]), "f32": max(r["f32_grad_err"])}
    jax_ = {k: float(jax_gap[f"{name}/{k}"].max()) for k in port}
    print(f"[gap] {name}: port {port} jax {jax_}")
    for k in port:
        assert port[k] <= 2 * jax_[k], (name, k, port[k], jax_[k])
