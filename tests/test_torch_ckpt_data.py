"""The port's data pipeline, checkpoints, ternary training layers and
Trainer behaviour.

- `SyntheticLM` batches equal `repro.data.SyntheticLM`'s byte for byte;
  the prefetch iterator rewinds to a saved position.
- A `repro.checkpoint.save` of a JAX `TrainState` (AdamW and AMC-Adam,
  moments non-zero) restores into the port's state with every leaf bit
  for bit equal, and a port checkpoint restores into the JAX state the
  same way; the asynchronous checkpointer keeps the last `keep` steps,
  hides partial ones and snapshots a state that is then updated in
  place.
- `ternarize_ste`: forward equal to `ternarize` -> dequant, gradient the
  identity; base-3 bytes equal `repro.core.ternary.pack_ternary_base3`'s;
  `ternary_dense` / `freeze_ternary_dense` -> `frozen_ternary_dense_ref`
  within rel_err 1e-6 of the JAX layers on the same float32 weights,
  their trits and packed bytes equal.
- The Trainer mirrors of tests/test_integration.py (reduced qwen, batch
  4 x seq 64, lr 5e-3, checkpoints every 4 steps), the port alone: the
  loss falls over 25 steps, a restart from step 8 continues with the
  losses of the uninterrupted run bit for bit, a failure injected at
  step 6 is recovered with no step lost and the clean run's losses.
All of these compare float32 or integer data, so the JAX side runs in
this process.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.configs import get_arch as jax_get_arch
from repro.core import ternary as jtern
from repro.core import ternary_layers as jtl
from repro.data import SyntheticLM as JaxSyntheticLM
from repro.models import model as jm
from repro.models.params import init_params as jax_init_params
from repro.optim import adamw as jadamw
from repro.train import step as jstep
from repro_torch import checkpoint as ckpt_lib
from repro_torch import tree
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import ternary, ternary_layers as tl
from repro_torch.data import PrefetchIterator, SyntheticLM
from repro_torch.distributed.fault import SimulatedFailure
from repro_torch.models.params import from_numpy_tree
from repro_torch.optim import adamw
from repro_torch.train import TrainSettings, TrainState
from repro_torch.train.trainer import Trainer, TrainerConfig

CPU = torch.device("cpu")


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3, 17])
def test_synthetic_batches_equal_jax(seed):
    for vocab, S, B in ((97, 16, 4), (512, 64, 4)):
        ours = SyntheticLM(vocab, S, B, seed=seed)
        theirs = JaxSyntheticLM(vocab, S, B, seed=seed)
        for step in (0, 1, 7, 123):
            a, b = ours.batch_at(step), theirs.batch_at(step)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype == np.int32
                assert a[k].tobytes() == b[k].tobytes(), (k, step)


def test_data_pipeline_deterministic_and_checkpointable():
    src = SyntheticLM(vocab=97, seq_len=16, global_batch=4, seed=3)
    it = PrefetchIterator(src)
    a = [next(it) for _ in range(3)]
    state = it.state_dict()
    b = [next(it) for _ in range(2)]
    it.load_state_dict(state)                   # rewind
    c = [next(it) for _ in range(2)]
    it.close()
    assert all(isinstance(x["tokens"], torch.Tensor) for x in a + b + c)
    for x, y in zip(b, c):
        assert torch.equal(x["tokens"], y["tokens"])
    assert torch.equal(a[0]["tokens"],
                       torch.from_numpy(src.batch_at(0)["tokens"]))
    # pure function of step
    assert (src.batch_at(5)["tokens"] == src.batch_at(5)["tokens"]).all()


def test_prefetch_put_runs_on_the_calling_thread():
    import threading
    seen = []
    it = PrefetchIterator(SyntheticLM(97, 8, 2, seed=1),
                          put_fn=lambda b: seen.append(
                              threading.current_thread()) or b)
    next(it)
    next(it)
    it.close()
    assert seen == [threading.main_thread()] * 2


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _jax_state(kind: str):
    """A JAX TrainState of reduced qwen after one optimizer update (so the
    moments are not zero), at step 3."""
    cfg = jax_get_arch("qwen1.5-0.5b").reduced()
    params = jax_init_params(jm.abstract_params(cfg), jax.random.PRNGKey(4))
    init, update = jadamw.make_optimizer(kind)
    opt = init(params)
    grads = jax.tree.map(
        lambda p: jax.random.normal(jax.random.PRNGKey(p.size % 97),
                                    p.shape, jnp.float32).astype(p.dtype),
        params)
    params, opt = update(grads, opt, params, lr=1e-2)
    return jstep.TrainState(params, opt, jnp.asarray(3, jnp.int32))


def _torch_like(jstate, kind: str):
    """The port's state of the same structure (zeros where JAX has values)."""
    params = from_numpy_tree(jax.tree.map(np.zeros_like, jstate.params), CPU)
    init, _ = adamw.make_optimizer(kind)
    return TrainState(params, init(params), torch.zeros((), dtype=torch.int32))


def _bits(x) -> bytes:
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy().tobytes()
    a = np.asarray(x)
    return (a.view(np.uint16) if a.dtype.name == "bfloat16" else a).tobytes()


@pytest.mark.parametrize("kind", ["adamw", "amc_adamw"])
def test_checkpoint_jax_to_port_bit_exact(tmp_path, kind):
    js = _jax_state(kind)
    jckpt.save(str(tmp_path), 3, js, extra={"data": {"step": 3, "seed": 0}})
    like = _torch_like(js, kind)
    got, extra = ckpt_lib.restore(str(tmp_path), 3, like)
    assert isinstance(got, TrainState) and extra["data"]["step"] == 3
    want = jax.tree.leaves(js)
    leaves, _ = tree.flatten(got)
    assert len(leaves) == len(want)
    for a, b, l in zip(leaves, want, tree.flatten(like)[0]):
        assert a.dtype == l.dtype and tuple(a.shape) == tuple(b.shape)
        assert _bits(a) == _bits(b)


@pytest.mark.parametrize("kind", ["adamw", "amc_adamw"])
def test_checkpoint_port_to_jax_bit_exact(tmp_path, kind):
    js = _jax_state(kind)
    # the port's state: the JAX values, as tensors
    ts, _ = ckpt_lib.restore(*_roundtrip_dir(tmp_path / "a", js),
                             _torch_like(js, kind))
    ckpt_lib.save(str(tmp_path / "b"), 5, ts, extra={"losses": [1.5]})
    zeros = jax.tree.map(jnp.zeros_like, js)
    got, extra = jckpt.restore(str(tmp_path / "b"), 5, zeros)
    assert extra == {"losses": [1.5]}
    assert jax.tree.structure(got) == jax.tree.structure(js)
    for a, b in zip(jax.tree.leaves(got), tree.flatten(ts)[0]):
        assert np.asarray(a).dtype.name == {
            torch.bfloat16: "bfloat16", torch.float32: "float32",
            torch.int8: "int8", torch.int32: "int32"}[b.dtype]
        assert _bits(a) == _bits(b)
    assert ckpt_lib.latest_step(str(tmp_path / "b")) == 5


def _roundtrip_dir(path, js):
    jckpt.save(str(path), 1, js)
    return str(path), 1


def test_async_checkpointer_atomicity(tmp_path):
    d = str(tmp_path / "ck")
    tree = {"w": torch.arange(10.0), "b": torch.ones((3, 3))}
    ck = ckpt_lib.AsyncCheckpointer(d, keep=2)
    for s in (1, 2, 3):
        ck.save(s, {k: t * s for k, t in tree.items()})
    ck.wait()
    assert ckpt_lib.all_steps(d) == [2, 3]     # GC keeps last 2
    restored, _ = ckpt_lib.restore(d, 3, tree)
    assert torch.allclose(restored["w"], torch.arange(10.0) * 3)
    # partial checkpoint (no manifest) is invisible
    os.makedirs(os.path.join(d, "step_00000009.tmp"))
    assert ckpt_lib.latest_step(d) == 3


def test_async_snapshot_survives_in_place_update(tmp_path):
    """The save copies the state before it returns: an in-place update
    right after (the next train step) does not reach the file."""
    d = str(tmp_path / "ck")
    w = torch.arange(1 << 16, dtype=torch.float32)
    ck = ckpt_lib.AsyncCheckpointer(d)
    ck.save(1, {"w": w})
    w.add_(1.0)
    ck.wait()
    restored, _ = ckpt_lib.restore(d, 1, {"w": w})
    assert torch.equal(restored["w"], torch.arange(1 << 16,
                                                   dtype=torch.float32))


# ---------------------------------------------------------------------------
# ternary training: STE and base-3
# ---------------------------------------------------------------------------

def test_ternarize_ste_forward_and_identity_gradient():
    w = torch.randn((32, 16), generator=torch.Generator().manual_seed(1))
    t, scale = ternary.ternarize(w)
    fwd = ternary.ternarize_ste(w)
    assert torch.equal(fwd, ternary.ternary_dequant(t, scale, dtype=w.dtype))
    wg = w.clone().requires_grad_(True)
    ternary.ternarize_ste(wg).sum().backward()
    assert torch.equal(wg.grad, torch.ones_like(w))
    # against the JAX STE on the same weights
    jw = jnp.asarray(w.numpy())
    np.testing.assert_allclose(fwd.numpy(),
                               np.asarray(jtern.ternarize_ste(jw)),
                               rtol=1e-6, atol=0)
    g = jax.grad(lambda x: (jtern.ternarize_ste(x) * 3.0).sum())(jw)
    wg.grad = None
    (ternary.ternarize_ste(wg) * 3.0).sum().backward()
    np.testing.assert_array_equal(wg.grad.numpy(), np.asarray(g))


@pytest.mark.parametrize("seed,kmul,cols", [(0, 1, 1), (1, 4, 7), (2, 12, 8),
                                            (3, 7, 3)])
def test_base3_pack_matches_jax(seed, kmul, cols):
    K = 5 * kmul
    t = np.random.default_rng(seed).integers(-1, 2, (K, cols)).astype(np.int8)
    packed = ternary.pack_ternary_base3(torch.from_numpy(t))
    want = np.asarray(jtern.pack_ternary_base3(jnp.asarray(t)))
    assert packed.dtype == torch.uint8
    assert packed.numpy().tobytes() == want.tobytes()
    assert torch.equal(ternary.unpack_ternary_base3(packed, K),
                       torch.from_numpy(t))
    with pytest.raises(ValueError):
        ternary.pack_ternary_base3(torch.zeros((K + 1, cols),
                                               dtype=torch.int8))
    for fmt in ("base3", "2bit", "bf16", "int8", "int4"):
        assert ternary.bits_per_value(fmt) == jtern.bits_per_value(fmt)


@pytest.mark.parametrize("fmt", ["base3", "2bit"])
def test_ternary_dense_matches_jax(fmt):
    rng = np.random.default_rng(5)
    w = (rng.standard_normal((40, 24)) / np.sqrt(40)).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    x = rng.standard_normal((6, 40)).astype(np.float32)
    jp = jtl.TernaryDenseParams(jnp.asarray(w), jnp.asarray(b))
    tp = tl.TernaryDenseParams(torch.from_numpy(w), torch.from_numpy(b))
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    for train in (True, False):
        got = tl.ternary_dense(tp, xt, train=train).numpy()
        want = np.asarray(jtl.ternary_dense(jp, xj, train=train))
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    fr_t = tl.freeze_ternary_dense(tp, fmt=fmt)
    fr_j = jtl.freeze_ternary_dense(jp, fmt=fmt)
    assert fr_t.packed.numpy().tobytes() == \
        np.asarray(fr_j.packed).tobytes()
    assert fr_t.in_dim == fr_j.in_dim == 40
    got = tl.frozen_ternary_dense_ref(fr_t, xt, fmt=fmt).numpy()
    want = np.asarray(jtl.frozen_ternary_dense_ref(fr_j, xj, fmt=fmt))
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    # serving the frozen layer gives the training forward's values
    np.testing.assert_allclose(
        got, tl.ternary_dense(tp, xt, train=False).numpy(), rtol=1e-6,
        atol=1e-6)
    # the STE's gradient reaches the master weights
    wg = torch.from_numpy(w).requires_grad_(True)
    tl.ternary_dense(tl.TernaryDenseParams(wg, None), xt).sum().backward()
    np.testing.assert_allclose(wg.grad.numpy(),
                               np.broadcast_to(x.sum(0)[:, None], w.shape),
                               rtol=1e-5)


def test_init_ternary_dense_shapes():
    p = tl.init_ternary_dense(40, 24, seed=3, device=CPU)
    assert p.w.shape == (40, 24) and p.w.dtype == torch.float32
    assert p.w.device == CPU and p.b.device == CPU
    assert torch.equal(p.b, torch.zeros(24))
    assert tl.init_ternary_dense(40, 24, bias=False, seed=3,
                                 device=CPU).b is None
    assert torch.equal(p.w, tl.init_ternary_dense(40, 24, seed=3,
                                                  device=CPU).w)
    if not torch.cuda.is_available():
        # the card by default: no silent fallback to the CPU
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tl.init_ternary_dense(40, 24, seed=3)


# ---------------------------------------------------------------------------
# the Trainer, the port alone (tests/test_integration.py's cells)
# ---------------------------------------------------------------------------

def _mk_trainer(tmp, steps=12, injector=None, seed=0):
    cfg = get_arch("qwen1.5-0.5b").reduced()
    shape = ShapeConfig("t", 64, 4, "train")
    settings = TrainSettings(lr=5e-3, q_chunk=16)
    tcfg = TrainerConfig(total_steps=steps, ckpt_every=4,
                         ckpt_dir=str(tmp), warmup=2, seed=seed)
    return Trainer(cfg, shape, settings, tcfg, failure_injector=injector,
                   device=CPU)


def test_training_loss_decreases(tmp_path):
    tr = _mk_trainer(tmp_path / "a", steps=25)
    losses = tr.train()
    tr.close()
    assert len(losses) == 25
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.05, losses


def test_checkpoint_restart_bit_exact(tmp_path):
    tr_a = _mk_trainer(tmp_path / "a", steps=12)
    losses_a = tr_a.train()
    tr_a.close()
    tr_b = _mk_trainer(tmp_path / "b", steps=12)
    tr_b.train(n_steps=8)
    tr_b.close()
    tr_b2 = _mk_trainer(tmp_path / "b", steps=12)
    assert tr_b2.current_step() == 8, "auto-resume from latest ckpt"
    losses_b = tr_b2.train()
    tr_b2.close()
    assert losses_b[:8] == losses_a[:8]       # restored from the manifest
    assert losses_b[8:] == losses_a[8:], "restart must be bit-exact"
    for a, b in zip(tree.flatten(tr_a.state)[0],
                    tree.flatten(tr_b2.state)[0]):
        assert torch.equal(a, b)


def test_failure_injection_recovers(tmp_path):
    fired = {"done": False}

    def injector(step):
        if step == 6 and not fired["done"]:
            fired["done"] = True
            raise SimulatedFailure("chip lost")

    tr = _mk_trainer(tmp_path / "f", steps=10, injector=injector)
    losses = tr.train()
    tr.close()
    assert fired["done"]
    assert tr.supervisor.restarts == 1
    assert len(losses) == 10          # no lost or repeated steps
    tr_clean = _mk_trainer(tmp_path / "g", steps=10)
    losses_clean = tr_clean.train()
    tr_clean.close()
    assert losses == losses_clean
