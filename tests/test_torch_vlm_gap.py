"""vlm's stepwise-prefill gap between the kernel route and the reference
route, in the JAX package itself.

On the card, phase 12a of chip_smoke.py reads the port's worst prefill
step (position 1) 7.1% off the plain route at full width, against 1.1%
for the first decode step; its per-layer probe shows the first self
layer's attention output already differing in its bits (kernel 2 rounds
P x v_scale to bf16 before the PV product, as the Pallas kernel does;
the reference keeps float32), and from the second layer on int4 levels
of the K / V the step writes differing between the routes.

Here the JAX package's own kernel route (kv_impl="kernel": the Pallas
decode kernel in interpret mode) is held against its reference route
(kv_impl="dequant", matmul_impl="dense") on the reduced config, the same
way: 16 stepwise prefill steps and the first decode step over a filled
patch slab, the cross gates non-zero, int4 KV, each step through both
routes from the same state, the state advancing along the kernel route.
The JAX package shows the same gap: none at position 0 (one token:
softmax weighs it 1 exactly), the worst step at position 1, decaying
with the length, and int4 levels of the written token parting from
position 1 on. The port's kernel route (its plain versions on the CPU)
is run the same way beside it. The JAX run happens in a child process
(`pltpu.TPUCompilerParams` aliased, XLA's excess precision off, as
tests/test_torch_vlm.py runs it).
"""
import dataclasses
import inspect
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import model as jm
from repro.models.params import init_params as jax_init_params
from repro_torch.configs import get_arch
from repro_torch.models.params import from_numpy_tree
from repro_torch.serve import state_store as tstore

CPU = torch.device("cpu")
REPO = Path(__file__).resolve().parents[1]
ARCH = "llama-3.2-vision-11b"
B, PROMPT = 4, 16


def _inputs(params_slab_shapes: dict, seed: int = 12) -> dict:
    rng = np.random.default_rng(seed)
    return {"slab": {k: rng.standard_normal(s).astype(jnp.bfloat16)
                     for k, s in sorted(params_slab_shapes.items())},
            "tokens": rng.integers(0, 512, (B, PROMPT + 1)).astype(
                np.int32)}


def _levels_differ(a: np.ndarray, b: np.ndarray) -> int:
    a, b = a.view(np.uint8), b.view(np.uint8)
    return int(((a & 15) != (b & 15)).sum() + ((a >> 4) != (b >> 4)).sum())


def _jax_gap(args: dict) -> dict:
    """Per step: the logits' rel_err between JAX's kernel and reference
    routes, and the int4 K / V levels that differ between the states the
    two routes leave. Runs by source in the child."""
    import dataclasses
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro.configs import get_arch
    from repro.serve import state_store

    params = jax.tree.map(jnp.asarray, args["params"])
    kcfg = get_arch("llama-3.2-vision-11b").reduced()
    rcfg = dataclasses.replace(kcfg, amc=dataclasses.replace(
        kcfg.amc, kv_impl="dequant", matmul_impl="dense"))
    store = state_store.make_store(kcfg, max_batch=B, max_seq=32)
    for r in range(B):
        assert store.admit_row(r, PROMPT + 1, 0)
    store.parts["prefix"].state = {"normal": {
        k: jnp.asarray(v) for k, v in args["inputs"]["slab"].items()}}
    kstep = jax.jit(state_store.make_step_fns(kcfg, store)["decode"])
    rstep = jax.jit(state_store.make_step_fns(rcfg, store)["decode"])
    toks, V = args["inputs"]["tokens"], kcfg.vocab
    state, errs, levels = store.state, [], []
    for i in range(PROMPT + 1):
        batch = {"tokens": jnp.asarray(toks[:, i:i + 1]),
                 "positions": jnp.full((B,), i, jnp.int32),
                 "write_mask": jnp.ones((B,), bool),
                 **store.device_tables()}
        lk, sk = kstep(params, state, batch)
        lr, sr = rstep(params, state, batch)
        lk = np.asarray(lk, np.float32)[..., :V]
        lr = np.asarray(lr, np.float32)[..., :V]
        errs.append(float(np.abs(lk - lr).max() / np.abs(lr).max()))
        levels.append(sum(_levels_differ(np.asarray(sk["kv"][p]),
                                         np.asarray(sr["kv"][p]))
                          for p in ("kp", "vp")))
        state = sk
    return {"rel_err": errs, "levels": levels}


CHILD = """
import pickle, sys
import numpy as np
from jax.experimental.pallas import tpu as pltpu
pltpu.TPUCompilerParams = pltpu.CompilerParams
B, PROMPT = %d, %d
%s
%s
with open(sys.argv[1], "rb") as f:
    args = pickle.load(f)
out = _jax_gap(args)
with open(args["out"], "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def jax_params():
    """JAX's seed-0 dense weights of the reduced config (numpy), the
    cross gates seeded non-zero (tests/test_torch_vlm.py's)."""
    cfg = jax_get_arch(ARCH).reduced()
    cfg = dataclasses.replace(cfg, amc=dataclasses.replace(
        cfg.amc, weight_mode="normal"))
    params = jax.tree.map(np.asarray, jax.jit(
        lambda k: jax_init_params(jm.abstract_params(cfg), k))(
        jax.random.PRNGKey(0)))
    rng = np.random.default_rng(7)
    cross = params["blocks"]["cross"]
    for k in ("gate_attn", "gate_ffn"):
        cross[k] = rng.uniform(0.4, 1.2, cross[k].shape).astype(jnp.bfloat16)
    return params


@pytest.fixture(scope="module")
def inputs():
    cfg = get_arch(ARCH).reduced()
    store = tstore.make_store(cfg, max_batch=B, max_seq=32, device=CPU)
    return _inputs({k: tuple(v.shape) for k, v in
                    store.parts["prefix"].state["normal"].items()})


@pytest.fixture(scope="module")
def oracle_child(jax_params, inputs, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("vlm_gap")
    args = {"params": jax_params, "inputs": inputs,
            "out": str(tmp / "out.pkl")}
    with open(tmp / "args.pkl", "wb") as f:
        pickle.dump(args, f)
    flags = os.environ.get("XLA_FLAGS", "")
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": f"{flags} --xla_allow_excess_precision=false",
           "PYTHONPATH": os.pathsep.join(
               [str(REPO / "src"), os.environ.get("PYTHONPATH", "")])}
    src = CHILD % (B, PROMPT, inspect.getsource(_levels_differ),
                   inspect.getsource(_jax_gap))
    child = subprocess.Popen(
        [sys.executable, "-c", src, str(tmp / "args.pkl")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    yield child, args
    if child.poll() is None:
        child.kill()
        child.wait()


@pytest.fixture(scope="module")
def port_gap(oracle_child, jax_params, inputs):
    """The same steps through the port's kernel route (plain versions on
    the CPU) and reference route (while the child runs)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    params = from_numpy_tree(jax_params, CPU)
    kcfg = get_arch(ARCH).reduced()
    rcfg = dataclasses.replace(kcfg, amc=dataclasses.replace(
        kcfg.amc, kv_impl="dequant", matmul_impl="dense"))
    store = tstore.make_store(kcfg, max_batch=B, max_seq=32, device=CPU)
    for r in range(B):
        assert store.admit_row(r, PROMPT + 1, 0)
    store.parts["prefix"].state = {"normal": {
        k: torch.from_numpy(v.view(np.int16).copy()).view(torch.bfloat16)
        for k, v in inputs["slab"].items()}}
    kstep = tstore.make_step_fns(kcfg)["decode"]
    rstep = tstore.make_step_fns(rcfg)["decode"]
    toks, V = torch.from_numpy(inputs["tokens"]), kcfg.vocab
    errs, levels = [], []

    def clone(t):
        return ({k: clone(v) for k, v in t.items()} if isinstance(t, dict)
                else t.clone())

    with torch.no_grad():
        for i in range(PROMPT + 1):
            batch = {"tokens": toks[:, i:i + 1],
                     "positions": torch.full((B,), i, dtype=torch.int32),
                     "write_mask": torch.ones(B, dtype=torch.bool),
                     **store.device_tables()}
            snap = clone(store.state)
            lk, store.state = kstep(params, store.state, batch)
            lr, sr = rstep(params, snap, batch)
            lk, lr = lk[..., :V].float(), lr[..., :V].float()
            errs.append(float((lk - lr).abs().max() / lr.abs().max()))
            levels.append(sum(_levels_differ(
                store.state["kv"][p].numpy(), sr["kv"][p].numpy())
                for p in ("kp", "vp")))
    torch.set_num_threads(threads)
    return {"rel_err": errs, "levels": levels}


@pytest.fixture(scope="module")
def jax_gap(oracle_child, port_gap):
    child, args = oracle_child
    log, _ = child.communicate(timeout=600)
    assert child.returncode == 0, log[-4000:]
    with open(args["out"], "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("package", ["jax", "port"])
def test_stepwise_prefill_gap_peaks_at_position_1(jax_gap, port_gap,
                                                  package):
    """Both packages' kernel routes part from their reference routes the
    way the card shows: exactly equal at position 0, the worst prefill
    step at position 1 and at least twice the first decode step's gap,
    int4 levels of the written K / V differing from position 1 on."""
    gap = {"jax": jax_gap, "port": port_gap}[package]
    errs, levels = gap["rel_err"], gap["levels"]
    print(package, "rel_err", [f"{e:.4f}" for e in errs], "levels", levels)
    assert errs[0] == 0.0 and levels[0] == 0
    assert int(np.argmax(errs[:PROMPT])) == 1
    assert errs[1] >= 2 * errs[PROMPT]
    assert all(n > 0 for n in levels[1:])


def test_jax_kernel_route_gap_is_past_the_logit_tolerance_scale(jax_gap):
    """The JAX package's own kernel route is several percent off its
    reference route at position 1 (the port's tolerance is 5%; the card's
    port reads 7.1% at full width, 40 layers against these 5), and within
    the tolerance at the first decode step, as the card's 1.1%."""
    errs = jax_gap["rel_err"]
    assert errs[1] > 0.02
    assert errs[PROMPT] < 0.05
