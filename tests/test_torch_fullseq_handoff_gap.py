"""The hybrid family's prefill -> decode hand-off at int4, held against the
JAX package's own: the first decode step after `forward(return_cache=
True)` parts from the step after a token-by-token prefill, because the
forward and the steps compute each token's K / V with different roundings
(products over S rows against 4, a scan against a recurrence) and the
int4 ring turns a bf16 ulp of K / V into a level flip (ROADMAP condition
(g)). The JAX package shows the same gap between its own forward and its
own steps.

Config: recurrentgemma-9b reduced, 13 layers (4 macro-blocks and a tail
layer), a 512-slot window, 4 prompts of 256 tokens, seed 0. The JAX side
runs in ONE child process with `XLA_FLAGS=--xla_allow_excess_precision=
false`, kv_impl="dequant"; the port takes the JAX weights and its kernel
route's plain version.

Bounds: each package's bf16 ring (kv "normal") hand-off within 0.05 of
its stepwise prefill (tests/test_augmented_model.py's logit tolerance);
at int4 the JAX package's own gap is larger than its bf16 one, and the
port's int4 gap is no larger than JAX's plus 0.01.
"""
import dataclasses
import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.kernels.ref import rel_err
from repro_torch.configs import get_arch
from repro_torch.models import model as tm
from repro_torch.models.params import from_numpy_tree
from repro_torch.tree import tree_map

CPU = torch.device("cpu")
REPO = Path(__file__).resolve().parents[1]
SHAPE = {"layers": 13, "window": 512, "B": 4, "P": 256}


def _jax_gap(out_path: str, shape: dict) -> None:
    """Runs by source in the child: the hand-off and stepwise logits of
    the first decode step at kv normal and int4, and the weights."""
    import dataclasses
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro.configs import get_arch
    from repro.configs.base import ShapeConfig
    from repro.models import model as M
    from repro.models.params import init_params

    base = get_arch("recurrentgemma-9b").reduced()
    base = dataclasses.replace(base, n_layers=shape["layers"],
                               hybrid=dataclasses.replace(
                                   base.hybrid, window=shape["window"]))
    p = init_params(M.abstract_params(base), jax.random.PRNGKey(0))
    out = {f"params/{'/'.join(str(k.key) for k in path)}":
           np.asarray(leaf).view(np.uint16)
           for path, leaf in jax.tree_util.tree_flatten_with_path(p)[0]}
    B, P = shape["B"], shape["P"]
    toks = np.random.default_rng(0).integers(0, base.vocab, (B, P + 1))
    toks = toks.astype(np.int32)
    out["tokens"] = toks
    toks = jnp.asarray(toks)
    for kv in ("normal", "int4"):
        cfg = dataclasses.replace(base, amc=dataclasses.replace(
            base.amc, kv_mode=kv, weight_mode="normal", kv_impl="dequant"))
        _, cache = jax.jit(lambda p, t: M.forward(
            cfg, p, {"tokens": t}, return_cache=True, q_chunk=P))(
                p, toks[:, :P])
        dec = jax.jit(lambda p, c, b: M.decode_step(cfg, p, c, b))
        first, _ = dec(p, cache, {"tokens": toks[:, P:P + 1],
                                  "positions": jnp.full((B,), P, jnp.int32)})
        sc = jax.tree.map(lambda l: jnp.zeros(l.shape, l.jdtype),
                          M.abstract_cache(cfg, ShapeConfig("d", P + 1, B,
                                                            "decode")),
                          is_leaf=lambda x: hasattr(x, "jdtype"))
        for t in range(P + 1):
            lg, sc = dec(p, sc, {"tokens": toks[:, t:t + 1],
                                 "positions": jnp.full((B,), t, jnp.int32)})
        out[f"{kv}/handoff"] = np.asarray(first)[..., :cfg.vocab]
        out[f"{kv}/stepwise"] = np.asarray(lg)[..., :cfg.vocab]
    np.savez(out_path, **out)


CHILD = """
import json, sys
%s
_jax_gap(**json.loads(sys.argv[1]))
"""


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The reduced models' tensors are tiny: torch's intra-op threads only
    contend with the JAX child's and the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("handoff_gap") / "gap.npz")
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_allow_excess_precision=false",
           "PYTHONPATH": os.pathsep.join(
               [str(REPO / "src"), os.environ.get("PYTHONPATH", "")])}
    res = subprocess.run(
        [sys.executable, "-c", CHILD % inspect.getsource(_jax_gap),
         json.dumps({"out_path": path, "shape": SHAPE})], env=env,
        capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    return dict(np.load(path))


def _port_gap(oracle: dict, kv: str):
    """The port's hand-off and stepwise logits of the first decode step."""
    base = get_arch("recurrentgemma-9b").reduced()
    cfg = dataclasses.replace(base, n_layers=SHAPE["layers"],
                              hybrid=dataclasses.replace(
                                  base.hybrid, window=SHAPE["window"]),
                              amc=dataclasses.replace(
                                  base.amc, kv_mode=kv, weight_mode="normal"))
    tree: dict = {}
    for key, a in oracle.items():
        if key.startswith("params/"):
            node = tree
            *parts, leaf = key[len("params/"):].split("/")
            for k in parts:
                node = node.setdefault(k, {})
            node[leaf] = a
    params = from_numpy_tree(tree, CPU)
    toks = torch.from_numpy(oracle["tokens"])
    B, P = SHAPE["B"], SHAPE["P"]
    pos = lambda t: torch.full((B,), t, dtype=torch.int32)
    with torch.no_grad():
        _, cache = tm.forward(cfg, params, {"tokens": toks[:, :P]},
                              return_cache=True, q_chunk=P)
        first, _ = tm.decode_step(cfg, params, cache, {
            "tokens": toks[:, P:P + 1], "positions": pos(P)})
        sc = tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype),
                      tm.abstract_cache(cfg, B, P + 1))
        for t in range(P + 1):
            lg, sc = tm.decode_step(cfg, params, sc, {
                "tokens": toks[:, t:t + 1], "positions": pos(t)})
    V = cfg.vocab
    return first.numpy()[..., :V], lg.numpy()[..., :V]


def test_handoff_gap_within_the_jax_packages_own(oracle):
    gap = {}
    for kv in ("normal", "int4"):
        first, step = _port_gap(oracle, kv)
        gap[kv] = (rel_err(first, step),
                   rel_err(oracle[f"{kv}/handoff"], oracle[f"{kv}/stepwise"]))
    assert gap["normal"][0] < 0.05 and gap["normal"][1] < 0.05, gap
    assert gap["int4"][1] > gap["normal"][1], gap
    assert gap["int4"][0] <= gap["int4"][1] + 0.01, gap
