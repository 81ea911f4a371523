"""The whole slice: the port's `ServeEngine` (scheduler + paged pool +
dense model + kernels' plain versions on CPU) against the JAX engine on
the same dense weights and prompts, at the reduced config.

The JAX oracle runs the reference paths (kv_impl="dequant",
matmul_impl="dense") on an Auto-axis mesh built here. At kv_mode="int8"
it runs in this process. At kv_mode="int4" the JAX package's pool packs
through its Pallas kernel even on the reference path, which this jax
can only run with `pltpu.TPUCompilerParams` aliased to
`pltpu.CompilerParams`; that alias is set in a CHILD process before it
imports `repro`, never here, so no other test's jit caches see it.

Tokens are compared exactly, on prompts whose JAX top-1/top-2 logit
margin exceeds MIN_MARGIN at every decode step (checked).
"""
import dataclasses
import inspect
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import model as jm
from repro.models.params import init_params as jax_init_params
from repro_torch.configs import get_arch
from repro_torch.models.params import from_numpy_tree
from repro_torch.serve import Request, ServeEngine

CPU = torch.device("cpu")
REPO = Path(__file__).resolve().parents[1]
MIN_MARGIN = 1e-2
POOL_MODES = ("always-augmented", "normal-only", "augment-on-pressure")
COUNTERS = ("augment_events", "promote_events", "refreshes", "preemptions",
            "maintenance_dispatches")
# 5 requests on 2 rows (queueing and row reuse); under augment-on-pressure
# a budget of three Normal pages (2 layers x 4 KV heads x 16 tokens x 32
# x bf16 x K+V = 16 KiB each) forces cold pages into the Augmented plane;
# a 2-step retention window makes the refresh pass run. The prompt seed
# keeps every decode step's JAX top-1/top-2 margin >= 0.039 in all six
# (kv_mode, pool_mode) cells (logits are bf16 before the f32 cast, so
# seeds with near-ties are common).
SPEC = {
    "engine": {"max_batch": 2, "max_seq": 64, "prefill_chunk": 8,
               "retention_steps": 2},
    "budget": {"augment-on-pressure": 3 * 16384},
    "prompt_lens": [20, 14, 9, 25, 5],
    "prompt_seed": 4,
    "max_new": 6,
}


def prompts():
    rng = np.random.default_rng(SPEC["prompt_seed"])
    return [rng.integers(0, 512, size=n).astype(np.int32)
            for n in SPEC["prompt_lens"]]


def _jax_oracle(kv_mode, pool_mode, params, spec, prompts, counters):
    """Serve `prompts` with the JAX engine on its reference paths; return
    tokens, the smallest top-1/top-2 margin of any decode step, the
    dispatch count, the pool counters and the byte accounting. Runs both
    here and, by source, in the int4 child process."""
    import dataclasses
    import jax
    import numpy as np
    from jax.sharding import AxisType
    from repro.configs import get_arch
    from repro.serve import Request, ServeEngine

    class RecordingEngine(ServeEngine):
        min_margin = float("inf")

        def _dispatch(self, fn, batch):
            logits = super()._dispatch(fn, batch)
            if fn is self._decode:
                rows = np.asarray(batch["write_mask"])
                lg = np.asarray(logits[:, -1, :self.cfg.vocab],
                                np.float32)[rows]
                if lg.size:
                    top = np.sort(lg, axis=-1)[:, -2:]
                    self.min_margin = min(self.min_margin,
                                          float((top[:, 1] - top[:, 0]).min()))
            return logits

    cfg = get_arch("qwen1.5-0.5b").reduced()
    cfg = dataclasses.replace(cfg, amc=dataclasses.replace(
        cfg.amc, kv_impl="dequant", matmul_impl="dense"))
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    eng = RecordingEngine(cfg, mesh, params=params, kv_mode=kv_mode,
                          pool_mode=pool_mode,
                          pool_budget_bytes=spec["budget"].get(pool_mode),
                          **spec["engine"])
    out = eng.generate([Request(prompt=np.asarray(p, np.int32),
                                max_new_tokens=spec["max_new"], id=i)
                        for i, p in enumerate(prompts)])
    st = eng.stats()
    return {"tokens": {str(k): [int(t) for t in v] for k, v in out.items()},
            "min_margin": eng.min_margin,
            "dispatches": eng.dispatch_count,
            "counters": {k: int(st[k]) for k in counters},
            "bytes": {k: int(st[k]) for k in (
                "weight_bytes_logical", "weight_bytes_physical",
                "cache_bytes_logical", "cache_bytes_physical")}}


CHILD = """
import json, sys
import numpy as np
from jax.experimental.pallas import tpu as pltpu
pltpu.TPUCompilerParams = pltpu.CompilerParams
import jax, jax.numpy as jnp
args = json.loads(sys.argv[1])
flat = np.load(args["params"])
params = {}
for key in flat.files:
    a = flat[key]
    if a.dtype == np.uint16:
        a = a.view(jnp.bfloat16)
    node = params
    *path, leaf = key.split("/")
    for k in path:
        node = node.setdefault(k, {})
    node[leaf] = jnp.asarray(a)
%s
out = {pm: _jax_oracle("int4", pm, params, args["spec"], args["prompts"],
                       args["counters"]) for pm in args["pool_modes"]}
with open(args["out"], "w") as f:
    json.dump(out, f)
"""


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.fixture(scope="module")
def dense_params():
    """Dense JAX weights (the engines pack them to ternary themselves)."""
    cfg = jax_get_arch("qwen1.5-0.5b").reduced()
    dense_cfg = dataclasses.replace(cfg, amc=dataclasses.replace(
        cfg.amc, weight_mode="normal"))
    return jax_init_params(jm.abstract_params(dense_cfg),
                           jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def oracles(dense_params, tmp_path_factory):
    """JAX results for every (kv_mode, pool_mode): int4 from the child
    process (started first), int8 in this process meanwhile."""
    tmp = tmp_path_factory.mktemp("oracle")
    np_params = {k: (np.asarray(v).view(np.uint16)
                     if np.asarray(v).dtype.name == "bfloat16"
                     else np.asarray(v))
                 for k, v in _flatten(jax.tree.map(np.asarray,
                                                   dense_params))}
    np.savez(tmp / "params.npz", **np_params)
    ps = [p.tolist() for p in prompts()]
    args = {"params": str(tmp / "params.npz"), "out": str(tmp / "int4.json"),
            "spec": SPEC, "prompts": ps, "counters": list(COUNTERS),
            "pool_modes": list(POOL_MODES)}
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join(
               [str(REPO / "src"), os.environ.get("PYTHONPATH", "")])}
    child = subprocess.Popen(
        [sys.executable, "-c",
         CHILD % inspect.getsource(_jax_oracle), json.dumps(args)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        res = {("int8", pm): _jax_oracle("int8", pm, dense_params, SPEC, ps,
                                         COUNTERS) for pm in POOL_MODES}
        log, _ = child.communicate(timeout=600)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    assert child.returncode == 0, log[-4000:]
    with open(tmp / "int4.json") as f:
        for pm, r in json.load(f).items():
            res[("int4", pm)] = r
    return res


@pytest.fixture(scope="module")
def torch_params(dense_params):
    return from_numpy_tree(jax.tree.map(np.asarray, dense_params), CPU)


def torch_engine(params, **kw):
    cfg = get_arch("qwen1.5-0.5b").reduced()
    return ServeEngine(cfg, device="cpu", params=params, **kw)


@pytest.mark.parametrize("pool_mode", POOL_MODES)
@pytest.mark.parametrize("kv_mode", ["int8", "int4"])
def test_engine_tokens_match_jax(oracles, torch_params, kv_mode, pool_mode):
    want = oracles[(kv_mode, pool_mode)]
    assert want["min_margin"] > MIN_MARGIN, \
        f"prompt set sits on an argmax near-tie ({want['min_margin']})"
    eng = torch_engine(torch_params, kv_mode=kv_mode, pool_mode=pool_mode,
                       pool_budget_bytes=SPEC["budget"].get(pool_mode),
                       **SPEC["engine"])
    out = eng.generate([Request(prompt=p, max_new_tokens=SPEC["max_new"],
                                id=i) for i, p in enumerate(prompts())])
    assert {str(k): v for k, v in out.items()} == want["tokens"]
    assert eng.dispatch_count == want["dispatches"]
    st = eng.stats()
    assert {k: st[k] for k in COUNTERS} == want["counters"]
    assert {k: st[k] for k in want["bytes"]} == want["bytes"]
    if pool_mode != "normal-only":
        assert st["refreshes"] > 0
    if pool_mode == "augment-on-pressure":
        assert st["augment_events"] > 0
    assert eng.scheduler.stats["enqueued"] == len(SPEC["prompt_lens"])
    assert not eng.active.any() and not eng.scheduler.queue


@pytest.mark.parametrize("plen,chunk,max_seq", [
    (17, 8, 64), (9, 8, 64), (25, 4, 64), (2, 8, 64), (1, 8, 64),
    (19, 8, 20), (31, 8, 32), (21, 4, 22)])
def test_prefill_dispatch_count(torch_params, plen, chunk, max_seq):
    """A P-token prompt costs ceil((P - 1) / chunk) dispatches, also when
    the last chunk sits at the cache end (left-shifted write window)."""
    eng = torch_engine(torch_params, max_batch=2, max_seq=max_seq,
                       prefill_chunk=chunk)
    rng = np.random.default_rng(plen)
    slot = eng.add_request(Request(
        prompt=rng.integers(0, 512, size=plen).astype(np.int32),
        max_new_tokens=1, id=0))
    assert eng.dispatch_count == math.ceil((plen - 1) / chunk)
    assert int(eng.positions[slot]) == plen - 1


def test_near_cache_end_prefill_matches_stepwise(torch_params):
    """The left-shifted final chunk replays already-prefilled tokens: the
    result must equal feeding the prompt one token at a time."""
    prompt = np.random.default_rng(4).integers(0, 512, size=19).astype(
        np.int32)
    outs = []
    for chunked in (True, False):
        eng = torch_engine(torch_params, max_batch=1, max_seq=20,
                           prefill_chunk=8)
        if not chunked:
            eng.prefill_chunk = 1
        outs.append(eng.generate([Request(prompt=prompt, max_new_tokens=1,
                                          id=0)]))
    assert outs[0] == outs[1]


def test_queue_past_max_batch_drops_nothing(torch_params):
    eng = torch_engine(torch_params, max_batch=2, max_seq=32,
                       prefill_chunk=4)
    rng = np.random.default_rng(1)
    reqs = [Request(prompt=rng.integers(0, 512, size=4).astype(np.int32),
                    max_new_tokens=3 + i, id=i) for i in range(5)]
    assert [eng.add_request(r) for r in reqs] == [0, 1, None, None, None]
    outs = eng.generate([])
    assert {k: len(v) for k, v in outs.items()} == {i: 3 + i
                                                    for i in range(5)}
    assert eng.scheduler.stats["admitted"] == 5
    assert not eng.active.any() and eng.slot_req == [None, None]


def test_preemption_recompute_gives_identical_tokens(torch_params):
    """A normal-only pool that cannot hold both rows' growth preempts the
    youngest row, which resumes by recomputing prompt + generated: the
    tokens equal those of an unconstrained run."""
    rng = np.random.default_rng(8)
    ps = [rng.integers(0, 512, size=n).astype(np.int32) for n in (14, 12)]

    def run(budget):
        eng = torch_engine(torch_params, max_batch=2, max_seq=32,
                           prefill_chunk=8, pool_mode="normal-only",
                           pool_budget_bytes=budget)
        out = eng.generate([Request(prompt=p, max_new_tokens=12, id=i)
                            for i, p in enumerate(ps)])
        return out, eng.stats()["preemptions"]

    free, n_free = run(None)
    tight, n_tight = run(3 * 16384)     # 3 pages for two rows of 2 pages
    assert n_free == 0 and n_tight > 0
    assert tight == free


def test_empty_prompt_needs_bos_id(torch_params):
    eng = torch_engine(torch_params, max_batch=1, max_seq=16)
    with pytest.raises(ValueError, match="bos_id"):
        eng.add_request(Request(prompt=np.array([], np.int32), id=0))
    eng = torch_engine(torch_params, max_batch=1, max_seq=16, bos_id=3)
    out = eng.generate([Request(prompt=np.array([], np.int32),
                                max_new_tokens=2, id=0)])
    assert len(out[0]) == 2


def test_add_request_rejects_bad_requests(torch_params):
    eng = torch_engine(torch_params, max_batch=1, max_seq=16)
    with pytest.raises(ValueError, match="exceeds max_seq"):
        eng.add_request(Request(prompt=np.zeros(17, np.int32), id=0))
    with pytest.raises(ValueError, match="outside the vocab"):
        eng.add_request(Request(prompt=np.array([512], np.int32), id=0))
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.add_request(Request(prompt=np.array([1], np.int32),
                                max_new_tokens=0, id=0))
    eng.add_request(Request(prompt=np.array([1, 2], np.int32), id=0))
    with pytest.raises(ValueError, match="already queued"):
        eng.add_request(Request(prompt=np.array([1], np.int32), id=0))


def test_entry_points_default_to_cuda():
    """Without a CUDA device and without device="cpu", every entry point
    raises instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    from repro_torch.models.params import init_params
    cfg = get_arch("qwen1.5-0.5b").reduced()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        from_numpy_tree({"w": np.zeros(2, np.float32)})


def test_pool_policy_matches_jax():
    """The host-side policy of the paged pool, step by step against the
    JAX pool (int8, augment-on-pressure, a budget of three Normal pages):
    admission, growth with augmentation of the coldest page, release,
    and refresh passes that promote expired pages back to Normal."""
    from repro.serve.cache_pool import PagedKVPool as JaxPool
    from repro_torch.serve.cache_pool import PagedKVPool as TorchPool
    jcfg = jax_get_arch("qwen1.5-0.5b").reduced()
    jcfg = dataclasses.replace(jcfg, amc=dataclasses.replace(
        jcfg.amc, kv_impl="dequant", pool_mode="augment-on-pressure"))
    tcfg = get_arch("qwen1.5-0.5b").reduced()
    tcfg = dataclasses.replace(tcfg, amc=dataclasses.replace(
        tcfg.amc, pool_mode="augment-on-pressure"))
    kw = dict(max_batch=2, max_seq=64, budget_bytes=3 * 16384,
              retention_steps=2)
    jp, tp = JaxPool(jcfg, **kw), TorchPool(tcfg, device=CPU, **kw)
    script = [("admit", 0, 20), ("admit", 1, 9), ("ensure", 1, 16),
              ("can", 40), ("refresh",), ("note", 0, 19), ("refresh",),
              ("release", 1), ("refresh",), ("ensure", 0, 32),
              ("refresh",), ("can", 64), ("release", 0), ("can", 64)]
    for step, op in enumerate(script):
        got = []
        for p in (jp, tp):
            if op[0] == "admit":
                got.append(p.admit_row(op[1], op[2], step))
            elif op[0] == "ensure":
                got.append(p.ensure_position(op[1], op[2], step))
            elif op[0] == "can":
                got.append(p.can_admit_tokens(op[1]))
            elif op[0] == "note":
                p.note_token_writes(np.array([op[1]]), np.array([op[2]]),
                                    step)
            elif op[0] == "release":
                p.release_row(op[1])
            else:
                for key in p.refresh_due(step):
                    p.refresh(key, step)
        assert got[:1] == got[1:], (step, op, got)
        np.testing.assert_array_equal(tp.page_table, jp.page_table[:2])
        np.testing.assert_array_equal(tp.page_mode, jp.page_mode[:2])
        assert tp.live_bytes == jp.live_bytes, (step, op)
        assert sorted(tp.policies) == sorted(jp.policies), (step, op)
    jd, td = jp.describe(), tp.describe()
    for k in ("augment_events", "promote_events", "refreshes",
              "refresh_bytes", "augment_bytes", "maintenance_dispatches",
              "alloc_failures", "peak_live_bytes", "pages_live_normal",
              "pages_live_augmented"):
        assert td[k] == jd[k], k
    assert td["augment_events"] > 0 and td["promote_events"] > 0
