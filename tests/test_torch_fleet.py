"""The array fleet: `repro_torch.serve.placement`, the engine's hand-off
(`adopt_request` / `drain_requests`) and `repro_torch.serve.fleet`,
case for case with tests/test_fleet.py, held to the JAX package.

- The policies are pure: every decision (and affinity's `last_reason`)
  is held to `repro.serve.placement`'s on the same `ArrayView`s, in this
  process, on tests/test_fleet.py's views and on seeded random ones.
- The fleets: every JAX `ArrayFleet` run happens in ONE child process
  that aliases `pltpu.TPUCompilerParams` to `pltpu.CompilerParams` before
  it imports `repro` and builds its own Auto-axis mesh (as
  tests/test_torch_serve.py does; the reduced moe config packs int4 KV
  through a Pallas call even on the reference route). Its engines take
  the reference routes (kv_impl="dequant", matmul_impl="dense") and wait
  for every dispatch (ROADMAP queue 3, condition (c)). The port's fleets
  run in this process meanwhile, on the same dense weights. Tokens,
  placements per array, migrations, drains, losses and the merged
  trace's lanes are compared for the dense (qwen1.5-0.5b), moe
  (qwen3-moe-30b-a3b) and ssm (mamba2-130m) reduced archs; the JAX
  engines' decode margins are checked (MIN_MARGIN) so that a token
  comparison never rests on a near-tie.
"""
import contextlib
import dataclasses
import inspect
import itertools
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
from repro.models import model as jm
from repro.models.params import init_params as jax_init_params
from repro.serve import placement as jpl
from repro_torch.configs import get_arch
from repro_torch.models import transformer as T
from repro_torch.models.params import from_numpy_tree
from repro_torch.obs.export import validate_chrome_trace
from repro_torch.serve import (ArrayFleet, ArrayView, Request, ServeEngine,
                               make_policy, make_serving, partition_devices)
from repro_torch.serve import placement as tpl
from repro_torch.serve.state_store import make_store

CPU = torch.device("cpu")
REPO = Path(__file__).resolve().parents[1]
ARCHS = ("qwen1.5-0.5b", "qwen3-moe-30b-a3b", "mamba2-130m")
MIN_MARGIN = 1e-2


def _amc(cfg, **kw):
    return dataclasses.replace(cfg, amc=dataclasses.replace(cfg.amc, **kw))


def _reqs(cfg, n, plen, max_new, seed=0, id0=0):
    rng = np.random.default_rng(seed)
    return [Request(prompt=rng.integers(0, cfg.vocab, size=(plen,))
                    .astype(np.int32), max_new_tokens=max_new, id=id0 + i)
            for i in range(n)]


# ---------------------------------------------------------------------------
# placement policies: pure ArrayView logic, decision for decision
# ---------------------------------------------------------------------------

def _view(mod, aid, *, alive=True, running=0, queued=0, free_rows=4,
          live_bytes=0, budget_bytes=1000, admit=True, prefix=None):
    return mod.ArrayView(
        aid=aid, alive=alive, running=running, queued=queued,
        free_rows=free_rows, live_bytes=live_bytes,
        budget_bytes=budget_bytes, admit_probe=(lambda n: admit),
        prefix_probe=None if prefix is None else (lambda p, m=prefix: m))


def _both(name: str, prompt, specs: list[dict]):
    """The port's and the JAX policy's pick (and last_reason) on the same
    views."""
    out = []
    for mod in (tpl, jpl):
        pol = mod.make_policy(name)
        views = [_view(mod, i, **s) for i, s in enumerate(specs)]
        out.append((pol.place(np.asarray(prompt, np.int32), views),
                    getattr(pol, "last_reason", None)))
    return out


def test_least_loaded_order_and_tiebreaks():
    prompt = np.arange(4, dtype=np.int32)
    cases = [([{"running": 2}, {"running": 1}, {"queued": 3}], 1),
             ([{"live_bytes": 800}, {"live_bytes": 100}], 1),
             ([{}, {}], 0),
             ([{"alive": False}, {"running": 3}], 1)]
    for specs, want in cases:
        got, jax_got = _both("least-loaded", prompt, specs)
        assert got == jax_got and got[0] == want, specs


def test_budget_headroom_prefers_free_bytes():
    got, jax_got = _both("budget-headroom", np.arange(4),
                         [{"live_bytes": 100, "running": 0},
                          {"live_bytes": 0, "running": 5}])
    assert got == jax_got and got[0] == 1


def test_affinity_stable_and_falls_back():
    shared = [7, 3, 7, 3, 7, 3, 7, 3]
    a = np.array(shared + [1, 2], np.int32)
    b = np.array(shared + [9, 9, 9], np.int32)
    specs = [{}, {}, {}]
    (got, why), jax_got = _both("affinity", a, specs)
    assert (got, why) == jax_got and why == "hash"
    assert _both("affinity", b, specs)[0][0] == got
    specs[got] = {"free_rows": 0, "admit": False}
    fb, jax_fb = _both("affinity", a, specs)
    assert fb == jax_fb and fb[0] != got and fb[1] == "fallback"


def test_affinity_prefers_the_deepest_cached_prefix():
    prompt = np.arange(40, dtype=np.int32)
    specs = [{"prefix": 16}, {"prefix": 32, "running": 3}, {"prefix": 32}]
    got, jax_got = _both("affinity", prompt, specs)
    assert got == jax_got == (1, "prefix")
    specs[1] = {"prefix": 32, "free_rows": 0}   # deepest holder full
    got, jax_got = _both("affinity", prompt, specs)
    assert got == jax_got and got[1] in ("hash", "fallback")


def test_make_policy_unknown_raises():
    with pytest.raises(ValueError, match="unknown placement policy"):
        make_policy("round-robin")
    assert sorted(tpl.POLICIES) == sorted(jpl.POLICIES)


def test_place_raises_when_no_survivors():
    p = make_policy("least-loaded")
    with pytest.raises(RuntimeError, match="no surviving arrays"):
        p.place(np.arange(2, dtype=np.int32),
                [_view(tpl, 0, alive=False), _view(tpl, 1, alive=False)])


def test_partition_devices_groups_and_round_robin():
    for devs, n in ((["d0", "d1", "d2", "d3"], 2), (["d0", "d1", "d2", "d3"], 4),
                    (["d0", "d1", "d2", "d3"], 3), (["d0"], 3),
                    (["d0", "d1"], 4)):
        assert partition_devices(devs, n) == jpl.partition_devices(devs, n)
    assert partition_devices(["d0", "d1"], 4) == \
        [["d0"], ["d1"], ["d0"], ["d1"]]
    with pytest.raises(ValueError):
        partition_devices(["d0"], 0)


def test_make_array_meshes_share_one_cpu_device():
    groups = tpl.make_array_meshes(3, device="cpu")
    assert groups == [[CPU]] * 3
    if not torch.cuda.is_available():     # no CPU fallback on its own
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tpl.make_array_meshes(2)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("name", sorted(jpl.POLICIES))
def test_policies_match_jax_on_random_views(name, seed):
    """300 seeded decisions over 1-4 arrays with random liveness, loads,
    bytes, admission probes and cached-prefix depths."""
    rng = np.random.default_rng(seed)
    for _ in range(300):
        n = int(rng.integers(1, 5))
        specs = [{"alive": bool(rng.random() < 0.85),
                  "running": int(rng.integers(0, 4)),
                  "queued": int(rng.integers(0, 3)),
                  "free_rows": int(rng.integers(0, 3)),
                  "live_bytes": int(rng.integers(0, 4)) * 100,
                  "budget_bytes": 400,
                  "admit": bool(rng.random() < 0.7),
                  "prefix": (None if rng.random() < 0.3
                             else int(rng.integers(0, 3)) * 16)}
                 for _ in range(n)]
        prompt = rng.integers(0, 6, size=int(rng.integers(1, 20)))
        if not any(s["alive"] for s in specs):
            for mod in (tpl, jpl):
                with pytest.raises(RuntimeError):
                    mod.make_policy(name).place(
                        prompt, [_view(mod, i, **s)
                                 for i, s in enumerate(specs)])
            continue
        got, jax_got = _both(name, prompt, specs)
        assert got == jax_got, (specs, prompt)


# ---------------------------------------------------------------------------
# the engine's hand-off primitives, the factory, stats (the port alone)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def qwen():
    return get_arch("qwen1.5-0.5b").reduced()


def test_drain_requests_rebuilds_prompts_and_keeps_retry_budget(qwen):
    eng = ServeEngine(qwen, device="cpu", max_batch=2, max_seq=32, seed=1)
    reqs = _reqs(qwen, 3, 5, 6, seed=4)
    for r in reqs:
        eng.add_request(r)
    eng._slot_entry[0].fault_retries = 1     # kept, never charged
    eng._slot_entry[0].not_before = 7
    for _ in range(2):
        eng.step_all()
    drained = eng.drain_requests()
    assert len(drained) == 3
    assert not eng.active.any() and not eng.scheduler.queue
    assert eng.store.live_bytes == 0 and not eng.outputs
    assert sum(e.resumed for e, _ in drained) == 2
    by_id = {e.req.id: (e, gen) for e, gen in drained}
    assert by_id[0][0].fault_retries == 1 and by_id[0][0].not_before == 7
    for r in reqs:
        entry, gen = by_id[r.id]
        assert entry.fault_retries == (1 if r.id == 0 else 0)
        np.testing.assert_array_equal(entry.base_prompt, r.prompt)
        np.testing.assert_array_equal(
            entry.prompt, np.concatenate([r.prompt,
                                          np.asarray(gen, np.int32)]))
        assert entry.remaining == r.max_new_tokens - len(gen)


def test_adopt_request_rejects_duplicate_ids(qwen):
    eng = ServeEngine(qwen, device="cpu", max_batch=2, max_seq=32, seed=1)
    eng.add_request(_reqs(qwen, 1, 5, 4, seed=6)[0])
    entry, gen = eng.drain_requests()[0]
    eng.adopt_request(entry, gen)
    with pytest.raises(ValueError, match="already lives on this array"):
        eng.adopt_request(entry, gen)


def test_adopted_request_finishes_with_the_tokens_it_would_have(qwen):
    """A request drained mid-flight from one engine and adopted by
    another emits the tokens one engine gives it end to end (the resume
    prompt re-prefills what it generated; the outputs are seeded)."""
    req = _reqs(qwen, 1, 6, 8, seed=7)[0]
    want = ServeEngine(qwen, device="cpu", max_batch=2, max_seq=32,
                       seed=1).generate([dataclasses.replace(req)])
    a = ServeEngine(qwen, device="cpu", max_batch=2, max_seq=32, seed=1)
    a.add_request(req)
    for _ in range(3):
        a.step_all()
    (entry, gen), = a.drain_requests()
    assert 0 < len(gen) < 8
    b = ServeEngine(qwen, device="cpu", max_batch=2, max_seq=32, seed=1)
    b.adopt_request(entry, gen)
    assert b.generate([]) == want


def test_make_serving_switches_on_num_arrays(qwen):
    eng = make_serving(qwen, device="cpu", num_arrays=1, max_batch=2,
                       max_seq=32)
    assert isinstance(eng, ServeEngine)
    fleet = make_serving(qwen, device="cpu", num_arrays=2, max_batch=2,
                         max_seq=32)
    assert isinstance(fleet, ArrayFleet) and fleet.num_arrays == 2
    fleet2 = make_serving(_amc(qwen, num_arrays=2), device="cpu",
                          max_batch=2, max_seq=32)
    assert isinstance(fleet2, ArrayFleet)
    assert fleet2.policy.name == "least-loaded"
    # one dense tree: leaves that stay dense are shared, not copied
    p0, p1 = (e.params for e in fleet.engines)
    assert p0["embed"] is p1["embed"]


def test_losing_every_array_raises(qwen):
    fleet = ArrayFleet(qwen, device="cpu", num_arrays=2, max_batch=2,
                       max_seq=32, seed=1)
    for r in _reqs(qwen, 2, 4, 4, seed=9):
        fleet.add_request(r)
    fleet.inject_array_loss(0)
    fleet.step_all()
    fleet.inject_array_loss(1)
    with pytest.raises(RuntimeError, match="no\\s+survivors"):
        fleet.step_all()
    with pytest.raises(RuntimeError, match="no alive arrays"):
        fleet.inject_array_loss()


def test_fleet_stats_report_per_array_state(qwen):
    fleet = ArrayFleet(qwen, device="cpu", num_arrays=2, max_batch=2,
                       max_seq=32, seed=1)
    fleet.generate(_reqs(qwen, 4, 6, 3, seed=11))
    st_ = fleet.stats()
    fl = st_["fleet"]
    assert fl["num_arrays"] == 2 and fl["alive"] == [0, 1]
    assert len(fl["per_array"]) == 2 and len(st_["arrays"]) == 2
    for a in fl["per_array"]:
        assert {"occupancy", "mode_normal", "mode_augmented",
                "refresh_debt", "energy_fj", "heads_axes",
                "tensor_parallel", "mesh_devices", "model_axis"} <= a.keys()
        assert a["model_axis"] == 1 and a["tensor_parallel"] is False
        assert a["heads_axes"] is None and a["mesh_devices"] == 1
    assert sum(fl["placements_per_array"]) == 4
    assert st_["placement"] == {"policy": "least-loaded",
                                "decisions": {"least-loaded": 4}}


_IDS = itertools.count(10_000)


@pytest.fixture(scope="module")
def pressured_fleet(qwen):
    cfg = _amc(qwen, pool_mode="augment-on-pressure", retention_steps=4)
    probe = make_store(cfg, max_batch=2, max_seq=32, device=CPU)
    budget = 2 * probe.geom.page_bytes_normal   # two Normal pages an array
    return ArrayFleet(cfg, device="cpu", num_arrays=2, max_batch=2,
                      max_seq=32, seed=1, pool_budget_bytes=budget)


@pytest.mark.parametrize("seed", range(4))
def test_placement_invariants_random_schedules(pressured_fleet, seed):
    """Seeded add / step schedules against one live pressured fleet: no
    array ever over its byte budget, every request finished with its
    exact token count, none failed."""
    fleet = pressured_fleet
    rng = np.random.default_rng(seed)
    added = {}
    for _ in range(12):
        if rng.random() < 0.6:
            rid = next(_IDS)
            added[rid] = int(rng.integers(1, 6))
            fleet.add_request(Request(
                prompt=rng.integers(0, fleet.cfg.vocab,
                                    size=(int(rng.integers(1, 11)),))
                .astype(np.int32), max_new_tokens=added[rid], id=rid))
        else:
            fleet.step_all()
        for eng in fleet.engines:
            assert eng.store.live_bytes <= eng.store.budget_bytes
    for _ in range(500):
        if not fleet.has_work:
            break
        fleet.step_all()
        for eng in fleet.engines:
            assert eng.store.live_bytes <= eng.store.budget_bytes
    assert not fleet.has_work and not fleet.failed
    outs = fleet.outputs
    for rid, want in added.items():        # no request ever lost
        assert rid in outs and len(outs[rid]) == want, (rid, outs.get(rid))


# ---------------------------------------------------------------------------
# the fleets against the JAX ArrayFleet (one child process)
# ---------------------------------------------------------------------------

def _streams() -> dict:
    """name -> (arch, amc override, engine / fleet kwargs, requests (n,
    plen, max_new, prompt seed), how to drive): tests/test_fleet.py's
    runs at its own seeds, and one array at max_batch 4 on each request
    set the fleet's tokens are held to."""
    out = {}
    for arch in ARCHS:
        out[f"single/{arch}"] = (arch, {}, {"max_batch": 4, "max_seq": 32},
                                 (4, 6, 5, 3), "single")
        out[f"fleet/{arch}"] = (arch, {}, {"num_arrays": 2, "max_batch": 2,
                                           "max_seq": 32},
                                (4, 6, 5, 3), "generate")
        out[f"single6/{arch}"] = (arch, {}, {"max_batch": 4,
                                             "max_seq": 32},
                                  (6, 6, 4, 5), "single")
        out[f"migrate/{arch}"] = (arch, {}, {"num_arrays": 2, "max_batch": 2,
                                             "max_seq": 32},
                                  (6, 6, 4, 5), "pile")
        out[f"loss/{arch}"] = (arch, {}, {"num_arrays": 2, "max_batch": 2,
                                          "max_seq": 32, "max_retries": 0},
                               (6, 8, 8, 2), "loss")
    out["trace"] = ("qwen1.5-0.5b", {}, {"num_arrays": 2, "max_batch": 2,
                                         "max_seq": 32, "trace": True,
                                         "metrics": True},
                    (4, 6, 4, 8), "generate")
    out["affinity"] = ("qwen1.5-0.5b", {"page_size": 8},
                       {"num_arrays": 2, "placement": "affinity",
                        "max_batch": 2, "max_seq": 48, "prefix_cache": 4},
                       (5, 6, 4, 12), "shared")
    return out


def _requests(cfg, spec, how):
    n, plen, max_new, seed = spec
    reqs = _reqs(cfg, n, plen, max_new, seed=seed)
    if how == "shared":       # one 20-token system prompt ahead of each
        sys_p = np.random.default_rng(seed + 1).integers(
            0, cfg.vocab, size=(20,)).astype(np.int32)
        reqs = [dataclasses.replace(r, prompt=np.concatenate(
            [sys_p, r.prompt])) for r in reqs]
    return reqs


def _drive(fleet, reqs, how) -> list:
    """Run `reqs` as the stream says; returns the lost array ids."""
    lost = []
    if how in ("single", "generate", "shared"):
        fleet.generate(reqs)
    elif how == "pile":
        for r in reqs:
            fleet.engines[0].add_request(r)
        for _ in range(200):
            if not fleet.has_work:
                break
            fleet.step_all()
    elif how == "loss":
        for r in reqs:
            fleet.add_request(r)
        for _ in range(3):
            fleet.step_all()
        lost.append(fleet.inject_array_loss())
        for _ in range(400):
            if not fleet.has_work:
                break
            fleet.step_all()
    return lost


def _summary(fleet, lost, how) -> dict:
    """What the two packages' runs are compared on (JSON-able)."""
    out = {"tokens": {str(k): [int(t) for t in v]
                      for k, v in fleet.outputs.items()},
           "failed": sorted(int(k) for k in fleet.failed), "lost": lost}
    if how == "single":
        return out
    st = fleet.stats()
    fl = st["fleet"]
    out.update({k: fl[k] for k in ("placements_per_array", "migrations",
                                   "array_losses", "drain_requeues",
                                   "dead", "alive", "peak_concurrency",
                                   "placements")})
    out["decisions"] = st["placement"]["decisions"]
    out["live_bytes"] = [int(e.store.live_bytes) for e in fleet.engines]
    out["hits"] = [int(a.get("prefix", {}).get("hits", 0))
                   for a in st["arrays"]]
    if fleet.engines[0].obs.enabled:
        merged = []
        for eng in fleet.engines:
            merged += eng.obs.tracer.chrome_trace()["traceEvents"]
        count = {}
        for e in merged:
            key = json.dumps([e["pid"], e.get("tid", -1), e["name"],
                              e["ph"]])
            count[key] = count.get(key, 0) + 1
        out["events"] = count
        out["placement_args"] = sorted(
            json.dumps(e["args"], sort_keys=True) for e in merged
            if e["name"] == "placement")
        out["lanes"] = sorted(e["args"]["name"] for e in merged
                              if e["name"] in ("process_name",
                                               "thread_name"))
        reg = fleet.engines[0].obs.metrics
        out["counters"] = {k: v for k, v in reg.counters.items()
                           if k.startswith("placement")}
    return out


def _jax_runs(params: dict, streams: dict) -> dict:
    """Every stream through the JAX package's fleet (or one engine), with
    each emitted token's decode top-1/top-2 margin (request id -> margin
    by output index). Runs by source in the child process."""
    import dataclasses
    import jax
    import numpy as np
    from jax.sharding import AxisType
    from repro.configs import get_arch
    from repro.serve import ArrayFleet, ServeEngine
    from repro.serve import engine as jeng

    margins: dict = {}
    base_dispatch = jeng.ServeEngine._dispatch
    base_stepwise = jeng.ServeEngine._prefill_stepwise

    def stepwise(self, slot, tokens):
        # a stepwise prefill's logits are not emitted
        self._prefilling = True
        try:
            return base_stepwise(self, slot, tokens)
        finally:
            self._prefilling = False

    def dispatch(self, fn, batch):
        logits = base_dispatch(self, fn, batch)
        jax.block_until_ready(logits)
        if fn is self._decode and not getattr(self, "_prefilling", False):
            lg = np.asarray(logits[:, -1, :self.cfg.vocab], np.float32)
            top = np.sort(lg, axis=-1)[:, -2:]
            for row in np.flatnonzero(np.asarray(batch["write_mask"])):
                rid = self.slot_req[row].id
                at = len(self.outputs.get(rid, []))
                m = margins.setdefault(str(rid), {})
                m[str(at)] = float(top[row, 1] - top[row, 0])
        return logits

    jeng.ServeEngine._dispatch = dispatch
    jeng.ServeEngine._prefill_stepwise = stepwise
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    out = {}
    for name, (arch, amc, kw, spec, how) in streams.items():
        cfg = get_arch(arch).reduced()
        cfg = dataclasses.replace(cfg, amc=dataclasses.replace(
            cfg.amc, kv_impl="dequant", matmul_impl="dense", **amc))
        margins.clear()
        if how == "single":
            fleet = ServeEngine(cfg, mesh, params=params[arch], **kw)
        else:
            fleet = ArrayFleet(cfg, mesh, params=params[arch], **kw)
        reqs = _requests(cfg, spec, how)
        res = _summary(fleet, _drive(fleet, reqs, how), how)
        res["margins"] = {k: dict(v) for k, v in margins.items()}
        out[name] = res
    return out


CHILD = """
import json, sys
import numpy as np
from jax.experimental.pallas import tpu as pltpu
pltpu.TPUCompilerParams = pltpu.CompilerParams
import jax, jax.numpy as jnp
import dataclasses
from repro.serve import Request
args = json.loads(sys.argv[1])
params = {}
for arch, path in args["params"].items():
    flat = np.load(path)
    tree = params.setdefault(arch, {})
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
out = _jax_runs(params, args["streams"])
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
    """Each arch's dense weights from the JAX initialiser at the JAX
    tests' seed 1 (they cross to the child by file)."""
    out = {}
    for arch in ARCHS:
        c = jax_get_arch(arch).reduced()
        c = dataclasses.replace(c, amc=dataclasses.replace(
            c.amc, weight_mode="normal"))
        out[arch] = jax.tree.map(np.asarray, jax.jit(
            lambda k, c=c: jax_init_params(jm.abstract_params(c), k))(
            jax.random.PRNGKey(1)))
    return out


@pytest.fixture(scope="module")
def oracle_child(dense_params, tmp_path_factory):
    """The child process, started at the module's first oracle test; its
    results are read (and waited for) by `oracles`."""
    tmp = tmp_path_factory.mktemp("fleet")
    paths = {}
    for arch, tree in dense_params.items():
        paths[arch] = str(tmp / f"{arch}.npz")
        np.savez(paths[arch], **{
            k: (v.view(np.uint16) if v.dtype.name == "bfloat16" else v)
            for k, v in _flatten(tree)})
    args = {"params": paths, "streams": _streams(),
            "out": str(tmp / "out.json")}
    src = "\n\n".join(inspect.getsource(f) for f in (
        _reqs, _requests, _drive, _summary, _jax_runs))
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join(
               [str(REPO / "src"), os.environ.get("PYTHONPATH", "")])}
    child = subprocess.Popen(
        [sys.executable, "-c", CHILD % src, json.dumps(args)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    yield child, args
    if child.poll() is None:
        child.kill()
        child.wait()


@contextlib.contextmanager
def jax_capacity_rule():
    """The JAX package's MoE capacity rule in the port: a prefill chunk's
    pad rows take expert capacity slots too. The port's own rule lets
    only written rows take them (`models/moe.py`), so its prefill
    does not depend on the rows around it; JAX's does, so a JAX MoE
    engine's tokens are only comparable to the port's under JAX's rule."""
    orig = T.ffn_dispatch
    T.ffn_dispatch = lambda *a, rows=None, **kw: orig(*a, rows=None, **kw)
    try:
        yield
    finally:
        T.ffn_dispatch = orig


@pytest.fixture(scope="module")
def port_runs(oracle_child, dense_params):
    """Every stream through the port (while the child runs); the moe
    streams once more under the JAX capacity rule ("name@jax")."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)       # tiny tensors; the child needs cores
    params = {a: from_numpy_tree(t, CPU) for a, t in dense_params.items()}
    out = {}
    for name, (arch, amc, kw, spec, how) in _streams().items():
        cfg = _amc(get_arch(arch).reduced(), **amc)
        rules = [(name, contextlib.nullcontext)]
        if arch == "qwen3-moe-30b-a3b":
            rules.append((f"{name}@jax", jax_capacity_rule))
        for key, rule in rules:
            with rule():
                if how == "single":
                    fleet = ServeEngine(cfg, device="cpu",
                                        params=params[arch], **kw)
                else:
                    fleet = ArrayFleet(cfg, device="cpu",
                                       params=params[arch], **kw)
                reqs = _requests(cfg, spec, how)
                out[key] = _summary(fleet, _drive(fleet, reqs, how), how)
            out[key]["fleet"] = fleet
    torch.set_num_threads(threads)
    return out


@pytest.fixture(scope="module")
def oracles(oracle_child, port_runs):
    child, args = oracle_child
    log, _ = child.communicate(timeout=900)
    assert child.returncode == 0, log[-4000:]
    with open(args["out"]) as f:
        return json.load(f)


def _agree_with_jax(port_runs, oracles, name) -> int:
    """The port's tokens against the JAX run's (the moe ones under JAX's
    capacity rule), request by request: equal up to the end, or up to a
    step where the JAX engine's top-1/top-2 logit margin is at most
    MIN_MARGIN (the reduced logits are coarse: exact ties are common)
    and the two argmaxes part there. Returns the tokens compared;
    at least three quarters of them must be."""
    got = port_runs.get(f"{name}@jax", port_runs[name])["tokens"]
    want = oracles[name]
    assert sorted(got) == sorted(want["tokens"])
    compared = total = 0
    for rid, ref in want["tokens"].items():
        toks = got[rid]
        assert len(toks) == len(ref), rid
        total += len(ref)
        for i, (a, b) in enumerate(zip(toks, ref)):
            if a != b:
                m = want["margins"][rid][str(i)]
                assert m <= MIN_MARGIN, \
                    f"{name}: request {rid} parts from JAX at output {i} " \
                    f"where JAX's margin is {m}"
                break
            compared += 1
    assert compared * 4 >= total * 3, (name, compared, total)
    return compared


def _same(port: dict, jax_: dict, keys) -> None:
    for k in keys:
        assert port[k] == jax_[k], (k, port[k], jax_[k])


@pytest.mark.parametrize("arch", ARCHS)
def test_fleet_token_identity_vs_single_array(oracles, port_runs, arch):
    """2 arrays x max_batch 2 against one array at max_batch 4: in each
    package the fleet's tokens equal one array's exactly; the port's
    equal JAX's (tie-aware), both arrays used alike."""
    single, fleet = port_runs[f"single/{arch}"], port_runs[f"fleet/{arch}"]
    assert fleet["tokens"] == single["tokens"] and not fleet["failed"]
    jsingle, jfleet = oracles[f"single/{arch}"], oracles[f"fleet/{arch}"]
    assert jfleet["tokens"] == jsingle["tokens"]
    _agree_with_jax(port_runs, oracles, f"single/{arch}")
    _agree_with_jax(port_runs, oracles, f"fleet/{arch}")
    _same(fleet, jfleet, ("placements_per_array", "peak_concurrency",
                          "migrations", "placements"))
    assert fleet["placements_per_array"] == [2, 2]
    assert fleet["peak_concurrency"] >= 3


@pytest.mark.parametrize("arch", ARCHS)
def test_rebalance_migrates_queued_work_to_idle_array(oracles, port_runs,
                                                      arch):
    """Six requests piled onto array 0 past the policy: queued work
    migrates to array 1 and completes; the migrations equal JAX's, the
    tokens one array's (exactly) and JAX's (tie-aware)."""
    got = port_runs[f"migrate/{arch}"]
    assert got["migrations"] > 0 and not got["failed"]
    assert sorted(map(int, got["tokens"])) == list(range(6))
    assert got["tokens"] == port_runs[f"single6/{arch}"]["tokens"]
    _agree_with_jax(port_runs, oracles, f"migrate/{arch}")
    _same(got, oracles[f"migrate/{arch}"],
          ("migrations", "placements_per_array", "failed"))


@pytest.mark.parametrize("arch", ARCHS)
def test_array_loss_drains_onto_survivors_without_charging_retries(
        oracles, port_runs, arch):
    """max_retries=0: any charge against a retry budget would fail the
    request, so every request completing proves the drain leaves
    `fault_retries` untouched. The lost array, drains, placements and
    migrations equal the JAX fleet's; the tokens JAX's (tie-aware)."""
    got = port_runs[f"loss/{arch}"]
    lost = got["lost"][0]
    assert got["array_losses"] == 1 and got["dead"] == [lost]
    assert got["drain_requeues"] > 0 and not got["failed"]
    assert sorted(map(int, got["tokens"])) == list(range(6))
    assert all(len(v) == 8 for v in got["tokens"].values())
    assert got["live_bytes"][lost] == 0
    fleet = got["fleet"]
    assert not fleet.engines[lost].active.any()
    assert fleet.engines[1 - lost].step_idx > 0
    _agree_with_jax(port_runs, oracles, f"loss/{arch}")
    _same(got, oracles[f"loss/{arch}"],
          ("lost", "dead", "array_losses", "drain_requeues",
           "placements_per_array", "migrations", "failed", "live_bytes"))


def test_affinity_co_locates_shared_prefixes_as_jax(oracles, port_runs):
    """Affinity over one 20-token system prompt (page 8, prefix_cache 4):
    the same decisions (prefix / hash / fallback), placements and prefix
    hits per array as the JAX fleet, and its tokens (tie-aware)."""
    got = port_runs["affinity"]
    assert got["decisions"].get("prefix", 0) > 0 and sum(got["hits"]) > 0
    _agree_with_jax(port_runs, oracles, "affinity")
    _same(got, oracles["affinity"],
          ("decisions", "placements_per_array", "hits", "migrations",
           "failed"))


def test_fleet_trace_has_per_array_lanes_and_validates(oracles, port_runs,
                                                       tmp_path):
    """The merged trace: valid, one pid and one "array N" lane an array,
    4 admit placements, `amc_placement_admit 4` in the fleet-wide dump;
    the lanes, the per-pid event counts (track, name, phase), the
    placement instants' args and the placement counters equal the JAX
    fleet's."""
    got = port_runs["trace"]
    fleet = got["fleet"]
    obj = fleet.export_trace(str(tmp_path / "fleet_trace.json"))
    assert validate_chrome_trace(obj) == []
    assert {e["pid"] for e in obj["traceEvents"]} == {0, 1}
    names = {e["args"]["name"] for e in obj["traceEvents"]
             if e.get("name") == "process_name"}
    assert names == {"array 0", "array 1"}
    placements = [e for e in obj["traceEvents"]
                  if e.get("name") == "placement"]
    assert len(placements) == 4
    assert all(p["args"]["kind"] == "admit" for p in placements)
    text = fleet.export_metrics(str(tmp_path / "fleet.prom"))
    assert "amc_placement_admit 4" in text
    _agree_with_jax(port_runs, oracles, "trace")
    _same(got, oracles["trace"], ("lanes", "events", "placement_args",
                                  "counters"))


def test_fault_domains_are_per_array(qwen):
    """Each array draws its own fault schedule (fault_seed + array id)
    and keeps its own supervisor, ledger and step clock."""
    fleet = ArrayFleet(_amc(qwen, fault_rate=0.01, fault_seed=5),
                       device="cpu", num_arrays=3, max_batch=2, max_seq=32)
    assert [e.cfg.amc.fault_seed for e in fleet.engines] == [5, 6, 7]
    assert len({id(e.supervisor) for e in fleet.engines}) == 3
    assert len({id(e.energy_ledger) for e in fleet.engines}) == 3
    assert len({id(e.store) for e in fleet.engines}) == 3


def test_array_views_match_the_engines(qwen):
    """`_views()` reads each engine's rows, queue and store as the JAX
    fleet does; a view's probes are the engine's own."""
    fleet = ArrayFleet(qwen, device="cpu", num_arrays=2, max_batch=2,
                       max_seq=32, seed=1)
    for r in _reqs(qwen, 3, 5, 4, seed=2):
        fleet.engines[0].add_request(r)
    views = fleet._views()
    assert [(v.running, v.queued, v.free_rows) for v in views] == \
        [(2, 1, 0), (0, 0, 2)]
    assert views[0].live_bytes == fleet.engines[0].store.live_bytes > 0
    assert isinstance(views[0], ArrayView)
    assert not views[0].can_admit_now(5) and views[1].can_admit_now(5)
    assert fleet._migration_target(5, exclude=0) == 1
