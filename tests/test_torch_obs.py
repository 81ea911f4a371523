"""The port's observability plane (`repro_torch.obs`), its wiring into the
engine, scheduler and stores, and its serving CLI, against the JAX
package on the same inputs.

- The primitives (`LogHistogram`, `TimeSeries`, `MetricsRegistry`,
  `Tracer`, `EngineObs`, the validator and the exporters) give
  `repro.obs`'s results exactly on numpy-seeded streams. `repro.obs`
  imports no jax, so this runs in the pytest process.
- The engine, fed the same requests and weights under the same counter
  clock (`make_engine_obs(amc, clock=...)` passed as `obs=`), gives the
  JAX engine's Chrome trace event for event (ph, name, tid, ts, dur,
  args), its counters and gauges, every histogram's buckets (only the
  count of `step_wall_s`, which is `time.perf_counter`'s) and its sampled
  series, on tests/test_obs.py's streams (`traced_run`, the preemption
  cell, the fault + speculative cell), tests/test_torch_prefix.py's
  augment-on-pressure sharing stream (copy-on-write and demotion events)
  and, for the slab store, the reduced recurrentgemma config in place of
  test_obs.py's mamba2 case.
- The rest of test_obs.py's contracts hold on the port alone, and the
  CLI (`python -m repro_torch.launch.serve --device cpu`) serves what an
  in-process engine serves and writes files that validate.

The JAX engines run their reference attention path (kv_impl="dequant");
the port keeps its defaults (the kernels' plain versions here). Tokens
are compared exactly on streams whose JAX top-1/top-2 margin at every
emitting dispatch (decode, draft and verify) clears test_torch_prefix.py's
floor for the KV width (checked). JAX's int4 pack reaches its Pallas
call, which this jax runs only with `pltpu.TPUCompilerParams` aliased to
`pltpu.CompilerParams`, so every JAX engine runs in one CHILD process that
sets the alias before it imports `repro`; nothing here patches jax.
"""
import dataclasses
import inspect
import itertools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.obs as jobs
from repro.obs import export as jexport
from repro_torch import obs as tobs
from repro_torch.configs import get_arch
from repro_torch.configs.base import AMCConfig
from repro_torch.models.params import from_numpy_tree
from repro_torch.obs import export as texport
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve.cache_pool import PageGeometry

CPU = torch.device("cpu")
REPO = Path(__file__).resolve().parents[1]
MIN_MARGIN = 1e-2           # test_torch_prefix.py's floor (int8 / bf16 KV)
INT4_MARGIN = 0.03          # ... and its floor at int4 KV


# ---------------------------------------------------------------------------
# primitives against repro.obs
# ---------------------------------------------------------------------------

def _values(rng, n):
    """Latency-like values across the histogram's whole range: log-uniform
    from 1e-8 (below `lo`) to 1e5 s (overflow), plus exact bucket edges."""
    v = 10.0 ** rng.uniform(-8, 5, size=n)
    edges = 1e-6 * 2.0 ** rng.integers(0, 40, size=n // 8)
    return [float(x) for x in np.concatenate([v, edges])]


@pytest.mark.parametrize("seed", range(4))
def test_log_histogram_matches_jax(seed):
    rng = np.random.default_rng(seed)
    kw = [{}, {"lo": 1e-4, "growth": 1.5, "n_buckets": 12}][seed % 2]
    t, j = tobs.LogHistogram(**kw), jobs.LogHistogram(**kw)
    for v in _values(rng, 200):
        if rng.random() < 0.3:
            n = int(rng.integers(0, 5))
            t.observe_n(v, n)
            j.observe_n(v, n)
        else:
            t.observe(v)
            j.observe(v)
    assert t.counts == j.counts and t.count == j.count
    assert (t.sum, t.min, t.max) == (j.sum, j.min, j.max)
    assert t.summary() == j.summary()
    for p in rng.uniform(0, 100, size=16).tolist() + [0, 50, 99, 100]:
        assert t.percentile(p) == j.percentile(p)
    vals = _values(rng, 64)
    for a, b in zip(vals, vals[1:]):
        assert t.bucket_index(a) == j.bucket_index(a)
        assert t.within_one_bucket(a, b) == j.within_one_bucket(a, b)
    for i in range(t.n_buckets + 2):
        assert t.bucket_edge(i) == j.bucket_edge(i)


@pytest.mark.parametrize("max_samples", [4, 7, 64])
def test_timeseries_decimation_matches_jax(max_samples):
    rng = np.random.default_rng(max_samples)
    t, j = tobs.TimeSeries(max_samples), jobs.TimeSeries(max_samples)
    for step in range(int(rng.integers(200, 2000))):
        v = float(rng.normal())
        t.sample(step, v)
        j.sample(step, v)
        if step % 97 == 0:
            assert t.samples == j.samples
    assert t.samples == j.samples and t.describe() == j.describe()
    assert t.last() == j.last()


def _registry_script(reg, seed):
    rng = np.random.default_rng(seed)
    names = ["requests", "tokens_emitted", "preempt_capacity", "lat_s",
             "ttft_s", "queue_depth", "mode_normal", "a.b-c"]
    for step in range(300):
        op = int(rng.integers(0, 4))
        name = names[int(rng.integers(0, len(names)))]
        if op == 0:
            reg.inc(name, int(rng.integers(1, 4)))
        elif op == 1:
            reg.gauge(name, float(rng.normal()))
        elif op == 2:
            reg.observe(name, float(10.0 ** rng.uniform(-6, 2)))
        else:
            reg.sample(name, step, int(rng.integers(0, 9)))
    return reg


@pytest.mark.parametrize("seed", range(3))
def test_metrics_registry_matches_jax(seed, tmp_path):
    t = _registry_script(tobs.MetricsRegistry(series_max_samples=16), seed)
    j = _registry_script(jobs.MetricsRegistry(series_max_samples=16), seed)
    assert t.describe() == j.describe()
    assert t.dump_timeseries() == j.dump_timeseries()
    assert t.prometheus_text() == j.prometheus_text()
    tt = texport.write_prometheus(t, str(tmp_path / "t.prom"))
    jt = jexport.write_prometheus(j, str(tmp_path / "j.prom"))
    assert tt == jt
    assert (tmp_path / "t.prom").read_text() == (tmp_path / "j.prom") \
        .read_text()


def _clock():
    tick = itertools.count()
    return lambda: next(tick) * 1e-3


def _tracer_script(mod, seed):
    """A random, well-nested or not, sequence of begin/end/span/instant/
    counter calls on `mod.Tracer` under a counter clock."""
    rng = np.random.default_rng(seed)
    tr = mod.Tracer(clock=_clock(), pid=int(seed), process=f"p{seed}")
    open_ids = []
    for _ in range(120):
        op = int(rng.integers(0, 6))
        tid = int(rng.choice([0, 1, 2, 3, tr.request_track(
            int(rng.integers(0, 5)))]))
        if op == 0:
            open_ids.append(tr.begin(tid, "queue", step=int(
                rng.integers(0, 9))))
        elif op == 1 and open_ids:
            tr.end(open_ids.pop(int(rng.integers(0, len(open_ids)))),
                   outcome="done")
        elif op == 2:
            with tr.span(tid, "prefill_chunk", tokens=int(
                    rng.integers(1, 9))):
                tr.instant(tid, "token")
        elif op == 3:
            tr.instant(tid, "enqueue", step=int(rng.integers(0, 9)))
        elif op == 4:
            tr.counter("mode_mix", normal=int(rng.integers(0, 9)),
                       augmented=int(rng.integers(0, 9)))
        else:
            tr.name_track(tid, f"lane {tid}")
    if seed % 2 == 0:
        for sid in open_ids:
            tr.end(sid)
    return tr


@pytest.mark.parametrize("seed", range(4))
def test_tracer_and_validator_match_jax(seed, tmp_path):
    t, j = _tracer_script(tobs, seed), _tracer_script(jobs, seed)
    assert t.open_spans() == j.open_spans()
    tobj, jobj = t.chrome_trace(), j.chrome_trace()
    assert tobj == jobj
    assert tobs.validate_chrome_trace(tobj) == jobs.validate_chrome_trace(
        jobj)
    assert (tobs.validate_chrome_trace(tobj) == []) == (seed % 2 == 0)
    texport.write_chrome_trace(t, str(tmp_path / "t.json"))
    jexport.write_chrome_trace(j, str(tmp_path / "j.json"))
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json") \
        .read_text()
    assert texport.merge_chrome_traces([tobj, tobj]) \
        == jexport.merge_chrome_traces([jobj, jobj])


def _malformed(rng):
    """A trace object with random faults: bad phases, missing keys,
    time going backwards, negative durations, bad instant scopes,
    unnamed tracks, non-dict events, a bad top level."""
    kind = int(rng.integers(0, 4))
    if kind == 0:
        return [[], {"x": 1}, {"traceEvents": 3}][int(rng.integers(0, 3))]
    events = [{"name": "thread_name", "ph": "M", "pid": 0, "tid": 0,
               "args": {"name": "e"}}]
    ts = 0.0
    for _ in range(int(rng.integers(1, 12))):
        ts += float(rng.normal(1.0, 2.0))
        e = {"name": "s", "ph": str(rng.choice(["X", "i", "C", "Z"])),
             "ts": ts, "pid": 0, "tid": int(rng.integers(0, 2))}
        if e["ph"] == "X":
            e["dur"] = float(rng.normal(1.0, 2.0))
            if rng.random() < 0.2:
                e["args"] = {"open_at_export": True}
        if e["ph"] == "i":
            e["s"] = str(rng.choice(["t", "p", "q"]))
        if rng.random() < 0.1:
            del e[str(rng.choice(["name", "pid", "ts"]))]
        events.append(e if rng.random() > 0.05 else 7)
    return {"traceEvents": events}


def _verdict(validate, obj):
    """The validator's problems, or the exception it raises (an event
    without a pid makes both packages' track sort raise TypeError)."""
    try:
        return validate(obj)
    except Exception as e:           # noqa: BLE001 - compared, not hidden
        return type(e).__name__


def test_validator_verdicts_match_jax(tmp_path):
    rng = np.random.default_rng(7)
    for i in range(200):
        obj = _malformed(rng)
        assert _verdict(tobs.validate_chrome_trace, obj) \
            == _verdict(jobs.validate_chrome_trace, obj), obj
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    assert tobs.validate_chrome_trace_file(str(bad)) \
        == jobs.validate_chrome_trace_file(str(bad))


def _facade_script(mod, seed):
    """Every EngineObs hook in a random order under a counter clock."""
    rng = np.random.default_rng(seed)
    amc = AMCConfig(trace=True, metrics=True, obs_sample_every=2)
    o = mod.make_engine_obs(amc, clock=_clock())
    for step in range(60):
        rid = int(rng.integers(0, 6))
        op = int(rng.integers(0, 14))
        if op == 0:
            o.on_enqueue(rid, int(rng.integers(1, 30)), 8, step)
        elif op == 1:
            o.on_admit(rid, int(rng.integers(0, 4)), step)
        elif op == 2:
            with o.prefill_span(rid, 9):
                with o.chunk_span(rid, 8):
                    pass
        elif op == 3:
            o.on_tokens(rid, int(rng.integers(0, 4)), step)
        elif op == 4:
            o.on_preempt(rid, step, str(rng.choice(["capacity",
                                                    "fault_recompute"])))
        elif op == 5:
            (o.on_complete if rng.random() < 0.7 else o.on_failed)(rid, step)
        elif op == 6:
            o.on_handoff(rid, step, "drained")
        elif op == 7:
            with o.step_span(step, "decode"):
                with o.phase_span("admit"):
                    pass
                with o.fault_span(step):
                    o.on_fault("inject", f"pg{rid}", step)
            o.on_step_done(step, 1e-3 * (1 + rid))
        elif op == 8:
            o.on_spec_round(int(rng.integers(0, 8)), 2, step)
            o.on_queue_depth(int(rng.integers(0, 5)))
        elif op == 9:
            o.on_placement(rid, 1, "least-loaded", "admit", step)
        elif op == 10:
            o.on_refresh_pass(int(rng.integers(0, 3)), step)
            o.store_event(str(rng.choice(["augment", "promote", "cow"])),
                          f"pg{rid}", step)
        elif op == 11:
            o.on_prefix(str(rng.choice(["hit", "miss"])), rid,
                        int(rng.integers(0, 16)), step)
        elif o.wants_sample(step):
            o.sample(step, {"pool_occupancy": float(rng.random()),
                            "mode_normal": int(rng.integers(0, 4)),
                            "mode_augmented": int(rng.integers(0, 4)),
                            "queue_depth": int(rng.integers(0, 3))})
    return o


@pytest.mark.parametrize("seed", range(3))
def test_engine_obs_facade_matches_jax(seed, tmp_path):
    t, j = _facade_script(tobs, seed), _facade_script(jobs, seed)
    assert t.describe() == j.describe()
    assert t.tracer.chrome_trace() == j.tracer.chrome_trace()
    assert t.metrics.dump_timeseries() == j.metrics.dump_timeseries()
    assert t.export_metrics(str(tmp_path / "t.prom")) \
        == j.export_metrics(str(tmp_path / "j.prom"))
    assert t.export_trace(str(tmp_path / "t.json")) \
        == j.export_trace(str(tmp_path / "j.json"))
    null = tobs.make_engine_obs(AMCConfig())
    assert null is tobs.NULL_OBS and null.describe() \
        == jobs.NULL_OBS.describe()


# ---------------------------------------------------------------------------
# the engine against the JAX engine: the cells and their shared source
# ---------------------------------------------------------------------------

def _prompts(n, plen, seed, vocab=512):
    """tests/test_obs.py's `_reqs` prompts (the reduced vocab is 512)."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=(plen,)).astype(np.int32).tolist()
            for _ in range(n)]


def _pressure_prompts():
    """tests/test_torch_prefix.py's "compare" stream (seed 31): a 29-token
    system prompt and 8 tails of 2-9 tokens."""
    rng = np.random.default_rng(31)
    sys_p = rng.integers(0, 100, size=29).astype(np.int32)
    return [np.concatenate([sys_p, rng.integers(0, 100, size=int(n))
                            .astype(np.int32)]).tolist()
            for n in rng.integers(2, 10, size=8)]


def _pressure_budget(pages):
    cfg = get_arch("qwen1.5-0.5b").reduced()
    return pages * PageGeometry(cfg.n_layers, cfg.n_kv_heads, cfg.hd, 8,
                                4).page_bytes_normal


def _hybrid_prompts():
    """tests/test_torch_hybrid.py's engine prompts (seed 94)."""
    rng = np.random.default_rng(94)
    return [rng.integers(0, 512, size=n).astype(np.int32).tolist()
            for n in (21, 9, 26, 14)]


def _pressure_cell(pages):
    """test_torch_prefix.py's sharing under augment-on-pressure (ternary
    weights, 8-token pages) at a budget of `pages` Normal pages; both
    engines take the plain matmuls, so the energy ledger's weight events
    agree."""
    return dict(
        arch="qwen1.5-0.5b", fresh=False,
        amc={"page_size": 8, "kv_mode": "int4",
             "pool_mode": "augment-on-pressure", "prefix_cache": 4,
             "matmul_impl": "dense"},
        engine={"max_batch": 4, "max_seq": 96, "prefill_chunk": 8,
                "pool_budget_bytes": _pressure_budget(pages)},
        seed=0, prompts=_pressure_prompts(), max_new=4, margin=INT4_MARGIN)


# name -> (arch, fresh AMCConfig or the arch's, AMC fields, engine
# kwargs, weight seed, prompts, max_new, token margin floor)
CELLS = {
    # test_obs.py's traced_run: queueing under a 40 kB int4 budget. Its
    # prompt seed 0 (and 1-23) sits on an argmax near-tie: seed 24
    "traced_run": dict(
        arch="qwen1.5-0.5b", fresh=True,
        amc={"kv_mode": "int4", "pool_mode": "always-augmented"},
        engine={"max_batch": 2, "max_seq": 48, "prefill_chunk": 8,
                "pool_budget_bytes": 40_000},
        seed=0, prompts=_prompts(5, 6, 24), max_new=10, margin=INT4_MARGIN),
    # test_obs.py's preemption cell: 2 growing rows, 3 pages of storage
    "preempt": dict(
        arch="qwen1.5-0.5b", fresh=True,
        amc={"kv_mode": "int8", "pool_mode": "always-augmented"},
        engine={"max_batch": 2, "max_seq": 32, "prefill_chunk": 16,
                "pool_budget_bytes": 3 * 8704},
        seed=4, prompts=_prompts(2, 14, 3), max_new=6, margin=MIN_MARGIN),
    # test_obs.py's fault + speculative cell (prompt seed 0 and 1 sit on
    # near-ties: seed 2)
    "fault_spec": dict(
        arch="qwen1.5-0.5b", fresh=True,
        amc={"kv_mode": "int4", "pool_mode": "always-augmented",
             "spec_k": 3, "retention_steps": 8, "fault_rate": 0.5,
             "fault_seed": 1},
        engine={"max_batch": 2, "max_seq": 64, "prefill_chunk": 16},
        seed=0, prompts=_prompts(3, 20, 2), max_new=8, margin=INT4_MARGIN),
    # test_torch_prefix.py's budget of 9 Normal pages: copies on write
    # into Augmented pages; at 6 a cached prefix page is demoted too
    "pressure": _pressure_cell(9),
    "pressure_demote": _pressure_cell(6),
    # the slab store (test_obs.py's mamba2 case on the family the port
    # serves): recurrentgemma reduced, every slab Augmented (prompt seeds
    # 0-2 sit on near-ties: seed 3)
    "slab": dict(
        arch="recurrentgemma-9b", fresh=True,
        amc={"pool_mode": "always-augmented"},
        engine={"max_batch": 2, "max_seq": 32, "prefill_chunk": 8},
        seed=0, prompts=_prompts(3, 6, 3), max_new=6, margin=MIN_MARGIN),
    # test_torch_hybrid.py's augment-on-pressure cell: slabs augmented,
    # restamped and promoted
    "slab_pressure": dict(
        arch="recurrentgemma-9b", fresh=False,
        amc={"kv_mode": "int8", "pool_mode": "augment-on-pressure"},
        engine={"max_batch": 2, "max_seq": 48, "pool_budget_bytes": 6000},
        seed=0, prompts=_hybrid_prompts(), max_new=4, margin=MIN_MARGIN),
}
PARAM_KEYS = sorted({(c["arch"], c["seed"]) for c in CELLS.values()})


def _cell_cfg(get_arch, AMCConfig, cell, **extra):
    """The cell's config in either package, tracing and metrics on."""
    import dataclasses
    cfg = get_arch(cell["arch"]).reduced()
    amc = AMCConfig() if cell["fresh"] else cfg.amc
    fields = {"trace": True, "metrics": True, **cell["amc"], **extra}
    return dataclasses.replace(cfg, amc=dataclasses.replace(amc, **fields))


def _obs_record(eng):
    """What the comparison reads off an engine, as JSON."""
    import json
    m = eng.obs.metrics
    st = eng.stats()
    rec = {
        "events": eng.obs.tracer.chrome_trace()["traceEvents"],
        "counters": dict(m.counters), "gauges": dict(m.gauges),
        "histograms": {k: {"counts": h.counts, "count": h.count,
                           "sum": h.sum, "min": h.min, "max": h.max}
                       for k, h in m.histograms.items()},
        "series": m.dump_timeseries(),
        "open_spans": eng.obs.tracer.open_spans(),
        "stats": {
            # straggler mitigations follow the steps' wall times
            "faults": {k: v for k, v in st["faults"].items()
                       if k != "straggler_mitigations"},
            "spec": {k: st["spec"][k] for k in (
                "spec_rounds", "accepted_tokens", "draft_dispatches",
                "verify_dispatches")},
            "prefix": {k: st["prefix"].get(k) for k in (
                "cow_events", "demotions", "hits", "misses")},
            "scalars": {k: st[k] for k in (
                "augment_events", "promote_events", "refreshes",
                "preemptions", "dispatches")},
            "mode_mix": list(eng.store.mode_mix()),
        },
    }
    return json.loads(json.dumps(rec))


def _jax_obs_cell(cell, params):
    """The JAX engine on `cell` under the counter clock: tokens, the
    smallest top-1/top-2 margin of any emitting dispatch (decode, draft,
    verify) and `_obs_record`. Runs by source in the child process."""
    import itertools
    import jax
    import numpy as np
    from jax.sharding import AxisType
    from repro.configs import get_arch
    from repro.configs.base import AMCConfig
    from repro.obs import make_engine_obs
    from repro.serve import Request, ServeEngine

    class RecordingEngine(ServeEngine):
        min_margin = float("inf")
        emitting = False

        def _step_all_decode(self):
            self.emitting = True
            try:
                return super()._step_all_decode()
            finally:
                self.emitting = False

        def _step_all_spec(self):
            self.emitting = True
            try:
                return super()._step_all_spec()
            finally:
                self.emitting = False

        def _dispatch(self, fn, batch):
            logits = super()._dispatch(fn, batch)
            # wait for every dispatch: the engine rewrites its numpy
            # buffers right after one, and on the CPU backend an
            # in-flight step may still read them
            jax.block_until_ready(logits)
            if self.emitting:
                mask = np.asarray(batch["write_mask"])
                lg = np.asarray(logits[..., :self.cfg.vocab], np.float32)
                lg = lg[:, -1][mask] if mask.ndim == 1 else lg[mask]
                if lg.size:
                    top = np.sort(lg, axis=-1)[:, -2:]
                    self.min_margin = min(self.min_margin, float(
                        (top[:, 1] - top[:, 0]).min()))
            return logits

    cfg = _cell_cfg(get_arch, AMCConfig, cell, kv_impl="dequant")
    tick = itertools.count()
    obs = make_engine_obs(cfg.amc, clock=lambda: next(tick) * 1e-3)
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    eng = RecordingEngine(cfg, mesh, params=params, obs=obs,
                          **cell["engine"])
    outs = eng.generate([Request(prompt=np.asarray(p, np.int32),
                                 max_new_tokens=cell["max_new"], id=i)
                         for i, p in enumerate(cell["prompts"])])
    return {"tokens": {str(k): [int(t) for t in v] for k, v in outs.items()},
            "min_margin": eng.min_margin, **_obs_record(eng)}


CHILD = """
import dataclasses, json, sys
import numpy as np
from jax.experimental.pallas import tpu as pltpu
pltpu.TPUCompilerParams = pltpu.CompilerParams
import jax
from repro.configs import get_arch
from repro.models import model as M
from repro.models.params import init_params
args = json.loads(sys.argv[1])
%s


def flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat(v, prefix + k + "/")
        else:
            yield prefix + k, v


params = {}
for arch, seed in args["params"]:
    cfg = get_arch(arch).reduced()
    dense = dataclasses.replace(cfg, amc=dataclasses.replace(
        cfg.amc, weight_mode="normal"))
    p = init_params(M.abstract_params(dense), jax.random.PRNGKey(seed))
    params[(arch, seed)] = p
    np.savez(args["dir"] + f"/{arch}-{seed}.npz", **{
        k: (np.asarray(v).view(np.uint16)
            if np.asarray(v).dtype.name == "bfloat16" else np.asarray(v))
        for k, v in flat(jax.tree.map(np.asarray, p))})
out = {name: _jax_obs_cell(cell, params[(cell["arch"], cell["seed"])])
       for name, cell in args["cells"].items()}
with open(args["dir"] + "/out.json", "w") as f:
    json.dump(out, f)
"""


@pytest.fixture(scope="module")
def jax_cells(tmp_path_factory):
    """Every JAX engine run of this module, and the weights they used
    (numpy, saved by the child), from one child process."""
    tmp = tmp_path_factory.mktemp("obs_oracle")
    src = "\n\n".join(inspect.getsource(f) for f in (
        _cell_cfg, _obs_record, _jax_obs_cell))
    args = {"dir": str(tmp), "cells": CELLS,
            "params": [list(k) for k in PARAM_KEYS]}
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join(
               [str(REPO / "src"), os.environ.get("PYTHONPATH", "")])}
    res = subprocess.run([sys.executable, "-c", CHILD % src,
                          json.dumps(args)], env=env, capture_output=True,
                         text=True, timeout=900)
    assert res.returncode == 0, (res.stdout + res.stderr)[-4000:]
    with open(tmp / "out.json") as f:
        out = json.load(f)
    params = {}
    for arch, seed in PARAM_KEYS:
        flat = np.load(tmp / f"{arch}-{seed}.npz")
        tree = {}
        for key in flat.files:
            node = tree
            *path, leaf = key.split("/")
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = flat[key]
        params[(arch, seed)] = tree
    return out, params


def _port_engine(cell, params, **extra):
    """The port's engine on `cell` under the counter clock (or with
    `trace` / `metrics` overridden through `extra`), run to the end."""
    cfg = _cell_cfg(get_arch, AMCConfig, cell, **extra)
    obs = None
    if cfg.amc.trace and cfg.amc.metrics:
        obs = tobs.make_engine_obs(cfg.amc, clock=_clock())
    eng = ServeEngine(cfg, device="cpu", obs=obs,
                      params=from_numpy_tree(params, CPU), **cell["engine"])
    outs = eng.generate([Request(prompt=np.asarray(p, np.int32),
                                 max_new_tokens=cell["max_new"], id=i)
                         for i, p in enumerate(cell["prompts"])])
    return eng, {str(k): [int(t) for t in v] for k, v in outs.items()}


@pytest.fixture(scope="module")
def port_cells(jax_cells):
    """The port's run of each cell, made once, on the JAX weights."""
    _, params = jax_cells
    cache = {}

    def get(name):
        if name not in cache:
            cell = CELLS[name]
            eng, toks = _port_engine(cell, params[(cell["arch"],
                                                   cell["seed"])])
            cache[name] = (eng, toks, _obs_record(eng))
        return cache[name]
    return get


def _diff(got: list, want: list) -> str:
    """The first differing trace event, for the failure message."""
    for i, (a, b) in enumerate(zip(got, want)):
        if a != b:
            return f"event {i}: port {a} != jax {b}"
    return f"lengths {len(got)} != {len(want)}"


@pytest.mark.parametrize("name", sorted(CELLS))
def test_engine_trace_and_metrics_match_jax(jax_cells, port_cells, name):
    """Event for event, the port's Chrome trace is the JAX engine's; so
    are its counters, gauges, histogram buckets (step_wall_s: the count
    only), sampled series, the stats the trace mirrors, and its tokens."""
    want = jax_cells[0][name]
    assert want["min_margin"] > CELLS[name]["margin"], \
        f"prompt set sits on an argmax near-tie ({want['min_margin']})"
    _, toks, got = port_cells(name)
    assert toks == want["tokens"]
    assert got["events"] == want["events"], _diff(got["events"],
                                                  want["events"])
    assert got["counters"] == want["counters"]
    assert got["gauges"] == want["gauges"]
    hist, hwant = dict(got["histograms"]), dict(want["histograms"])
    assert hist.pop("step_wall_s")["count"] \
        == hwant.pop("step_wall_s")["count"]
    assert hist == hwant
    assert got["series"] == want["series"]
    assert got["stats"] == want["stats"]
    assert got["open_spans"] == want["open_spans"] == 0


def _lanes(events):
    by_tid = {}
    for e in events:
        if e["ph"] != "M":
            by_tid.setdefault(e["tid"], []).append(e["name"])
    return by_tid


def test_preempted_request_keeps_one_lane(port_cells):
    """test_obs.py's request-id continuity, on the port: a preempted and
    resumed request's preempt instant, second queue span and second
    active span all lie on its own lane."""
    eng, toks, rec = port_cells("preempt")
    assert all(len(v) == 6 for v in toks.values())
    assert rec["stats"]["scalars"]["preemptions"] >= 1
    lanes = _lanes(rec["events"])
    preempted = [tid for tid, names in lanes.items()
                 if tid >= tobs.REQ_TRACK_BASE and "preempt" in names]
    assert preempted
    for tid in preempted:
        names = lanes[tid]
        assert names.count("queue") >= 2 and names.count("active") >= 2
        assert "completed" in names
    assert rec["counters"]["preempt_capacity"] \
        == rec["stats"]["scalars"]["preemptions"]


def test_fault_spec_lanes_agree_with_counters(port_cells, tmp_path):
    """test_obs.py's fault + speculative acceptance scenario on the port:
    the trace validates, carries the fault and speculative lanes, and its
    instants equal the engine's fault and speculative counters."""
    eng, toks, rec = port_cells("fault_spec")
    f = rec["stats"]["faults"]
    assert f["faults_injected"] > 0 and f["zero_silent_corruption"]
    path = str(tmp_path / "fault_trace.json")
    eng.export_trace(path)
    assert tobs.validate_chrome_trace_file(path) == []
    names = [e["name"] for e in rec["events"] if e["ph"] != "M"]
    assert "fault_pass" in names
    assert "spec_draft" in names and "spec_verify" in names
    assert names.count("inject") == f["faults_injected"]
    assert names.count("detect") == f["faults_detected"]
    assert names.count("heal_scrub") + names.count("heal_recompute") \
        == f["recovered"]
    c = rec["counters"]
    assert c["fault_inject"] == f["faults_injected"]
    assert c.get("store_augment", 0) == rec["stats"]["scalars"][
        "augment_events"]
    assert rec["histograms"]["accepted_per_round"]["count"] \
        == rec["stats"]["spec"]["spec_rounds"]
    assert c["tokens_emitted"] == sum(len(v) for v in toks.values())


def test_pressure_sharing_traces_copies_and_demotions(port_cells):
    """Under augment-on-pressure with sharing on, every copy on write and
    every demoted prefix page is a refresh-lane event and a counter."""
    eng, toks, rec = port_cells("pressure_demote")
    p = rec["stats"]["prefix"]
    c = rec["counters"]
    assert p["cow_events"] > 0 and p["demotions"] > 0
    assert c["store_cow"] == p["cow_events"]
    assert c["store_demote"] == p["demotions"]
    assert c["store_augment"] + c["store_demote"] \
        == rec["stats"]["scalars"]["augment_events"]
    assert (c["prefix_hit"], c["prefix_miss"]) == (p["hits"], p["misses"])
    refresh = [e["name"] for e in rec["events"]
               if e["ph"] == "i" and e["tid"] == tobs.REFRESH_TRACK]
    assert refresh.count("cow") == p["cow_events"]
    assert refresh.count("demote") == p["demotions"]


def test_slab_mode_mix_matches_reduction(port_cells):
    """test_obs.py's slab mode-mix case on the port: the O(1) counters
    equal describe()'s reduction and the Augmented series is sampled
    (its values equal the JAX engine's in the comparison above)."""
    eng, _, rec = port_cells("slab")
    pool = eng.stats()["pool"]
    assert eng.store.mode_mix() == (pool["slabs_live_normal"],
                                    pool["slabs_live_augmented"])
    assert eng.stats()["obs"]["timeseries"]["mode_augmented"][
        "n_samples"] >= 1
    assert any(v > 0 for _, v in rec["series"]["mode_augmented"])


def test_slab_store_events_agree_with_its_counters(port_cells):
    """Under augment-on-pressure every slab augmentation, promotion and
    restamp is a refresh-lane instant and a counter."""
    eng, _, rec = port_cells("slab_pressure")
    st, c = eng.stats(), rec["counters"]
    assert st["augment_events"] > 0
    assert c.get("store_augment", 0) == st["augment_events"]
    assert c.get("store_promote", 0) == st["promote_events"]
    assert c.get("store_promote", 0) + c.get("store_restamp", 0) \
        == st["refreshes"]
    refresh = [e["args"]["unit"] for e in rec["events"]
               if e["ph"] == "i" and e["tid"] == tobs.REFRESH_TRACK
               and e["name"] != "refresh_pass"]
    assert refresh and all(u.startswith("slab") for u in refresh)


# ---------------------------------------------------------------------------
# test_obs.py's other contracts, on the port alone
# ---------------------------------------------------------------------------

def test_trace_spans_closed_schema_valid_and_monotonic(port_cells,
                                                       tmp_path):
    eng, _, _ = port_cells("traced_run")
    assert eng.obs.tracer.open_spans() == 0
    path = str(tmp_path / "trace.json")
    eng.export_trace(path)
    assert tobs.validate_chrome_trace_file(path) == []
    with open(path) as f:
        obj = json.load(f)
    ts = [e["ts"] for e in obj["traceEvents"] if e["ph"] != "M"]
    assert ts == sorted(ts)


def test_trace_covers_request_lifecycle(port_cells):
    eng, toks, rec = port_cells("traced_run")
    for rid, out in toks.items():
        lane = [e for e in rec["events"] if e["ph"] != "M"
                and e["tid"] == tobs.REQ_TRACK_BASE + int(rid)]
        names = [e["name"] for e in lane]
        for n in ("enqueue", "queue", "active", "prefill_chunk",
                  "first_token", "completed"):
            assert n in names, (rid, n)
        done = [e for e in lane if e["name"] == "completed"]
        assert done[0]["args"]["tokens"] == len(out)


def test_ttft_metrics_agree_with_trace_within_one_bucket(port_cells):
    eng, _, rec = port_cells("traced_run")
    enq, first = {}, {}
    for e in rec["events"]:
        if e["ph"] == "i" and e["name"] == "enqueue":
            enq[e["tid"]] = e["ts"]
        elif e["ph"] == "i" and e["name"] == "first_token":
            first.setdefault(e["tid"], e["ts"])
    ref = tobs.LogHistogram()
    for t in enq:
        ref.observe((first[t] - enq[t]) * 1e-6)
    h = eng.stats()["obs"]["histograms"]["ttft_s"]
    assert h["count"] == len(enq)
    for p in (50, 90, 99):
        assert ref.within_one_bucket(ref.percentile(p), h[f"p{p}"])


def test_mode_mix_and_occupancy_timelines(port_cells):
    eng, _, rec = port_cells("traced_run")
    st = eng.stats()
    assert eng.store.mode_mix() == (st["pool"]["pages_live_normal"],
                                    st["pool"]["pages_live_augmented"])
    ts = st["obs"]["timeseries"]
    for key in ("mode_normal", "mode_augmented", "pool_occupancy",
                "queue_depth", "refresh_debt"):
        assert key in ts and ts[key]["n_samples"] >= 1, key
    full = rec["series"]
    assert all(v == 0 for _, v in full["mode_normal"])
    assert any(v > 0 for _, v in full["mode_augmented"])
    assert any(v > 0 for _, v in full["energy_kv_read_fj"])
    assert any(e["ph"] == "C" and e["name"] == "mode_mix"
               for e in rec["events"])


def test_engine_prometheus_export(port_cells, tmp_path):
    eng, toks, _ = port_cells("traced_run")
    path = str(tmp_path / "metrics.prom")
    text = eng.export_metrics(path)
    assert open(path).read() == text
    assert f"amc_requests_completed {len(toks)}" in text
    assert f"amc_tokens_emitted {sum(map(len, toks.values()))}" in text
    assert 'amc_ttft_s_bucket{le="+Inf"}' in text


def test_obs_adds_no_dispatch_and_changes_no_token(jax_cells, port_cells):
    """The same cell with observability off: the null facade, the same
    tokens, dispatches and store decisions."""
    eng_on, toks_on, rec = port_cells("fault_spec")
    cell = CELLS["fault_spec"]
    eng, toks = _port_engine(cell, jax_cells[1][(cell["arch"],
                                                 cell["seed"])],
                             trace=False, metrics=False)
    assert eng.obs is tobs.NULL_OBS
    assert toks == toks_on
    assert eng.dispatch_count == eng_on.dispatch_count
    st = eng.stats()
    assert st["faults"]["faults_injected"] \
        == rec["stats"]["faults"]["faults_injected"]
    assert st["augment_events"] == rec["stats"]["scalars"]["augment_events"]


def _small_engine(**amc):
    cfg = get_arch("qwen1.5-0.5b").reduced()
    cfg = dataclasses.replace(cfg, amc=AMCConfig(**amc))
    return ServeEngine(cfg, device="cpu", max_batch=2, max_seq=32,
                       prefill_chunk=8)


def _small_reqs(n, plen, max_new):
    return [Request(prompt=np.asarray(p, np.int32), max_new_tokens=max_new,
                    id=i) for i, p in enumerate(_prompts(n, plen, 0))]


def test_obs_off_by_default_and_null_exports_raise(tmp_path):
    eng = _small_engine(kv_mode="int4", pool_mode="always-augmented")
    assert isinstance(eng.obs, tobs.NullEngineObs)
    assert eng.scheduler.obs is eng.obs and eng.store._obs is None
    eng.generate(_small_reqs(2, 4, 4))
    assert eng.stats()["obs"] == {"enabled": False, "trace": False,
                                  "metrics": False}
    with pytest.raises(ValueError, match="disabled"):
        eng.export_trace(str(tmp_path / "nope.json"))
    with pytest.raises(ValueError, match="disabled"):
        eng.export_metrics(str(tmp_path / "nope.prom"))
    assert tobs.make_engine_obs(eng.cfg.amc) is eng.obs


@pytest.mark.parametrize("trace,metrics", [(False, True), (True, False)])
def test_single_plane_modes_serve_and_export(trace, metrics, tmp_path):
    eng = _small_engine(kv_mode="int8", trace=trace, metrics=metrics)
    eng.generate(_small_reqs(2, 4, 4))
    obs = eng.stats()["obs"]
    assert obs["enabled"] and obs["trace"] == trace \
        and obs["metrics"] == metrics
    if trace:
        eng.export_trace(str(tmp_path / "t.json"))
        assert tobs.validate_chrome_trace_file(str(tmp_path / "t.json")) \
            == []
    else:
        assert obs["trace_events"] == 0 and obs["open_spans"] == 0
    if metrics:
        assert "amc_requests_completed 2" in eng.export_metrics(
            str(tmp_path / "m.prom"))


@pytest.mark.parametrize("on", [False, True])
def test_stats_idempotent_with_and_without_obs(on):
    eng = _small_engine(kv_mode="int4", pool_mode="always-augmented",
                        trace=on, metrics=on)
    eng.generate(_small_reqs(3, 4, 6))
    first = eng.stats()
    for _ in range(3):
        assert eng.stats() == first


def test_step_times_surfaced_for_every_run():
    eng = _small_engine(kv_mode="int4", pool_mode="always-augmented")
    eng.generate(_small_reqs(2, 4, 6))
    st = eng.stats()["step_times"]
    assert st["n_steps"] == eng.step_idx >= 6
    assert 0 < st["min_s"] <= st["mean_s"] <= st["max_s"]
    # mitigations follow wall time (three steps past twice the running
    # mean), so a loaded host may count some: they are surfaced, not 0
    assert st["mitigations"] == len(eng.straggler.events) \
        == eng.stats()["faults"]["straggler_mitigations"]


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

CLI_ARGS = ["--arch", "qwen1.5-0.5b", "--reduced", "--requests", "5",
            "--prompt-len", "6", "--shared-prefix", "20",
            "--prefix-cache", "2", "--max-new", "5", "--max-batch", "2",
            "--max-seq", "48"]


def _cli(args, tmp_path, **env_extra):
    env = {**os.environ, **env_extra, "PYTHONPATH": os.pathsep.join(
        [str(REPO / "src"), os.environ.get("PYTHONPATH", "")])}
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                           *args], env=env, capture_output=True, text=True,
                          timeout=300, cwd=tmp_path)


def test_cli_serves_the_engine_tokens_and_writes_valid_files(tmp_path):
    trace, prom = tmp_path / "t.json", tmp_path / "m.prom"
    res = _cli(["--device", "cpu", *CLI_ARGS, "--trace-out", str(trace),
                "--metrics-out", str(prom)], tmp_path)
    assert res.returncode == 0, res.stdout + res.stderr
    lines = [ln for ln in res.stdout.splitlines()
             if ln.startswith("[serve] req ")]
    from repro_torch.launch import serve as cli
    cfg = get_arch("qwen1.5-0.5b").reduced()
    eng = ServeEngine(cfg, device="cpu", max_batch=2, max_seq=48,
                      prefix_cache=2)
    outs = eng.generate(cli.make_requests(cfg, n=5, prompt_len=6,
                                          shared_prefix=20, max_new=5))
    assert lines == [f"[serve] req {rid}: {outs[rid]}"
                     for rid in sorted(outs)]
    assert tobs.validate_chrome_trace_file(str(trace)) == []
    text = prom.read_text()
    assert "amc_requests_completed 5" in text and "amc_prefix_hit" in text
    assert "[serve] prefix_cache entries=2" in res.stdout
    assert "[serve] obs: ttft_p50=" in res.stdout


def test_cli_needs_the_card_or_an_explicit_cpu(tmp_path):
    res = _cli(CLI_ARGS, tmp_path, CUDA_VISIBLE_DEVICES="")
    assert res.returncode != 0
    assert "CUDA is not available" in res.stderr
    assert "[serve] req" not in res.stdout


@pytest.mark.parametrize("flags", [["--num-arrays", "2"],
                                   ["--placement", "affinity"]])
def test_cli_refuses_the_fleet_flags(flags, tmp_path):
    """(Name kept from before the fleet was ported, when these flags
    exited 2.) The fleet flags now serve: `--num-arrays 2` through an
    `ArrayFleet`, whose tokens equal one engine's, with the JAX
    launcher's fleet lines; `--placement` alone keeps one engine."""
    res = _cli(["--device", "cpu", *CLI_ARGS, *flags], tmp_path)
    assert res.returncode == 0, res.stdout + res.stderr
    lines = [ln for ln in res.stdout.splitlines()
             if ln.startswith("[serve] req ")]
    from repro_torch.launch import serve as cli
    cfg = get_arch("qwen1.5-0.5b").reduced()
    eng = ServeEngine(cfg, device="cpu", max_batch=2, max_seq=48,
                      prefix_cache=2)
    outs = eng.generate(cli.make_requests(cfg, n=5, prompt_len=6,
                                          shared_prefix=20, max_new=5))
    assert lines == [f"[serve] req {rid}: {outs[rid]}"
                     for rid in sorted(outs)]
    fleet = "--num-arrays" in flags
    assert ("[serve] fleet arrays=2 placement=least-loaded" in res.stdout) \
        == fleet
    assert ("[serve]   array 1: alive=True" in res.stdout) == fleet
