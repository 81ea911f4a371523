"""Retention faults and self-healing in the port (`core/faults.py`, the
paged pool's integrity words, corruption and scrub, the engine's inject
-> detect -> heal pass, `distributed/fault.py`) against the JAX package,
at the reduced qwen1.5-0.5b config.

- `FaultModel` (a numpy-only module, copied) draws exactly what JAX's
  draws over a grid of (unit, step, age, temperature).
- The pool's integrity word, computed on the device (here the CPU),
  equals `repro.core.faults.integrity_word` of the same bytes, and a
  flip of any one byte changes it.
- The chaos run of `tests/test_faults.py` (`_CHAOS["qwen1.5-0.5b"]`:
  int4 always-augmented, 3 prompts of 20 tokens, 8 new, retention 8,
  rate 0.5, fault seed 1; prompt seed 2, see PSEED), also with no retries
  and with a pin threshold of 1, gives the JAX engine's tokens, failed requests and fault
  counters exactly: unit ids are physical pages, allocated in the JAX
  order, so both draw the same schedule.
- The port's own invariants: chaos tokens equal fault-free tokens, retry
  exhaustion fails a request, a repeat offender is decommissioned, an
  array loss keeps the tokens and drops the prefix index, share-band
  pages heal from their masters, integrity off forfeits detection, and
  rate 0 is inert.

Tokens are compared exactly, on prompts whose JAX top-1/top-2 margin
exceeds MIN_MARGIN at every decode step (checked). JAX's int4 pack
reaches only its Pallas call, so the JAX engines run in a CHILD process
that aliases `pltpu.TPUCompilerParams` to `pltpu.CompilerParams` before
it imports `repro` (as tests/test_torch_serve.py does), never here.
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
from repro.core import faults as JF
from repro.models import model as jm
from repro.models.params import init_params as jax_init_params
from repro_torch.configs import get_arch
from repro_torch.configs.base import AMCConfig
from repro_torch.core import faults as TF
from repro_torch.models.params import from_numpy_tree
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve.cache_pool import PagedKVPool, _corrupt_page_op

CPU = torch.device("cpu")
REPO = Path(__file__).resolve().parents[1]
MIN_MARGIN = 1e-2
# tests/test_faults.py's qwen chaos cell: (plen, max_new, retention, rate),
# 3 requests on 2 rows, max_seq 64, chunk 16, fault seed 1. Its prompt
# seed 0 puts two of the JAX logits on an exact bf16 tie (margin 0.0),
# where no cross-framework token comparison means anything; prompt seed 2
# keeps every decode step's margin >= 0.031 in all four JAX runs.
PLEN, MAX_NEW, RETENTION, RATE, PSEED = 20, 8, 8, 0.5, 2
ENGINE = {"max_batch": 2, "max_seq": 64, "prefill_chunk": 16,
          "retention_steps": RETENTION}
VARIANTS = {"chaos": {}, "no-retries": {"max_retries": 0},
            "pin-1": {"fault_pin_threshold": 1}}
FAULT_KEYS = ("faults_injected", "faults_detected", "faults_masked",
              "refresh_misses", "integrity_checks", "pinned_normal",
              "pages_decommissioned", "recovered_scrub",
              "recovered_recompute", "retried", "uncorrectable",
              "faults_pending", "failed_requests", "zero_silent_corruption")


def prompts(n=3, plen=PLEN, seed=PSEED):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, size=(plen,)).astype(np.int32)
            for _ in range(n)]


# ---------------------------------------------------------------------------
# FaultModel and the integrity word
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rate,seed,temp", [(0.3, 7, 85.0), (0.05, 1, 25.0),
                                            (1.0, 3, 105.0)])
def test_fault_model_draws_equal_jax(rate, seed, temp):
    fms = [m.FaultModel(rate=rate, seed=seed, temp_c=temp,
                        array_loss_rate=rate / 4) for m in (JF, TF)]
    fm_j, fm_t = fms
    assert fm_j.temp_scale() == fm_t.temp_scale()
    draws = 0
    for u in range(12):
        for s in range(12):
            for age in (0, 1, 4, 8, 9):
                assert fm_j.p_fault(age, 8) == fm_t.p_fault(age, 8)
                hit = fm_j.fault(f"pg{u}", s, age, 8)
                assert hit == fm_t.fault(f"pg{u}", s, age, 8)
                draws += hit
            assert fm_j.refresh_miss(f"pg{u}", s) == \
                fm_t.refresh_miss(f"pg{u}", s)
            assert fm_j.corruption_mask(f"pg{u}", s) == \
                fm_t.corruption_mask(f"pg{u}", s)
        assert fm_j.array_loss(u) == fm_t.array_loss(u)
    assert draws > 0


def _packed_pool(aug_bits: int, seed: int) -> PagedKVPool:
    """A reduced always-augmented pool: 4 pages of random packed bytes and
    scales, admitted to rows 0 and 1."""
    cfg = get_arch("qwen1.5-0.5b").reduced()
    cfg = dataclasses.replace(cfg, amc=AMCConfig(
        kv_mode=f"int{aug_bits}", pool_mode="always-augmented"))
    p = PagedKVPool(cfg, max_batch=2, max_seq=64, device=CPU)
    g = torch.Generator().manual_seed(seed)
    for k in ("kp", "vp"):
        p.arenas[k].copy_(torch.randint(0, 256, p.arenas[k].shape,
                                        generator=g).to(torch.uint8).view(
            p.arenas[k].dtype))
    for k in ("ks", "vs"):
        p.arenas[k].copy_(torch.rand(p.arenas[k].shape, generator=g))
    assert p.admit_row(0, 30, 0) and p.admit_row(1, 20, 0)
    return p


def _numpy_word(p: PagedKVPool, key) -> int:
    phys = int(p.page_table[key])
    return JF.integrity_word(*(
        (p.arenas[k][:, phys].view(torch.int16)
         if p.arenas[k].dtype == torch.bfloat16
         else p.arenas[k][:, phys]).numpy() for k in ("kp", "vp", "ks", "vs")))


@pytest.mark.parametrize("aug_bits", [4, 8])
def test_device_integrity_word_equals_jax(aug_bits):
    p = _packed_pool(aug_bits, aug_bits)
    keys = sorted(p.policies)
    assert len(keys) == 4
    words = p._page_words(keys)
    assert words == [_numpy_word(p, k) for k in keys]
    assert len(set(words)) == len(words)
    # any one flipped byte changes the word, and the device word still
    # equals the numpy word of the flipped bytes
    key, phys = keys[1], int(p.page_table[keys[1]])
    for plane, flat in (("kp", 0), ("kp", 777), ("vp", 1500), ("ks", 3),
                        ("vs", 200)):
        view = p.arenas[plane][:, phys].contiguous().view(torch.uint8)
        before = p._page_words([key])[0]
        b = view.reshape(-1)
        b[flat] ^= 0x5A
        p.arenas[plane][:, phys] = b.reshape(view.shape).view(
            p.arenas[plane].dtype)
        after = p._page_words([key])[0]
        assert after != before, (plane, flat)
        assert after == _numpy_word(p, key)


@pytest.mark.parametrize("pages_a_chunk", [1, 3])
def test_device_integrity_words_by_chunks(monkeypatch, pages_a_chunk):
    """Summed a bounded number of pages at a time (WORD_CHUNK_BYTES), the
    words are the numpy words still: one page a chunk, and 3 pages a
    chunk over 4 keys (a short last chunk)."""
    from repro_torch.serve import cache_pool as CP
    p = _packed_pool(4, 11)
    keys = sorted(p.policies)
    page_bytes = sum(p.arenas[k][:, 0].numel() * p.arenas[k].element_size()
                     for k in ("kp", "vp", "ks", "vs"))
    monkeypatch.setattr(CP, "WORD_CHUNK_BYTES",
                        pages_a_chunk * page_bytes + page_bytes - 1)
    assert p._page_words(keys) == [_numpy_word(p, k) for k in keys]


def test_corrupt_page_op_flips_only_its_page():
    p = _packed_pool(4, 0)
    before = {k: v.clone() for k, v in p.arenas.items()}
    phys = int(p.page_table[0, 1])
    _corrupt_page_op(p.arenas, phys, 0x81)
    for k in ("kp", "vp"):
        diff = (p.arenas[k] != before[k]).nonzero()[:, 1].unique()
        assert diff.tolist() == [phys]
        assert torch.equal(p.arenas[k][:, phys] ^ 0x81, before[k][:, phys])
    for k in ("ks", "vs", "kn", "vn"):
        assert torch.equal(p.arenas[k], before[k])


# ---------------------------------------------------------------------------
# the chaos cell against the JAX engine
# ---------------------------------------------------------------------------

def _jax_chaos(params, engine: dict, variants: dict, ps: list,
               keys: list) -> dict:
    """The JAX engine, int4 always-augmented on its reference paths:
    golden (no faults) and every variant's chaos run. Runs by source in
    the child process."""
    import dataclasses
    import jax
    import numpy as np
    from jax.sharding import AxisType
    from repro.configs import get_arch
    from repro.configs.base import AMCConfig
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
                    self.min_margin = min(self.min_margin, float(
                        (top[:, 1] - top[:, 0]).min()))
            return logits

    cfg = dataclasses.replace(get_arch("qwen1.5-0.5b").reduced(),
                              amc=AMCConfig(pool_mode="always-augmented",
                                            kv_mode="int4",
                                            kv_impl="dequant",
                                            matmul_impl="dense"))
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    out = {}
    for name, kw in [("golden", None)] + sorted(variants.items()):
        extra = {} if kw is None else {"fault_rate": 0.5, "fault_seed": 1,
                                       **kw}
        eng = RecordingEngine(cfg, mesh, params=params, **engine, **extra)
        toks = eng.generate([Request(prompt=np.asarray(p, np.int32),
                                     max_new_tokens=8, id=i)
                             for i, p in enumerate(ps)])
        fl = eng.stats()["faults"]
        out[name] = {
            "tokens": {str(k): [int(t) for t in v] for k, v in toks.items()},
            "failed": {str(k): [int(t) for t in v]
                       for k, v in eng.failed.items()},
            "faults": {k: (bool(v) if isinstance(v, (bool, np.bool_))
                           else int(v)) for k, v in fl.items()
                       if k in keys},
            "min_margin": eng.min_margin}
    return out


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
out = _jax_chaos(params, args["engine"], args["variants"], args["prompts"],
                 args["keys"])
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
    cfg = jax_get_arch("qwen1.5-0.5b").reduced()
    return jax_init_params(jm.abstract_params(dataclasses.replace(
        cfg, amc=dataclasses.replace(cfg.amc, weight_mode="normal"))),
        jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def torch_params(dense_params):
    return from_numpy_tree(jax.tree.map(np.asarray, dense_params), CPU)


@pytest.fixture(scope="module")
def jax_chaos(dense_params, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("faults")
    np.savez(tmp / "params.npz", **{
        k: (np.asarray(v).view(np.uint16)
            if np.asarray(v).dtype.name == "bfloat16" else np.asarray(v))
        for k, v in _flatten(jax.tree.map(np.asarray, dense_params))})
    args = {"params": str(tmp / "params.npz"), "out": str(tmp / "out.json"),
            "engine": ENGINE, "variants": VARIANTS,
            "prompts": [p.tolist() for p in prompts()],
            "keys": list(FAULT_KEYS)}
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join(
               [str(REPO / "src"), os.environ.get("PYTHONPATH", "")])}
    res = subprocess.run(
        [sys.executable, "-c", CHILD % inspect.getsource(_jax_chaos),
         json.dumps(args)], env=env, capture_output=True, text=True,
        timeout=900)
    assert res.returncode == 0, (res.stdout + res.stderr)[-4000:]
    with open(tmp / "out.json") as f:
        return json.load(f)


def _cfg():
    return dataclasses.replace(get_arch("qwen1.5-0.5b").reduced(),
                               amc=AMCConfig(pool_mode="always-augmented",
                                             kv_mode="int4"))


def _serve(params, ps=None, max_new=MAX_NEW, **kw):
    eng = ServeEngine(_cfg(), device="cpu", params=params, **{**ENGINE, **kw})
    out = eng.generate([Request(prompt=p, max_new_tokens=max_new, id=i)
                        for i, p in enumerate(prompts() if ps is None
                                              else ps)])
    return eng, {str(k): list(map(int, v)) for k, v in out.items()}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_chaos_matches_jax(jax_chaos, torch_params, variant):
    want = jax_chaos[variant]
    for run in ("golden", variant):
        assert jax_chaos[run]["min_margin"] > MIN_MARGIN, \
            f"prompt set sits on an argmax near-tie ({run})"
    eng, toks = _serve(torch_params, fault_rate=RATE, fault_seed=1,
                       **VARIANTS[variant])
    fl = eng.stats()["faults"]
    assert fl["faults_injected"] > 0
    assert toks == want["tokens"]
    assert {str(k): v for k, v in eng.failed.items()} == want["failed"]
    assert {k: fl[k] for k in FAULT_KEYS} == want["faults"]


def test_golden_matches_jax(jax_chaos, torch_params):
    eng, toks = _serve(torch_params)
    assert toks == jax_chaos["golden"]["tokens"]
    assert not eng.stats()["faults"]["enabled"]


def test_chaos_equals_golden(torch_params):
    _, golden = _serve(torch_params)
    eng, toks = _serve(torch_params, fault_rate=RATE, fault_seed=1)
    fl = eng.stats()["faults"]
    assert fl["faults_injected"] > 0 and fl["recovered_recompute"] > 0
    assert fl["zero_silent_corruption"] and not eng.failed
    assert toks == golden
    # each detected page is billed to the ledger's "recovery" group as
    # refresh traffic of one packed page (4 cell restores a byte)
    rec = eng.stats()["imc"]["groups"]["recovery"]
    assert rec["events"] == {"refresh_cell": 4 * eng.store.geom.page_bytes_aug
                             * fl["faults_detected"]}
    assert fl["recovery_energy_fj"] == rec["energy_fj"] > 0


@pytest.mark.parametrize("seed", range(5))
def test_every_fault_detected_or_masked(torch_params, seed):
    eng, _ = _serve(torch_params, fault_rate=RATE, fault_seed=seed)
    fl = eng.stats()["faults"]
    assert fl["faults_injected"] > 0
    assert fl["faults_injected"] == (fl["faults_detected"]
                                     + fl["faults_masked"])
    assert fl["faults_pending"] == 0 and fl["zero_silent_corruption"]


def test_retry_exhaustion_fails_the_request(torch_params):
    eng, toks = _serve(torch_params, fault_rate=RATE, fault_seed=1,
                       max_retries=0)
    fl = eng.stats()["faults"]
    assert fl["uncorrectable"] > 0 and eng.failed
    assert fl["zero_silent_corruption"]
    assert set(toks) | {str(k) for k in eng.failed} == {"0", "1", "2"}
    assert not set(toks) & {str(k) for k in eng.failed}


def test_repeat_offender_decommissioned(torch_params):
    eng, toks = _serve(torch_params, fault_rate=RATE, fault_seed=1,
                       fault_pin_threshold=1)
    fl = eng.stats()["faults"]
    assert fl["faults_detected"] > 0
    assert fl["pages_decommissioned"] > 0
    assert eng.store.pages_packed < 2 * eng.store.max_pages
    assert fl["zero_silent_corruption"]
    assert all(len(v) == MAX_NEW for v in toks.values())


def _shared_prompts():
    """Three prompts on one 2-page system prompt (page 16)."""
    rng = np.random.default_rng(5)
    sys_p = rng.integers(0, 512, size=(32,)).astype(np.int32)
    return [np.concatenate([sys_p, rng.integers(0, 512, size=(n,)).astype(
        np.int32)]) for n in (3, 6, 9)]


def test_array_loss_keeps_tokens_and_drops_the_index(torch_params):
    ps = _shared_prompts()
    _, golden = _serve(torch_params, ps=ps, max_new=6, prefix_cache=2)
    eng = ServeEngine(_cfg(), device="cpu", params=torch_params,
                      prefix_cache=2, **ENGINE)
    for i, p in enumerate(ps):
        eng.add_request(Request(prompt=p, max_new_tokens=6, id=i))
    eng.step_all()
    eng.step_all()
    assert eng.stats()["prefix"]["entries"] == 1
    eng.inject_array_loss()
    while eng.active.any() or eng.scheduler.queue:
        eng.step_all()
    st = eng.stats()
    fl = st["faults"]
    assert fl["array_losses"] == 1 and fl["supervisor_restarts"] == 1
    assert fl["array_loss_requeues"] > 0
    assert st["prefix"]["invalidated"] == 1
    assert {str(k): list(map(int, v)) for k, v in eng.outputs.items()} \
        == golden


def test_share_band_pages_heal_from_masters(torch_params):
    """Entry pages of the share band carry host masters: a corrupted one
    is scrubbed in place, and the tokens stay the fault-free ones."""
    ps = _shared_prompts()
    _, golden = _serve(torch_params, ps=ps, max_new=6, prefix_cache=2)
    eng, toks = _serve(torch_params, ps=ps, max_new=6, prefix_cache=2,
                       fault_rate=1.0, fault_seed=2, retention_steps=4,
                       max_retries=8)
    fl = eng.stats()["faults"]
    assert fl["recovered_scrub"] > 0, fl
    assert fl["zero_silent_corruption"] and not eng.failed
    assert toks == golden


def test_integrity_off_forfeits_detection(torch_params):
    eng, _ = _serve(torch_params, fault_rate=RATE, fault_seed=1,
                    integrity_check=False)
    fl = eng.stats()["faults"]
    assert fl["faults_injected"] > 0 and fl["faults_detected"] == 0
    assert not fl["zero_silent_corruption"]


def test_rate_zero_is_inert(torch_params):
    eng, _ = _serve(torch_params)
    fl = eng.stats()["faults"]
    assert not fl["enabled"] and eng.store._fm is None
    assert fl["faults_injected"] == fl["integrity_checks"] == 0
    assert fl["zero_silent_corruption"]
    assert not eng.store._words and not eng.store._dirty
    assert eng.scheduler.stats["fault_passes"] == 0


def test_backoff_ticks_the_clock(torch_params):
    """While every queued entry backs off after a fault retry, generate
    ticks the step clock instead of raising."""
    eng = ServeEngine(_cfg(), device="cpu", params=torch_params, **ENGINE)
    eng.add_request(Request(prompt=prompts()[0], max_new_tokens=2, id=0))
    eng.step_all()
    eng._heal_row_recompute(0)          # what a detected fault does
    entry = eng.scheduler.queue[0]
    assert entry.fault_retries == 1 and entry.not_before > eng.step_idx
    assert not eng.scheduler.backlog_ready(eng.step_idx)
    out = eng.generate([])
    assert len(out[0]) == 2 and eng.step_idx > entry.not_before
