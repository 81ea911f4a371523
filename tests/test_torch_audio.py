"""The audio family (whisper-tiny) in the port, held against the JAX
package at the reduced config (2 decoder layers, d_model 128, 4 heads of
32, 16 encoder frames, vocab 512) on JAX's seed-0 weights: the config
and parameter tree, the paged pool's static prefix band (tables, byte
counts, admission, release, zeroing, masters, the fault-row map), the
cross read over a filled band, the decode step, the engine's tokens at
spec_k 1 and 4, the band's refresh accounting, the scrub-from-master
cell and the energy branch.

The pool and energy checks run the JAX package in this process (int8
and int4 pools reach no Pallas call there). Every numeric JAX run (the
cross read, the decode step, the engines) happens in ONE child process,
started first: its int4 pool packs through a Pallas kernel, so it aliases
`pltpu.TPUCompilerParams` to `pltpu.CompilerParams` before it imports
`repro` (as tests/test_torch_serve.py does), and it runs XLA with
`--xla_allow_excess_precision=false`. XLA's CPU compiler otherwise drops
the bf16 rounding of a sum that feeds an explicit float32 convert (the
residual sum into the RMS norm), while the JAX code, run op by op, and
the port round it; with the flag the compiled JAX step rounds every op
as its source is written.

Tolerances: config fields, parameter paths and shapes, page tables,
modes, byte counts, counters, arena bytes, masters and integrity words,
energy events exact; the cross read through the kernel route's plain
version within rel_err 0.03 of the JAX reference on rows of length > 0
(the port's attention tolerance) and finite on the idle row of length
0, the dequant route equal to the JAX reference within one bf16 ulp of
its largest magnitude, length-0 row included; decode-step logits within
one bf16 ulp of the largest logit; engine tokens, fault counters and
refresh traffic exact on the JAX tests' own prompt seeds.
"""
import dataclasses
import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.core import faults as jfaults
from repro.imc import energy as jenergy
from repro.models import model as jm
from repro.models.params import init_params as jax_init_params
from repro.models.params import is_pspec
from repro.serve import state_store as jstore
from repro.serve.cache_pool import PagedKVPool as JaxPool
from repro_torch.configs import get_arch
from repro_torch.configs.base import AMCConfig
from repro_torch.core import faults as tfaults
from repro_torch.imc import energy
from repro_torch.models import augment
from repro_torch.models import encdec
from repro_torch.models import model as tm
from repro_torch.models.params import (abstract_params, from_numpy_tree,
                                       init_params)
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve import state_store as tstore
from repro_torch.serve.cache_pool import PagedKVPool

CPU = torch.device("cpu")
REPO = Path(__file__).resolve().parents[1]
ARCH = "whisper-tiny"
TORCH_DTYPE = {np.dtype(np.uint8): torch.uint8, np.dtype(np.int8): torch.int8,
               np.dtype(jnp.bfloat16): torch.bfloat16,
               np.dtype(np.float32): torch.float32}


def as_np(x) -> np.ndarray:
    """A JAX or torch array as numpy, bf16 widened to float32."""
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


def ulp_bf16(x) -> float:
    """One bf16 ulp at |x| (8 significant bits)."""
    return float(2.0 ** (np.floor(np.log2(max(abs(float(x)), 2.0 ** -126)))
                         - 7))


def keyed(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(keyed(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


# ---------------------------------------------------------------------------
# config, parameter tree, energy branch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("full", [True, False])
def test_config_matches_jax(full):
    """Field for field, the AMC knobs the port carries included."""
    j, t = jax_get_arch(ARCH), get_arch(ARCH)
    if not full:
        j, t = j.reduced(), t.reduced()
    for f in dataclasses.fields(t):
        if f.name != "amc":
            assert getattr(t, f.name) == getattr(j, f.name) or (
                dataclasses.asdict(t)[f.name]
                == dataclasses.asdict(j)[f.name]), f.name
    for f in dataclasses.fields(t.amc):
        assert getattr(t.amc, f.name) == getattr(j.amc, f.name), f.name
    assert t.hd == j.hd
    assert t.vocab_padded == j.vocab_padded
    if full:
        assert (t.n_layers, t.d_model, t.n_heads, t.hd, t.vocab,
                t.encdec.n_frames) == (4, 384, 6, 64, 51865, 1500)


def test_params_declare_the_jax_tree():
    """Every leaf path, shape and init of JAX's encoder-decoder tree; the
    weights stay dense whatever weight_mode says (as in JAX)."""
    cfg, tcfg = jax_get_arch(ARCH).reduced(), get_arch(ARCH).reduced()
    jspec = {"/".join(str(getattr(k, "key", k)) for k in p): s
             for p, s in jax.tree_util.tree_flatten_with_path(
                 jm.abstract_params(cfg), is_leaf=is_pspec)[0]}
    tspec = keyed(abstract_params(tcfg))
    assert sorted(tspec) == sorted(jspec)
    for k, s in jspec.items():
        assert tspec[k].shape == s.shape and tspec[k].init == s.init, k
    params = init_params(tcfg, seed=0, device="cpu")
    assert augment.augment_params(tcfg, params) is params
    assert tcfg.amc.weight_mode == "ternary"


@pytest.mark.parametrize("full", [True, False])
def test_energy_branch_matches_jax(full):
    j, t = jax_get_arch(ARCH), get_arch(ARCH)
    if not full:
        j, t = j.reduced(), t.reduced()
    assert energy.model_decode_matmuls(t) == jenergy.model_decode_matmuls(j)
    for impl in ("dense", "packed", "imc"):
        tc = dataclasses.replace(t, amc=dataclasses.replace(
            t.amc, matmul_impl=impl))
        jc = dataclasses.replace(j, amc=dataclasses.replace(
            j.amc, matmul_impl=impl))
        for n in (1, 4, 37):
            assert energy.decode_matmul_events(tc, n) \
                == jenergy.decode_matmul_events(jc, n), impl


def test_store_registry_gives_a_paged_pool_with_a_band():
    """tests/test_state_store.py:284-300's audio row."""
    cfg = get_arch(ARCH).reduced()
    store = tstore.make_store(cfg, max_batch=2, max_seq=32, device=CPU)
    jstore_ = jstore.make_store(jax_get_arch(ARCH).reduced(), max_batch=2,
                                max_seq=32)
    assert store.kind == jstore_.kind == "paged"
    assert store.prefix_pages == jstore_.prefix_pages > 0
    assert store.prefix_tokens == cfg.encdec.n_frames
    assert store.budget_bytes == jstore_.budget_bytes > 0
    assert store.live_bytes == 0
    steps = tstore.make_step_fns(cfg)
    assert steps["prefill"] is None and steps["verify"] is None
    # the engine's logical cache: every row at max_seq in bf16
    normal = dict(kv_mode="normal")
    logical = tm.abstract_cache(dataclasses.replace(
        cfg, amc=dataclasses.replace(cfg.amc, **normal)), 2, 32)
    jcfg = jax_get_arch(ARCH).reduced()
    assert {k: v.shape for k, v in logical.items()} == {
        k: v.shape for k, v in jm.abstract_cache(dataclasses.replace(
            jcfg, amc=dataclasses.replace(jcfg.amc, **normal)),
            jax_shape(2, 32)).items()}


def jax_shape(batch, seq):
    from repro.configs.base import ShapeConfig
    return ShapeConfig("serve", seq, batch, "decode")


# ---------------------------------------------------------------------------
# the static prefix band, scripted through both pools
# ---------------------------------------------------------------------------

def pool_pair(pool_mode, kv_mode, prefix_tokens, budget_pages=None, B=3,
              max_seq=32):
    j, t = jax_get_arch(ARCH).reduced(), get_arch(ARCH).reduced()
    amc = dict(pool_mode=pool_mode, kv_mode=kv_mode, retention_steps=3)
    j = dataclasses.replace(j, amc=dataclasses.replace(j.amc, **amc))
    t = dataclasses.replace(t, amc=dataclasses.replace(t.amc, **amc))
    kw = dict(max_batch=B, max_seq=max_seq, prefix_tokens=prefix_tokens)
    jp = JaxPool(j, **kw)
    if budget_pages is not None:
        kw["budget_bytes"] = budget_pages * jp.geom.page_bytes_normal
        jp = JaxPool(j, **kw)
    return jp, PagedKVPool(t, device=CPU, **kw)


def fill_arenas(jp, tp, seed):
    """The same random bytes in every page of both pools' arenas."""
    rng = np.random.default_rng(seed)
    new = {}
    for k, v in jp.arenas.items():
        dt = np.dtype(v.dtype)
        if dt == np.uint8:
            a = rng.integers(0, 256, v.shape).astype(np.uint8)
        elif dt == np.int8:
            a = rng.integers(-127, 128, v.shape).astype(np.int8)
        else:
            a = (rng.standard_normal(v.shape) * 0.1).astype(jnp.bfloat16)
        new[k] = a
    jp.arenas = {k: jnp.asarray(a) for k, a in new.items()}
    for k, a in new.items():
        if a.dtype == jnp.bfloat16:
            t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a.copy())
        tp.arenas[k].copy_(t)


def assert_pools_equal(jp, tp, where):
    for f in ("page_table", "page_mode", "allocated", "last_write"):
        np.testing.assert_array_equal(getattr(tp, f), getattr(jp, f),
                                      err_msg=f"{where}: {f}")
    assert tp.live_bytes == jp.live_bytes, where
    assert tp.free_normal == jp.free_normal, where
    assert tp.free_packed == jp.free_packed, where
    assert sorted(tp.policies) == sorted(jp.policies), where
    assert tp.stats == jp.stats, where
    jd = jp.describe()
    td = tp.describe()
    assert td == {k: jd[k] for k in td}, where
    jt, tt = jp.device_tables(), tp.device_tables()
    names = ["page_table", "page_modes"]
    if jp.prefix_pages:
        names += ["cross_table", "cross_modes", "cross_lengths"]
    for k in names:
        np.testing.assert_array_equal(tt[k].numpy(), np.asarray(jt[k]),
                                      err_msg=f"{where}: {k}")
    B = jp.max_batch
    rows = np.arange(B)
    lengths = np.array([5, 17, 32][:B])
    assert tp.read_value_counts(rows, lengths) \
        == jp.read_value_counts(rows, lengths), where
    assert tp.write_value_counts(rows, 1, lengths - 1) \
        == jp.write_value_counts(rows, 1, lengths - 1), where
    for n in (1, 9, 30):
        assert tp.can_admit_tokens(n) == jp.can_admit_tokens(n), (where, n)
    assert tp.max_row_tokens() == jp.max_row_tokens(), where
    assert tp.physical_bytes() == jp.physical_bytes(), where
    for k, v in jp.arenas.items():
        np.testing.assert_array_equal(as_np(tp.arenas[k]), as_np(v),
                                      err_msg=f"{where}: arena {k}")


@pytest.mark.parametrize("pool_mode,kv_mode,prefix_tokens,budget_pages", [
    ("normal-only", "int8", 16, None),
    ("always-augmented", "int4", 40, None),    # the band wider than maxP
    ("always-augmented", "int8", 16, None),
    ("augment-on-pressure", "int8", 40, 11),   # band pages augment first
])
def test_prefix_band_matches_jax(pool_mode, kv_mode, prefix_tokens,
                                 budget_pages):
    """A scripted sequence through both pools: admissions (recycled
    pages: the band zeroed over stale bytes), decode growth, a failed
    all-or-nothing admission, releases, refreshes, augmentation under
    pressure. After every op the tables (both bands, each at its width),
    modes, free lists, policies, counters, describe(), the device tables
    (cross_lengths 0 on idle slots), read / write value counts, admission
    probes and every arena byte equal the JAX pool's."""
    jp, tp = pool_pair(pool_mode, kv_mode, prefix_tokens, budget_pages)
    assert tp.table_width == jp.table_width == max(2, -(-prefix_tokens
                                                        // 16))
    fill_arenas(jp, tp, 0)
    assert_pools_equal(jp, tp, "empty")
    script = [("admit", 0, 9), ("admit", 1, 17), ("grow", 0, 16),
              ("admit", 2, 30), ("writes", 1), ("refresh", 3),
              ("release", 0), ("admit", 0, 3), ("grow", 1, 20),
              ("refresh", 6), ("release", 1), ("release", 2),
              ("admit", 1, 31), ("admit", 2, 1), ("refresh", 9),
              ("release", 0), ("release", 1), ("release", 2)]
    for i, op in enumerate(script):
        step = i
        if op[0] == "admit":
            got = tp.admit_row(op[1], op[2], step)
            want = jp.admit_row(op[1], op[2], step)
            assert got == want, (i, op)
        elif op[0] == "grow":
            assert tp.ensure_position(op[1], op[2], step) \
                == jp.ensure_position(op[1], op[2], step), (i, op)
        elif op[0] == "writes":
            for p in (tp, jp):
                p.note_token_writes(np.array([op[1]]), np.array([3]), step)
        elif op[0] == "refresh":
            due = jp.refresh_due(op[1])
            assert tp.refresh_due(op[1]) == due, (i, op)
            for key in due:
                jp.refresh(key, op[1])
                tp.refresh(key, op[1])
        else:
            jp.release_row(op[1])
            tp.release_row(op[1])
        assert_pools_equal(jp, tp, f"op {i} {op}")
    assert tp.live_bytes == 0
    if pool_mode == "augment-on-pressure":
        assert tp.stats["augment_events"] > 0


@pytest.mark.parametrize("kv_mode", ["int8", "int4"])
def test_prefix_band_masters_and_fault_rows_match_jax(kv_mode):
    """With a fault model attached, the integrity flush keeps a host
    master of every Augmented page of the prefix band (as of the share
    band), none of the decode band; words and master bytes equal JAX's;
    a scrub restores the master bytes; a prefix-band fault maps back to
    its slot."""
    jp, tp = pool_pair("always-augmented", kv_mode, 40)
    for p in (jp, tp):
        assert p.admit_row(0, 9, 0) and p.admit_row(2, 20, 0)
    fill_arenas(jp, tp, 1)
    jp.attach_fault_model(jfaults.FaultModel(rate=0.5, seed=1))
    tp.attach_fault_model(tfaults.FaultModel(rate=0.5, seed=1))
    jp._flush_integrity()
    tp._flush_integrity()
    assert tp._words == jp._words
    assert sorted(tp._masters) == sorted(jp._masters)
    B = jp.max_batch
    assert sorted(jp._masters) == [(B + r, lp) for r in (0, 2)
                                   for lp in range(jp.prefix_pages)]
    for key, (planes, word) in tp._masters.items():
        assert word == jp._words[key]
        for got, want in zip(planes, jp._masters[key]):
            np.testing.assert_array_equal(as_np(got), as_np(want))
    key = (B + 2, 1)
    phys = int(tp.page_table[key])
    before = tp.arenas["kp"][:, phys].clone()
    tp.arenas["kp"][:, phys].view(torch.uint8).bitwise_xor_(0x5A)
    assert tp.scrub_from_master(key)
    assert torch.equal(tp.arenas["kp"][:, phys], before)
    for p in (jp, tp):
        assert p.fault_row((B + 2, 0)) == 2
        assert p.fault_row((1, 0)) == 1


def test_prefix_band_admission_is_all_or_nothing():
    """When the band does not fit, the prompt's pages come back too."""
    jp, tp = pool_pair("always-augmented", "int8", 40, B=2)
    tight = (jp.max_pages + jp.prefix_pages + 2) * jp.geom.page_bytes_aug
    for p in (jp, tp):
        p.budget_bytes = tight
        assert p.admit_row(0, 20, 0)
        assert not p.admit_row(1, 20, 0)
        assert not p.allocated[1].any() and not p.allocated[3].any()
    assert tp.live_bytes == jp.live_bytes
    assert tp.stats == jp.stats


# ---------------------------------------------------------------------------
# the JAX oracle: one child process for every numeric comparison
# ---------------------------------------------------------------------------

PSEED = {"tokens": 0, "refresh": 3, "scrub": 0}


def _streams():
    """name -> (amc override or None for tests/test_faults.py's fresh
    AMCConfig, engine kwargs, prompts, max_new): every engine run, the
    JAX one and the port's alike."""
    rng = np.random.default_rng(PSEED["tokens"])
    ps = [rng.integers(0, 512, size=(int(n),)).astype(np.int32).tolist()
          for n in (6, 11, 4, 9)]
    tok = {"max_batch": 2, "max_seq": 32, "prefill_chunk": 8}
    out = {f"tokens/spec{k}": ({}, {**tok, "spec_k": k}, ps, 8)
           for k in (1, 4)}
    # tests/test_scheduler.py:352: int8, retention 2
    rng = np.random.default_rng(PSEED["refresh"])
    ps = [rng.integers(0, 512, size=(6,)).astype(np.int32).tolist()
          for _ in range(2)]
    out["refresh"] = ({"kv_mode": "int8", "retention_steps": 2},
                      {"max_batch": 2, "max_seq": 32, "prefill_chunk": 16},
                      ps, 8)
    # tests/test_faults.py:184: a fresh AMCConfig at always-augmented int4
    rng = np.random.default_rng(PSEED["scrub"])
    ps = [rng.integers(0, 512, size=(4,)).astype(np.int32).tolist()
          for _ in range(2)]
    fresh = {"pool_mode": "always-augmented", "kv_mode": "int4",
             "fresh": True}
    out["scrub_golden"] = (fresh, {"max_batch": 2, "max_seq": 32,
                                   "retention_steps": 4}, ps, 6)
    out["scrub"] = (fresh, {"max_batch": 2, "max_seq": 32,
                            "retention_steps": 4, "fault_rate": 1.0,
                            "fault_seed": 3}, ps, 6)
    return out


FAULT_KEYS = ("faults_injected", "faults_detected", "faults_masked",
              "refresh_misses", "integrity_checks", "pinned_normal",
              "pages_decommissioned", "recovered_scrub",
              "recovered_recompute", "retried", "uncorrectable",
              "faults_pending", "failed_requests", "zero_silent_corruption")


def _jax_jobs(args: dict) -> dict:
    """Every JAX computation of this file, run by source in the child:
    the cross read on a filled band (reference route), four chained
    decode steps over a filled band, and the engine streams."""
    import dataclasses
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import AxisType
    from repro.configs import get_arch
    from repro.configs.base import AMCConfig
    from repro.models import encdec
    from repro.serve import Request, ServeEngine
    from repro.serve.cache_pool import PagedKVPool

    class BlockingEngine(ServeEngine):
        """Waits for every dispatch: the JAX engine's stepwise prefill
        bumps its numpy positions right after a dispatch, and on the CPU
        backend the step in flight may still read that buffer."""

        def _dispatch(self, fn, batch):
            logits = super()._dispatch(fn, batch)
            jax.block_until_ready(logits)
            return logits

    params = jax.tree.map(jnp.asarray, args["params"])
    inp = args["inputs"]
    base = get_arch("whisper-tiny").reduced()

    def cfg_of(amc):
        amc = dict(amc)
        a = AMCConfig() if amc.pop("fresh", False) else base.amc
        return dataclasses.replace(base, amc=dataclasses.replace(
            a, kv_impl="dequant", matmul_impl="dense", **amc))

    out = {}
    # the cross read: one layer's arenas and the band's tables as given
    cfg = cfg_of({})
    arena = {k: jnp.asarray(inp[f"cross/{k}"])
             for k in ("kn", "vn", "kp", "vp", "ks", "vs")}
    meta = {k: jnp.asarray(inp[f"cross/{k}"])
            for k in ("cross_table", "cross_modes", "cross_lengths")}
    lp = {k: v[0] for k, v in params["layers"]["cross"].items()}
    out["cross"] = np.asarray(jax.jit(
        lambda p, x, a, m: encdec.cross_block_decode_paged(
            cfg, p, x, a, m))(lp, jnp.asarray(inp["cross/x"]), arena, meta)
        .astype(jnp.float32))
    # four chained decode steps over a band filled after admission
    pool = PagedKVPool(cfg, max_batch=3, max_seq=32, prefix_tokens=16)
    for r, n in ((0, 9), (1, 4)):
        assert pool.admit_row(r, n, 0)
    pool.arenas = {k: jnp.asarray(inp[f"step/arena/{k}"])
                   for k in pool.arenas}
    step = jax.jit(lambda p, a, b: encdec.paged_decode_step(
        cfg, p, a, b["tokens"], b["positions"],
        {k: v for k, v in b.items() if k not in ("tokens", "positions")}))
    toks = inp["step/tokens"]
    logits = []
    for s in range(toks.shape[1]):
        batch = {"tokens": jnp.asarray(toks[:, s:s + 1]),
                 "positions": jnp.asarray(inp["step/positions"] + s),
                 "write_mask": jnp.asarray(inp["step/write_mask"]),
                 **pool.device_tables()}
        lg, pool.arenas = step(params, pool.arenas, batch)
        logits.append(np.asarray(lg, np.float32))
    out["step"] = np.stack(logits)
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    for name, (amc, engine, ps, max_new) in args["streams"].items():
        eng = BlockingEngine(cfg_of(amc), mesh, params=params, **engine)
        toks = eng.generate([Request(prompt=np.asarray(p, np.int32),
                                     max_new_tokens=max_new, id=i)
                             for i, p in enumerate(ps)])
        st = eng.stats()
        out[name] = {
            "tokens": {str(k): [int(t) for t in v] for k, v in toks.items()},
            "faults": {k: (bool(v) if isinstance(v, (bool, np.bool_))
                           else int(v)) for k, v in st["faults"].items()
                       if k in args["keys"]},
            "refreshes": int(st["refreshes"]),
            "refresh_bytes": int(st["refresh_bytes"]),
            "energy_fj": float(st["imc"]["energy_fj_total"]),
            "spec_rounds": int(st["spec"]["spec_rounds"])}
    return out


CHILD = """
import pickle, sys
from jax.experimental.pallas import tpu as pltpu
pltpu.TPUCompilerParams = pltpu.CompilerParams
%s
with open(sys.argv[1], "rb") as f:
    args = pickle.load(f)
out = _jax_jobs(args)
with open(args["out"], "wb") as f:
    pickle.dump(out, f)
"""


def to_bf16_np(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int16).numpy().view(jnp.bfloat16)


def tree_np(tree):
    """A torch tree as numpy (bf16 through its 16-bit words)."""
    if isinstance(tree, dict):
        return {k: tree_np(v) for k, v in tree.items()}
    if tree.dtype == torch.bfloat16:
        return to_bf16_np(tree)
    return tree.numpy()


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny tensors: one torch thread (several contend with XLA's pool in
    this process and with the child for cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_params():
    """JAX's seed-0 dense weights of the reduced config (numpy)."""
    cfg = jax_get_arch(ARCH).reduced()
    cfg = dataclasses.replace(cfg, amc=dataclasses.replace(
        cfg.amc, weight_mode="normal"))
    return jax.tree.map(np.asarray, jax.jit(
        lambda k: jax_init_params(jm.abstract_params(cfg), k))(
        jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def torch_params(jax_params):
    return from_numpy_tree(jax_params, CPU)


def cross_inputs(seed: int = 0) -> dict:
    """One layer's two-plane arenas with random bytes, a band table of
    distinct physical pages in mixed modes, rows of length 40 (three
    pages, the last partial), 0 (an idle slot) and 40, and the layer
    input x."""
    cfg = get_arch(ARCH).reduced()
    rng = np.random.default_rng(seed)
    KV, hd, page = cfg.n_kv_heads, cfg.hd, cfg.amc.page_size
    B, Pc, N = 3, 3, 12
    out = {
        "kn": (rng.standard_normal((N, KV, page, hd)) * 0.5
               ).astype(jnp.bfloat16),
        "vn": (rng.standard_normal((N, KV, page, hd)) * 0.5
               ).astype(jnp.bfloat16),
        "kp": rng.integers(-127, 128, (N, KV, page, hd)).astype(np.int8),
        "vp": rng.integers(-127, 128, (N, KV, page, hd)).astype(np.int8),
        "ks": rng.uniform(0.001, 0.01, (N, KV, page)).astype(jnp.bfloat16),
        "vs": rng.uniform(0.001, 0.01, (N, KV, page)).astype(jnp.bfloat16),
        "cross_table": (rng.permutation(N - 1)[:B * Pc] + 1).reshape(
            B, Pc).astype(np.int32),
        "cross_modes": rng.integers(0, 2, (B, Pc)).astype(np.int32),
        "cross_lengths": np.array([40, 0, 40], np.int32),
        "x": (rng.standard_normal((B, 1, cfg.d_model))).astype(jnp.bfloat16),
    }
    out["cross_table"][1] = 0            # an idle slot: its band is unset
    out["cross_modes"][1] = 0
    return out


def to_torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def step_pool(cfg, device=CPU):
    pool = PagedKVPool(cfg, max_batch=3, max_seq=32, prefix_tokens=16,
                       device=device)
    for r, n in ((0, 9), (1, 4)):
        assert pool.admit_row(r, n, 0)
    return pool


def step_inputs(cfg, seed: int = 1) -> dict:
    """Random bytes for every arena page (the band included, filled after
    admission zeroed it), 4 steps of tokens for 3 rows, row 2 idle."""
    rng = np.random.default_rng(seed)
    pool = step_pool(cfg)
    out = {}
    for k, v in pool.arenas.items():
        if v.dtype == torch.int8:
            a = rng.integers(-127, 128, tuple(v.shape)).astype(np.int8)
        elif k in ("ks", "vs"):
            a = rng.uniform(0.001, 0.01, tuple(v.shape)).astype(jnp.bfloat16)
        else:
            a = (rng.standard_normal(tuple(v.shape)) * 0.5
                 ).astype(jnp.bfloat16)
        out[f"step/arena/{k}"] = a
    out["step/tokens"] = rng.integers(0, 512, (3, 4)).astype(np.int32)
    out["step/positions"] = np.array([9, 4, 0], np.int32)
    out["step/write_mask"] = np.array([True, True, False])
    return out


@pytest.fixture(scope="module")
def oracle_child(jax_params, tmp_path_factory):
    """The child process, started at the module's first numeric test;
    `oracles` reads (and waits for) its results."""
    import pickle
    tmp = tmp_path_factory.mktemp("audio")
    cfg = get_arch(ARCH).reduced()
    inputs = {f"cross/{k}": v for k, v in cross_inputs().items()}
    inputs.update(step_inputs(cfg))
    args = {"params": jax_params, "inputs": inputs, "streams": _streams(),
            "keys": list(FAULT_KEYS), "out": str(tmp / "out.pkl")}
    with open(tmp / "args.pkl", "wb") as f:
        pickle.dump(args, f)
    flags = os.environ.get("XLA_FLAGS", "")
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": f"{flags} --xla_allow_excess_precision=false",
           "PYTHONPATH": os.pathsep.join(
               [str(REPO / "src"), os.environ.get("PYTHONPATH", "")])}
    child = subprocess.Popen(
        [sys.executable, "-c", CHILD % inspect.getsource(_jax_jobs),
         str(tmp / "args.pkl")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    yield child, args, inputs
    if child.poll() is None:
        child.kill()
        child.wait()


ROUTES = {"ref": {"kv_impl": "dequant", "matmul_impl": "dense"},
          "kernel": {}}


@pytest.fixture(scope="module")
def port_runs(oracle_child, torch_params):
    """Every stream through the port's engine (while the child runs), on
    the reference route (the JAX engine's) and on the kernel route (its
    plain versions here)."""
    out = {}
    base = get_arch(ARCH).reduced()
    for (name, (amc, engine, ps, max_new)), route in (
            (item, r) for item in _streams().items() for r in ROUTES):
        amc = dict(amc)
        a = AMCConfig() if amc.pop("fresh", False) else base.amc
        cfg = dataclasses.replace(base, amc=dataclasses.replace(
            a, **amc, **ROUTES[route]))
        eng = ServeEngine(cfg, device="cpu", params=torch_params, **engine)
        toks = eng.generate([Request(prompt=np.asarray(p, np.int32),
                                     max_new_tokens=max_new, id=i)
                             for i, p in enumerate(ps)])
        st = eng.stats()
        out[f"{route}/{name}"] = {
            "tokens": {str(k): list(map(int, v)) for k, v in toks.items()},
            "faults": {k: v for k, v in st["faults"].items()
                       if k in FAULT_KEYS},
            "refreshes": st["refreshes"],
            "refresh_bytes": st["refresh_bytes"],
            "energy_fj": st["imc"]["energy_fj_total"],
            "spec_rounds": st["spec"]["spec_rounds"]}
    return out


@pytest.fixture(scope="module")
def oracles(oracle_child, port_runs):
    """The child's results, read once the port's runs are done."""
    import pickle
    child, args, _ = oracle_child
    log, _ = child.communicate(timeout=600)
    assert child.returncode == 0, log[-4000:]
    with open(args["out"], "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("kv_impl", ["kernel", "dequant"])
def test_cross_read_on_a_filled_band_matches_jax(oracle_child, oracles,
                                                 torch_params, kv_impl):
    """`cross_block_decode_paged` over a band of random int8 / bf16 pages
    in mixed modes, against the JAX reference route; the idle row (length
    0) finite."""
    _, _, inputs = oracle_child
    cfg = get_arch(ARCH).reduced()
    cfg = dataclasses.replace(cfg, amc=dataclasses.replace(
        cfg.amc, kv_impl=kv_impl))
    t = {k[len("cross/"):]: to_torch(v) for k, v in inputs.items()
         if k.startswith("cross/")}
    lp = {k: v[0] for k, v in torch_params["layers"]["cross"].items()}
    arena = {k: t[k] for k in ("kn", "vn", "kp", "vp", "ks", "vs")}
    got = encdec.cross_block_decode_paged(cfg, lp, t["x"], arena, t).float()
    want = torch.from_numpy(oracles["cross"])
    assert torch.isfinite(got).all()
    live = t["cross_lengths"] > 0
    if kv_impl == "kernel":
        err = float((got[live] - want[live]).abs().max()
                    / want[live].abs().max())
        assert err < 0.03, err
    else:
        assert float((got - want).abs().max()) \
            <= ulp_bf16(want.abs().max())


@pytest.mark.parametrize("kv_impl", ["kernel", "dequant"])
def test_decode_step_logits_match_jax(oracle_child, oracles, torch_params,
                                      kv_impl):
    """Four chained decode steps (rows at positions 9 and 4, row 2 idle)
    over arenas whose every page, the band's included, holds random
    bytes, against the JAX reference step: the reference route's logits
    within one bf16 ulp of the largest, the kernel route's (its plain
    versions: float32 PV products) within rel_err 0.05, the port's logit
    tolerance; no NaN anywhere in the arenas afterwards."""
    _, _, inputs = oracle_child
    cfg = get_arch(ARCH).reduced()
    cfg = dataclasses.replace(cfg, amc=dataclasses.replace(
        cfg.amc, kv_impl=kv_impl))
    pool = step_pool(cfg)
    for k in pool.arenas:
        pool.arenas[k].copy_(to_torch(inputs[f"step/arena/{k}"]))
    want = oracles["step"]
    toks = inputs["step/tokens"]
    for s in range(toks.shape[1]):
        batch = {"tokens": torch.from_numpy(toks[:, s:s + 1].copy()),
                 "positions": torch.from_numpy(
                     inputs["step/positions"] + s),
                 "write_mask": torch.from_numpy(inputs["step/write_mask"]),
                 **pool.device_tables()}
        lg, _ = tm.paged_decode_step(cfg, torch_params, pool.arenas, batch)
        V = cfg.vocab
        diff = np.abs(lg.numpy()[..., :V] - want[s][..., :V])[:2].max()
        top = np.abs(want[s][:2, :, :V]).max()
        if kv_impl == "dequant":
            assert diff <= ulp_bf16(top), s
        else:
            assert diff / top < 0.05, s
    for k, v in pool.arenas.items():
        if v.is_floating_point():
            assert torch.isfinite(v).all(), k


@pytest.mark.parametrize("spec_k", [1, 4])
def test_engine_tokens_match_jax(oracles, port_runs, spec_k):
    """The port's engine on the reference route against the JAX engine's;
    spec_k=4 on a family without a verify step decodes stepwise, on both
    routes: the spec_k=1 tokens, no speculative round."""
    name = f"tokens/spec{spec_k}"
    run = port_runs[f"ref/{name}"]
    assert run["tokens"] == oracles[name]["tokens"]
    assert run["energy_fj"] == pytest.approx(oracles[name]["energy_fj"],
                                             rel=1e-12)
    assert oracles[name]["spec_rounds"] == 0
    for route in ROUTES:
        run = port_runs[f"{route}/{name}"]
        assert run["tokens"] == port_runs[f"{route}/tokens/spec1"]["tokens"]
        assert run["spec_rounds"] == 0


def test_prefix_band_refresh_accounting_matches_jax(oracles, port_runs):
    """tests/test_scheduler.py:352: under an always-augmented int8 pool at
    retention 2 the band's pages (never rewritten) expire and are
    restamped; refreshes, refresh bytes, tokens and the energy ledger
    equal the JAX engine's."""
    run, want = port_runs["ref/refresh"], oracles["refresh"]
    assert run["refreshes"] > 0 and run["refresh_bytes"] > 0
    assert all(len(v) == 8 for v in run["tokens"].values())
    for k in ("tokens", "refreshes", "refresh_bytes"):
        assert run[k] == want[k], k
    assert run["energy_fj"] == pytest.approx(want["energy_fj"], rel=1e-12)


def test_scrub_from_master_heals_prefix_band(oracles, port_runs):
    """tests/test_faults.py:184: rate-1.0 faults at retention 4 on an
    always-augmented int4 pool; corrupted band pages heal in place from
    their host masters; tokens equal the fault-free run's, and tokens and
    fault counters equal the JAX engine's."""
    for route in ROUTES:
        golden = port_runs[f"{route}/scrub_golden"]
        run = port_runs[f"{route}/scrub"]
        fl = run["faults"]
        assert fl["recovered_scrub"] > 0 and fl["zero_silent_corruption"]
        assert run["tokens"] == golden["tokens"], route
    assert port_runs["ref/scrub_golden"]["tokens"] \
        == oracles["scrub_golden"]["tokens"]
    for key in ("tokens", "faults"):
        assert port_runs["ref/scrub"][key] == oracles["scrub"][key], key


def test_cli_serves_the_arch_traced(tmp_path, capsys):
    """`python -m repro_torch.launch.serve --arch ARCH --reduced --device
    cpu` (in this process): every request served, the store named, no
    speculative round at --spec-k 4, a valid Chrome trace and a metrics
    dump with every request completed."""
    from repro_torch import obs as tobs
    from repro_torch.launch import serve
    trace, prom = tmp_path / "t.json", tmp_path / "m.prom"
    serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                "--requests", "3", "--max-new", "4", "--max-batch", "2",
                "--max-seq", "32", "--spec-k", "4", "--pool-mode",
                "augment-on-pressure", "--trace-out", str(trace),
                "--metrics-out", str(prom)])
    out = capsys.readouterr().out
    assert sum(line.startswith("[serve] req ") for line in
               out.splitlines()) == 3
    assert "store=paged " in out
    assert "[serve] spec_k=" not in out
    assert tobs.validate_chrome_trace_file(str(trace)) == []
    assert "amc_requests_completed 3" in prom.read_text()
