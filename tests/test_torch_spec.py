"""Self-speculative decoding in the port, held against the JAX package.

- The window read: its plain version holds the JAX oracle and, slot by
  slot, is identical to the decode read at that slot's horizon.
- The masked pack: bytes and scales equal the JAX reference path.
- The engine: spec_k = 4 emits exactly the tokens of spec_k = 1 and of
  the JAX engine at spec_k = 4, for qwen-reduced int4 and int8 and for
  granite-reduced (dual weights, int4 KV), on prompts whose JAX top-1 /
  top-2 logit margin exceeds MIN_MARGIN at every decode step (checked);
  forced rejection of every draft retracts pages and keeps the tokens.
- The int4 pack is the Augmented plane's write driver under either
  kv_impl: the dequant draft route must not ask for its plain version.

The JAX engines run their reference paths (kv_impl="dequant",
matmul_impl="dense"). At kv_mode="int4" the JAX pool packs through its
Pallas kernel, which this jax runs only with `pltpu.TPUCompilerParams`
aliased to `pltpu.CompilerParams`: those oracles run in a CHILD process
that sets the alias before it imports `repro`, never here (as in
tests/test_torch_serve.py).
"""
import collections
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
from repro.kernels import ops as jops
from repro.kernels import ref
from repro.models import model as jm
from repro.models.params import init_params as jax_init_params
from repro_torch.configs import get_arch
from repro_torch.kernels import ops
from repro_torch.kernels.paged_kv_attention import (
    paged_kv_attention_plain, paged_kv_attention_window_cuda,
    paged_kv_attention_window_plain)
from repro_torch.kernels.quantize_pack_kv import (
    quantize_pack_kv_masked_cuda, quantize_pack_kv_plain)
from repro_torch.models import transformer as tm
from repro_torch.models.params import from_numpy_tree
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve import cache_pool as tpool_mod

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The reduced model's tensors are tiny: torch's intra-op threads only
    contend with XLA's thread pool in this process (10x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_int4_pack_ignores_kv_impl(monkeypatch):
    """`_paged_scatter` (its pack is the fused paged write) and the augment
    page op call their kernels with no plain-version switch under
    kv_impl="dequant" (the draft's route), as the JAX package's pool and
    scatter do."""
    calls = []

    def recording(name):
        real = getattr(ops, name)

        def fn(*args, **kwargs):
            calls.append((name, kwargs))
            return real(*args, **kwargs)
        return fn

    for name in ("quantize_pack_kv", "paged_kv_write"):
        monkeypatch.setattr(ops, name, recording(name))
    cfg = get_arch("qwen1.5-0.5b").reduced()
    cfg = dataclasses.replace(cfg, amc=dataclasses.replace(
        cfg.amc, kv_mode="int4", kv_impl="dequant",
        pool_mode="augment-on-pressure"))
    kv = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 3, cfg.n_kv_heads, cfg.hd)).astype(np.float32)).to(torch.bfloat16)
    pool = tpool_mod.PagedKVPool(cfg, max_batch=1, max_seq=32, device=CPU)
    layer = {k: v[0] for k, v in pool.arenas.items()}
    tm._paged_scatter(cfg, layer, kv, kv, torch.arange(3)[None, :],
                      pool.device_tables(), torch.ones((1, 3), dtype=bool))
    tpool_mod._augment_page_op(pool.arenas, 1, 1, cfg=cfg)
    assert [name for name, _ in calls] == [
        "paged_kv_write", "quantize_pack_kv", "quantize_pack_kv"]
    assert calls[0][1]["aug_bits"] == 4
    assert all(not kw.get("plain") for _, kw in calls), calls


# ---------------------------------------------------------------------------
# the window read and the masked pack: plain versions vs the JAX oracles
# ---------------------------------------------------------------------------

def tt(a) -> torch.Tensor:
    return from_numpy_tree(np.asarray(a), CPU)


def bf16(a) -> np.ndarray:
    return np.array(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16))


def mixed_pool(seed, *, B, KV, D, page, maxP, kv_bits):
    """A two-plane pool with random contents, disjoint physical pages per
    row and alternating page modes."""
    rng = np.random.default_rng(seed)
    Nn = Np = B * maxP + 1
    d_store = D // 2 if kv_bits == 4 else D
    kn, vn = (bf16(rng.standard_normal((Nn, KV, page, D))) for _ in "kv")
    if kv_bits == 4:
        kp, vp = (rng.integers(0, 256, (Np, KV, page, d_store)
                               ).astype(np.uint8) for _ in "kv")
    else:
        kp, vp = (rng.integers(-127, 128, (Np, KV, page, d_store)
                               ).astype(np.int8) for _ in "kv")
    smax = 1 / 7 if kv_bits == 4 else 1 / 127
    ks, vs = (bf16(rng.uniform(0.2, 2.0, (Np, KV, page)) * smax)
              for _ in "kv")
    modes = (np.arange(maxP)[None, :] % 2 + np.zeros((B, 1))).astype(np.int32)
    table = (1 + rng.permutation(B * maxP).reshape(B, maxP)).astype(np.int32)
    return kn, vn, kp, vp, ks, vs, table, modes


# page = 8: window geometries the speculative engine produces
# (tests/test_speculative.py's cases, plus a slot past the table's end)
WINDOW_CASES = {
    "straddles_two_pages": (6, 4),      # positions 6..9 cross page 0 -> 1
    "window_eq_page_size": (8, 8),      # slots exactly cover page 1
    "one_short_of_page": (5, 4),        # horizons 6..9: one hits p - 1
    "ends_one_short_of_page": (12, 3),  # horizons 13..15
    "past_the_table": (30, 4),          # horizons 31..34 clamp to 32
}
WINDOW_REF = jax.jit(ref.paged_kv_attention_window_ref,
                     static_argnames="kv_bits")


@pytest.mark.parametrize("kv_bits", [4, 8])
@pytest.mark.parametrize("case", sorted(WINDOW_CASES))
def test_window_plain_vs_ref_and_slotwise_identical(kv_bits, case):
    """The window plain version holds the JAX oracle (rel_err < 0.03, as
    the decode read), and each slot w is IDENTICAL to the decode plain
    version at lengths starts + w + 1: the anchor of token identity
    between speculative and stepwise decode."""
    start0, W = WINDOW_CASES[case]
    B, KV, Hg, D, page, maxP = 2, 2, 2, 32, 8, 4
    pool = mixed_pool(W + kv_bits, B=B, KV=KV, D=D, page=page, maxP=maxP,
                      kv_bits=kv_bits)
    rng = np.random.default_rng(start0)
    q = bf16(rng.standard_normal((B, KV, W, Hg, D)))
    starts = np.array([start0, max(start0 - 3, 0)], np.int32)
    args = (*pool[:6], starts, *pool[6:])
    want = WINDOW_REF(jnp.asarray(q), *map(jnp.asarray, args),
                      kv_bits=kv_bits)
    targs = [tt(a) for a in args]
    got = paged_kv_attention_window_plain(tt(q), *targs, kv_bits=kv_bits)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == q.shape
    assert ref.rel_err(got.float().numpy(), want) < 0.03
    st = torch.from_numpy(starts)
    for w in range(W):
        one = paged_kv_attention_plain(tt(q)[:, :, w], *targs[:6],
                                       st + w + 1, *targs[7:],
                                       kv_bits=kv_bits)
        assert torch.equal(got[:, :, w].view(torch.int16),
                           one.view(torch.int16)), f"slot {w}"
    assert torch.equal(ops.paged_kv_attention_window(
        tt(q), *targs, kv_bits=kv_bits), got)


@pytest.mark.parametrize("kv_bits", [4, 8])
@pytest.mark.parametrize("page,maxP,starts", [
    (8, 12, [0, 5, 60, 90]),         # horizons 1.., across 64-token chunks
    (16, 6, [12, 62, 0, 93]),        # page and chunk edges, past the table
])
def test_split_merge_mirror_window_vs_ref_and_slotwise_identical(
        kv_bits, page, maxP, starts):
    """The kernels' split-page order in torch (`paged_split_merge_mirror`)
    holds the JAX window oracle within 0.03 over pages of both planes in
    one chunk, and its window slot w equals its decode read at
    starts + w + 1 bit for bit: the invariant that speculative == stepwise
    rests on, rehearsed on the CPU."""
    from torch_paged_mirror import paged_split_merge_mirror
    B, KV, W, Hg, D = 4, 2, 4, 2, 32
    pool = mixed_pool(page + kv_bits, B=B, KV=KV, D=D, page=page, maxP=maxP,
                      kv_bits=kv_bits)
    rng = np.random.default_rng(page)
    q = bf16(rng.standard_normal((B, KV, W, Hg, D)))
    st = np.array(starts, np.int32)
    args = (*pool[:6], st, *pool[6:])
    want = WINDOW_REF(jnp.asarray(q), *map(jnp.asarray, args),
                      kv_bits=kv_bits)
    targs = [tt(a) for a in args]
    got = paged_split_merge_mirror(tt(q), *targs, kv_bits=kv_bits,
                                   window=True)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == q.shape
    assert ref.rel_err(got.float().numpy(), want) < 0.03
    for w in range(W):
        one = paged_split_merge_mirror(tt(q)[:, :, w], *targs[:6],
                                       targs[6] + w + 1, *targs[7:],
                                       kv_bits=kv_bits)
        assert torch.equal(got[:, :, w].view(torch.int16),
                           one.view(torch.int16)), f"slot {w}"


def test_masked_pack_plain_matches_jax_reference():
    """Bytes and scales equal `quantize_pack_kv(kv, valid)` on the JAX
    reference path: rejected rows give zero bytes and a scale of exactly
    1.0 (not the 1e-8 / 7 of a zero row); kept rows equal the unmasked
    pack, including an all-zero kept row."""
    rng = np.random.default_rng(7)
    kv = bf16(rng.standard_normal((2, 6, 2, 32)) * 4)
    kv[0, 1] = 0.0                          # kept zero rows: 1e-8 / 7
    kv[1, 3] = 0.0                          # rejected zero rows
    valid = np.array([[1, 1, 1, 0, 0, 0], [1, 0, 1, 0, 1, 0]],
                     bool)[:, :, None]
    jp, js = jops.quantize_pack_kv(jnp.asarray(kv), jnp.asarray(valid),
                                   use_ref=True)
    p, s = ops.quantize_pack_kv(tt(kv), torch.from_numpy(valid))
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(s.float().numpy(),
                                  np.asarray(js.astype(jnp.float32)))
    keep = np.broadcast_to(valid, kv.shape[:-1])
    assert (p.numpy()[~keep] == 0).all()
    assert (s.float().numpy()[~keep] == 1.0).all()
    assert (s.float().numpy()[0, 1] < 1e-8).all()   # kept zero rows
    p0, s0 = ops.quantize_pack_kv(tt(kv))
    assert torch.equal(p[torch.from_numpy(keep)], p0[torch.from_numpy(keep)])
    flat = tt(kv).reshape(-1, 32)
    pf, sf = quantize_pack_kv_plain(flat, torch.from_numpy(keep.reshape(-1)))
    assert torch.equal(pf, p.reshape(-1, 16))
    assert sf.dtype == torch.float32
    assert torch.equal(sf, s.reshape(-1, 1).float())


def test_new_wrappers_refuse_cpu_tensors_without_launching():
    kv = tt(bf16(np.ones((4, 32))))
    with pytest.raises(ValueError, match="CUDA"):
        quantize_pack_kv_masked_cuda(kv, torch.ones(4, dtype=torch.bool))
    pool = mixed_pool(0, B=1, KV=1, D=32, page=8, maxP=1, kv_bits=4)
    q = tt(bf16(np.ones((1, 1, 2, 1, 32))))
    with pytest.raises(ValueError, match="CUDA"):
        paged_kv_attention_window_cuda(
            q, *map(tt, pool[:6]), torch.zeros(1, dtype=torch.int32),
            *map(tt, pool[6:]), kv_bits=4)
    assert quantize_pack_kv_masked_cuda.launches == 0
    assert paged_kv_attention_window_cuda.launches == 0


# ---------------------------------------------------------------------------
# the engine: token identity with stepwise decode and with the JAX engine
# ---------------------------------------------------------------------------

MIN_MARGIN = 1e-2
ENGINE = {"max_batch": 2, "max_seq": 40, "prefill_chunk": 8}
REQS = [(5, 9), (9, 6), (3, 7)]          # (prompt tokens, new tokens)
# name: (arch, kv_mode, prompt seed); each seed keeps every stepwise
# decode step's JAX top-1/top-2 margin >= 0.05 (random bf16 logits have
# near-ties at many seeds)
CASES = {"qwen_int4": ("qwen1.5-0.5b", "int4", 4),
         "qwen_int8": ("qwen1.5-0.5b", "int8", 4),
         "granite_dual_int4": ("granite-3-2b", "int4", 1)}


def prompts(vocab, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=(n,)).astype(np.int32)
            for n, _ in REQS]


def _jax_spec_oracle(arch, kv_mode, params, prompts, engine, reqs):
    """Serve `prompts` with the JAX engine on its reference paths at
    spec_k = 1 and 4; return both token sets, the smallest top-1/top-2
    margin of any stepwise decode step and the spec counters. Runs both
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

    cfg = get_arch(arch).reduced()
    cfg = dataclasses.replace(cfg, amc=dataclasses.replace(
        cfg.amc, kv_impl="dequant", matmul_impl="dense"))
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    res = {}
    for k in (1, 4):
        eng = RecordingEngine(cfg, mesh, params=params, kv_mode=kv_mode,
                              spec_k=k, **engine)
        out = eng.generate([Request(prompt=np.asarray(p, np.int32),
                                    max_new_tokens=m, id=i)
                            for i, (p, (_, m)) in enumerate(zip(prompts,
                                                                reqs))])
        res[f"tokens_{k}"] = {str(i): [int(t) for t in v]
                              for i, v in out.items()}
        if k == 1:
            res["min_margin"] = eng.min_margin
        else:
            res["spec"] = {key: eng.stats()["spec"][key] for key in (
                "spec_rounds", "draft_dispatches", "verify_dispatches",
                "accepted_tokens")}
    return res


CHILD = """
import json, sys
import numpy as np
from jax.experimental.pallas import tpu as pltpu
pltpu.TPUCompilerParams = pltpu.CompilerParams
import jax, jax.numpy as jnp
args = json.loads(sys.argv[1])


def load(path):
    flat = np.load(path)
    params = {}
    for key in flat.files:
        a = flat[key]
        if a.dtype == np.uint16:
            a = a.view(jnp.bfloat16)
        node = params
        *keys, leaf = key.split("/")
        for k in keys:
            node = node.setdefault(k, {})
        node[leaf] = jnp.asarray(a)
    return params
%s
out = {name: _jax_spec_oracle(c["arch"], "int4", load(c["params"]),
                              c["prompts"], args["engine"], args["reqs"])
       for name, c in args["cases"].items()}
with open(args["out"], "w") as f:
    json.dump(out, f)
"""


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def dense_params(arch):
    cfg = jax_get_arch(arch).reduced()
    dense_cfg = dataclasses.replace(cfg, amc=dataclasses.replace(
        cfg.amc, weight_mode="normal"))
    return jax_init_params(jm.abstract_params(dense_cfg),
                           jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def oracles(tmp_path_factory):
    """JAX results of every case: the int4 ones from the child process
    (started first), int8 in this process meanwhile; plus the dense
    weights each case was served with."""
    tmp = tmp_path_factory.mktemp("spec_oracle")
    params = {arch: dense_params(arch)
              for arch in {a for a, _, _ in CASES.values()}}
    child_cases = {}
    for name, (arch, kv_mode, seed) in CASES.items():
        if kv_mode != "int4":
            continue
        path = tmp / f"{name}.npz"
        np.savez(path, **{k: (np.asarray(v).view(np.uint16)
                              if np.asarray(v).dtype.name == "bfloat16"
                              else np.asarray(v))
                          for k, v in _flatten(params[arch])})
        child_cases[name] = {"arch": arch, "params": str(path),
                             "prompts": [p.tolist() for p in prompts(
                                 jax_get_arch(arch).reduced().vocab, seed)]}
    args = {"cases": child_cases, "engine": ENGINE, "reqs": REQS,
            "out": str(tmp / "int4.json")}
    repo = Path(__file__).resolve().parents[1]
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join(
               [str(repo / "src"), os.environ.get("PYTHONPATH", "")])}
    child = subprocess.Popen(
        [sys.executable, "-c",
         CHILD % inspect.getsource(_jax_spec_oracle), json.dumps(args)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        res = {name: _jax_spec_oracle(arch, kv_mode, params[arch],
                                      prompts(jax_get_arch(arch).reduced().vocab, seed),
                                      ENGINE, REQS)
               for name, (arch, kv_mode, seed) in CASES.items()
               if kv_mode != "int4"}
        log, _ = child.communicate(timeout=600)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    assert child.returncode == 0, log[-4000:]
    with open(tmp / "int4.json") as f:
        res.update(json.load(f))
    return res, {arch: from_numpy_tree(jax.tree.map(np.asarray, p), CPU)
                 for arch, p in params.items()}


def torch_generate(arch, kv_mode, params, seed, spec_k, wrap_draft=None):
    cfg = get_arch(arch).reduced()
    eng = ServeEngine(cfg, device="cpu", params=params, kv_mode=kv_mode,
                      spec_k=spec_k, **ENGINE)
    if wrap_draft is not None:
        eng._draft_decode = wrap_draft(eng._draft_decode)
    out = eng.generate([Request(prompt=p, max_new_tokens=m, id=i)
                        for i, (p, (_, m)) in enumerate(
                            zip(prompts(cfg.vocab, seed), REQS))])
    return {str(k): v for k, v in out.items()}, eng


@pytest.mark.parametrize("case", sorted(CASES))
def test_spec_tokens_match_stepwise_and_jax(oracles, case):
    arch, kv_mode, seed = CASES[case]
    res, params = oracles
    want = res[case]
    assert want["min_margin"] > MIN_MARGIN, \
        f"prompt set sits on an argmax near-tie ({want['min_margin']})"
    assert want["tokens_4"] == want["tokens_1"]
    step, _ = torch_generate(arch, kv_mode, params[arch], seed, 1)
    spec, eng = torch_generate(arch, kv_mode, params[arch], seed, 4)
    assert step == want["tokens_1"]
    assert spec == step == want["tokens_4"]
    st = eng.stats()["spec"]
    assert st["enabled"] and st["verify_dispatches"] > 0
    assert st["draft_dispatches"] == 3 * st["verify_dispatches"]
    assert st["accepted_tokens"] == sum(m for _, m in REQS)
    assert st["accepted_tokens"] >= st["spec_rounds"]
    assert not eng.active.any() and not eng.scheduler.queue


def _negate(fn):
    """Draft wrapper that argmax-inverts the logits: every drafted token
    is (near-certainly) WRONG, so each round accepts only the verify's
    own token and every draft write past it is rejected — the worst-case
    rollback path."""
    def wrapped(params, arenas, batch):
        lg, arenas = fn(params, arenas, batch)
        return -lg, arenas
    return wrapped


def test_spec_forced_rejection_retracts_pages(oracles):
    arch, kv_mode, seed = CASES["qwen_int4"]
    params = oracles[1][arch]
    step, _ = torch_generate(arch, kv_mode, params, seed, 1)
    spec, eng = torch_generate(arch, kv_mode, params, seed, 4,
                               wrap_draft=_negate)
    assert spec == step
    st = eng.stats()
    assert st["pool"]["retracted_pages"] > 0
    assert st["spec"]["accepted_tokens"] < \
        st["spec"]["spec_rounds"] * eng.spec_k


def test_draft_config_resolution():
    from repro_torch.serve.engine import _resolve_draft_cfg
    cfg = get_arch("granite-3-2b").reduced()

    def draft(impl):
        return _resolve_draft_cfg(dataclasses.replace(
            cfg, amc=dataclasses.replace(cfg.amc, spec_draft_impl=impl))).amc

    assert (draft("dequant").kv_impl, draft("dequant").matmul_impl) == \
        ("dequant", "packed")
    assert (draft("dense").kv_impl, draft("dense").matmul_impl) == \
        ("dequant", "dense")
    assert (draft("packed").kv_impl, draft("packed").matmul_impl) == \
        ("kernel", "packed")
    assert draft("same") == dataclasses.replace(cfg.amc,
                                                spec_draft_impl="same")
    for n in (1, 4, 8):      # the pool read stays the full config's
        d = draft(f"imc{n}")
        assert (d.kv_impl, d.matmul_impl, d.imc_abits) == \
            ("kernel", "imc", n)
    with pytest.raises(ValueError, match="unknown spec_draft_impl"):
        draft("imc2")
    with pytest.raises(ValueError, match="unknown spec_draft_impl"):
        draft("fastest")


# ---------------------------------------------------------------------------
# the window read at minitron's width; the packed route's products
# ---------------------------------------------------------------------------

def test_window_plain_vs_ref_at_minitron_width():
    """W = 16 slots of Hg = 4 heads of D = 128 (minitron-8b at spec_k =
    16: 64 (slot, head) rows, four MMA row tiles of one CTA on the card):
    the plain window read holds the JAX oracle, and each slot equals the
    decode read at its horizon."""
    from repro_torch.kernels.paged_kv_attention import window_plan
    B, KV, W, Hg, D, page, maxP = 2, 2, 16, 4, 128, 16, 4
    assert window_plan(W, Hg) == 16
    pool = mixed_pool(16, B=B, KV=KV, D=D, page=page, maxP=maxP, kv_bits=4)
    rng = np.random.default_rng(16)
    q = bf16(rng.standard_normal((B, KV, W, Hg, D)))
    starts = np.array([21, 40], np.int32)
    args = (*pool[:6], starts, *pool[6:])
    want = WINDOW_REF(jnp.asarray(q), *map(jnp.asarray, args), kv_bits=4)
    targs = [tt(a) for a in args]
    got = paged_kv_attention_window_plain(tt(q), *targs, kv_bits=4)
    assert ref.rel_err(got.float().numpy(), want) < 0.03
    st = torch.from_numpy(starts)
    for w in range(W):
        one = paged_kv_attention_plain(tt(q)[:, :, w], *targs[:6],
                                       st + w + 1, *targs[7:], kv_bits=4)
        assert torch.equal(got[:, :, w], one), f"slot {w}"


class _Products:
    """Counts the matmul entry points a step calls, and with which route."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        self.saved = {n: getattr(ops, n) for n in
                      ("dense_matmul", "ternary_matmul", "dual_plane_matmul")}
        for name, fn in self.saved.items():
            setattr(ops, name, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(ops, name, fn)

    def _wrap(self, name, fn):
        def call(x, w, *args, **kw):
            self.calls.append((name, tuple(w.shape), kw.get("layout", "kn"),
                               kw.get("plain", False)))
            return fn(x, w, *args, **kw)
        return call


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "granite-3-2b"])
def test_packed_route_sends_every_product_through_the_gemms(arch):
    """On the packed route, a decode step and a verify window send every
    projection and the tied head through the port's kernels: qwen
    (ternary) 7 ternary products a layer and the head through
    `ops.dense_matmul` reading the (V_pad, d) embedding; granite (dual) wq,
    wo, w_down and the head through `ops.dense_matmul`, the pairs through
    `ops.dual_plane_matmul`. matmul_impl="dense" sends the same bf16
    products to their plain versions, and so does a prefill chunk on
    either route (no decode row has to match a chunk's)."""
    from repro_torch.models import augment
    from repro_torch.models import model as M
    from repro_torch.models.params import init_params
    from repro_torch.serve.cache_pool import PagedKVPool
    cfg = get_arch(arch).reduced()
    dense = dataclasses.replace(cfg, amc=dataclasses.replace(
        cfg.amc, weight_mode="normal"))
    params = augment.augment_params(cfg, init_params(dense, seed=2,
                                                     device="cpu"))
    L, d, V = cfg.n_layers, cfg.d_model, cfg.vocab_padded
    B, W = 2, 4
    pool = PagedKVPool(cfg, max_batch=B, max_seq=32, device=CPU)
    for r in range(B):
        pool.admit_row(r, W + 1, step=0)
    tables = pool.device_tables()
    if cfg.amc.weight_mode == "ternary":
        want = {("ternary_matmul", "kn"): 7 * L, ("dense_matmul", "nk"): 1}
    else:
        want = {("dense_matmul", "kn"): 3 * L,
                ("dual_plane_matmul", "kn"): 2 * L, ("dense_matmul", "nk"): 1}
    steps = ((M.paged_decode_step, 1, True), (M.paged_verify_step, W, True),
             (M.paged_prefill_step, W, False))
    for impl in ("packed", "dense"):
        icfg = dataclasses.replace(cfg, amc=dataclasses.replace(
            cfg.amc, matmul_impl=impl))
        for step, S, fixed in steps:
            batch = {**tables,
                     "tokens": torch.zeros((B, S), dtype=torch.int32),
                     "positions": torch.zeros(B, dtype=torch.int32),
                     "write_mask": torch.ones(
                         (B, S) if step is M.paged_verify_step else (B,),
                         dtype=torch.bool)}
            with torch.no_grad(), _Products() as rec:
                step(icfg, params, pool.arenas, batch)
            assert collections.Counter(
                (name, layout) for name, _, layout, _ in rec.calls) == want
            assert rec.calls[-1][:3] == ("dense_matmul", (V, d), "nk")
            assert {plain for name, _, _, plain in rec.calls
                    if name == "dense_matmul"} == \
                {impl == "dense" or not fixed}
