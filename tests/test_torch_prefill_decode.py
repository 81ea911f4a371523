"""The dense family's contiguous prefill -> decode steps held against the
JAX package: `forward(return_cache=True)` (the prefill step of
`make_prefill_step`), `prefill_chunk_step` and `decode_step` of the
reduced qwen1.5-0.5b (dense master weights) at kv normal, int8 and int4.

The JAX side runs in ONE child process with the TPUCompilerParams alias
(its int4 chunk pack and its kv_impl="kernel" decode reach Pallas calls)
and `XLA_FLAGS=--xla_allow_excess_precision=false` (bf16 roundings, as
tests/test_torch_audio.py runs it). The port takes its kernel routes'
plain versions here (kernel 3 for the int4 chunk pack, kernel 6 for the
packed decode read).

Tolerances:
- the forward's caches: packed bytes and scales (int8 / int4) and the
  bf16 K / V (normal) bit for bit equal to JAX's; the packed caches two
  chunked prefills write too. The bf16 cache of the chunks may hold a
  K / V entry one bf16 ulp apart (a float32 sum of the second layer's
  input ordered differently lands across a rounding: 1 of 16384 entries
  measured), at most 0.1% of the entries; a row outside `write_mask`
  keeps its lines bit for bit;
- prefill-chunk and decode logits rel_err < 0.05 (tests/
  test_augmented_model.py's tolerance), the port's kernel route against
  JAX's kernel route and its dequant route against JAX's dequant route;
- decode == forward (granite-3-2b reduced, kv normal): the last decode
  step's logits within 0.15 of the forward's last position
  (tests/test_arch_smoke.py:112); prefill then decode, kernel against
  dequant route, < 0.05 (tests/test_augmented_model.py:72).
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
from repro_torch.models import params as tparams
from repro_torch.models.params import from_numpy_tree
from repro_torch.serve import Request, ServeEngine
from repro_torch.train import TrainSettings, make_decode_step, \
    make_prefill_step

CPU = torch.device("cpu")
REPO = Path(__file__).resolve().parents[1]
KV_MODES = ("normal", "int8", "int4")
SHAPE = {"B": 2, "P": 8, "S": 32, "C": 8, "T": 3}


def _jax_steps(out_path: str, shape: dict) -> None:
    """Runs by source in the child: per kv mode, the forward's cache, two
    prefill chunks and T decode steps through both kv_impl routes."""
    import dataclasses
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro.configs import get_arch
    from repro.configs.base import ShapeConfig
    from repro.models import model as M
    from repro.models.params import init_params

    B, P, S, C, T = (shape[k] for k in "BPSCT")
    base = get_arch("qwen1.5-0.5b").reduced()
    params = init_params(M.abstract_params(base), jax.random.PRNGKey(2))
    out = {f"params/{'/'.join(str(k.key) for k in path)}":
           np.asarray(leaf).view(np.uint16)
           for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}
    rng = np.random.default_rng(3)
    toks = rng.integers(0, base.vocab, (B, 2 * C + T)).astype(np.int32)
    out["tokens"] = toks

    def bits(a):
        a = np.asarray(a)
        return a.view(np.uint16) if a.dtype.name == "bfloat16" else a

    for kv in ("normal", "int8", "int4"):
        for impl in ("dequant", "kernel"):
            cfg = dataclasses.replace(base, amc=dataclasses.replace(
                base.amc, weight_mode="normal", kv_mode=kv, kv_impl=impl))
            tag = f"{kv}/{impl}"
            if impl == "dequant":
                lg, cache = jax.jit(lambda p, t: M.forward(
                    cfg, p, {"tokens": t}, return_cache=True,
                    remat_policy="none", q_chunk=16))(params, toks[:, :P])
                for k, v in cache.items():
                    out[f"{kv}/forward/{k}"] = bits(v)
            cache = jax.tree.map(
                lambda l: jnp.zeros(l.shape, l.jdtype),
                M.abstract_cache(cfg, ShapeConfig("d", S, B, "decode")),
                is_leaf=lambda x: hasattr(x, "jdtype"))
            prefill = jax.jit(lambda p, c, b: M.prefill_step(cfg, p, c, b))
            decode = jax.jit(lambda p, c, b: M.decode_step(cfg, p, c, b))
            # chunk 0 on both rows, chunk 1 on row 0 only
            for i, mask in enumerate(([True, True], [True, False])):
                lg, cache = prefill(params, cache, {
                    "tokens": jnp.asarray(toks[:, i * C:(i + 1) * C]),
                    "positions": jnp.full((B,), i * C, jnp.int32),
                    "write_mask": jnp.asarray(mask)})
                out[f"{tag}/prefill{i}"] = np.asarray(lg)[..., :cfg.vocab]
                for k, v in cache.items():
                    out[f"{tag}/prefill{i}/{k}"] = bits(v)
            pos = np.array([2 * C, C], np.int32)
            for t in range(T):
                lg, cache = decode(params, cache, {
                    "tokens": jnp.asarray(toks[:, 2 * C + t:2 * C + t + 1]),
                    "positions": jnp.asarray(pos + t)})
                out[f"{tag}/decode{t}"] = np.asarray(lg)[..., :cfg.vocab]
            for k, v in cache.items():
                out[f"{tag}/decode/{k}"] = bits(v)
    np.savez(out_path, **out)


CHILD = """
import json, sys
from jax.experimental.pallas import tpu as pltpu
pltpu.TPUCompilerParams = pltpu.CompilerParams
%s
_jax_steps(**json.loads(sys.argv[1]))
"""


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("contig")
    args = {"out_path": str(tmp / "steps.npz"), "shape": SHAPE}
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_allow_excess_precision=false",
           "PYTHONPATH": os.pathsep.join(
               [str(REPO / "src"), os.environ.get("PYTHONPATH", "")])}
    res = subprocess.run(
        [sys.executable, "-c", CHILD % inspect.getsource(_jax_steps),
         json.dumps(args)], env=env, capture_output=True, text=True,
        timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    return dict(np.load(args["out_path"]))


def _params(want: dict) -> dict:
    tree: dict = {}
    for key, a in want.items():
        if key.startswith("params/"):
            node = tree
            *parts, leaf = key[len("params/"):].split("/")
            for k in parts:
                node = node.setdefault(k, {})
            node[leaf] = a
    return from_numpy_tree(tree, CPU)


def _cfg(kv: str, impl: str = "kernel", arch: str = "qwen1.5-0.5b"):
    c = get_arch(arch).reduced()
    return dataclasses.replace(c, amc=dataclasses.replace(
        c.amc, weight_mode="normal", kv_mode=kv, kv_impl=impl))


def _bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _zero_cache(cfg, B, S) -> dict:
    return {k: torch.zeros(s.shape, dtype=s.dtype)
            for k, s in tm.abstract_cache(cfg, B, S).items()}


@pytest.mark.parametrize("kv", KV_MODES)
def test_forward_cache_equals_jax(oracle, kv):
    cfg = _cfg(kv)
    params = _params(oracle)
    toks = torch.from_numpy(oracle["tokens"][:, :SHAPE["P"]])
    _, cache = make_prefill_step(cfg, TrainSettings(q_chunk=16))(
        params, {"tokens": toks})
    keys = ("k", "v") if kv == "normal" else ("k", "v", "k_scale",
                                              "v_scale")
    assert set(cache) == set(keys)
    for k in keys:
        want = oracle[f"{kv}/forward/{k}"]
        got = _bits(cache[k])
        assert got.shape == want.shape and got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)


@pytest.mark.parametrize("impl", ["dequant", "kernel"])
@pytest.mark.parametrize("kv", KV_MODES)
def test_prefill_and_decode_steps_match_jax(oracle, kv, impl):
    B, C, S, T = SHAPE["B"], SHAPE["C"], SHAPE["S"], SHAPE["T"]
    cfg = _cfg(kv, impl)
    params = _params(oracle)
    toks = torch.from_numpy(oracle["tokens"])
    tag = f"{kv}/{impl}"
    cache = _zero_cache(cfg, B, S)
    assert {k: (tuple(v.shape), v.dtype) for k, v in cache.items()} == {
        k: (oracle[f"{tag}/prefill0/{k}"].shape,
            {np.dtype("uint16"): torch.bfloat16, np.dtype("uint8"):
             torch.uint8, np.dtype("int8"): torch.int8}[
                oracle[f"{tag}/prefill0/{k}"].dtype])
        for k in cache}
    with torch.no_grad():
        for i, mask in enumerate(([True, True], [True, False])):
            lg, cache = tm.prefill_step(cfg, params, cache, {
                "tokens": toks[:, i * C:(i + 1) * C],
                "positions": torch.full((B,), i * C, dtype=torch.int32),
                "write_mask": torch.tensor(mask)})
            assert rel_err(lg.numpy()[..., :cfg.vocab],
                           oracle[f"{tag}/prefill{i}"]) < 0.05, i
            for k, v in cache.items():
                want = oracle[f"{tag}/prefill{i}/{k}"]
                if kv != "normal":
                    np.testing.assert_array_equal(_bits(v), want,
                                                  err_msg=f"chunk {i} {k}")
                    continue
                d = np.abs(_bits(v).astype(np.int32) - want.astype(np.int32))
                assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (i, k)
                if not mask[1]:                 # row 1 kept its lines
                    np.testing.assert_array_equal(
                        _bits(v)[:, 1], oracle[f"{tag}/prefill0/{k}"][:, 1])
        decode = make_decode_step(cfg)
        pos = torch.tensor([2 * C, C], dtype=torch.int32)
        for t in range(T):
            lg, cache = decode(params, cache, {
                "tokens": toks[:, 2 * C + t:2 * C + t + 1],
                "positions": pos + t})
            assert lg.shape == (B, 1, cfg.vocab_padded)
            assert rel_err(lg.numpy()[..., :cfg.vocab],
                           oracle[f"{tag}/decode{t}"]) < 0.05, t


def test_decode_matches_forward_dense():
    """Teacher-forced decode reproduces the full forward's final logits
    (granite-3-2b reduced, kv normal; the port's own weights)."""
    cfg = _cfg("normal", arch="granite-3-2b")
    params = tparams.init_params(cfg, seed=0, device=CPU)
    B, S = 2, 16
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (B, S)).astype(np.int32))
    with torch.no_grad():
        full = tm.forward(cfg, params, {"tokens": toks}, q_chunk=16)
        cache = _zero_cache(cfg, B, S)
        for t in range(S):
            lg, cache = tm.decode_step(cfg, params, cache, {
                "tokens": toks[:, t:t + 1],
                "positions": torch.full((B,), t, dtype=torch.int32)})
    err = float((lg[:, 0] - full[:, -1])[..., :cfg.vocab].abs().max())
    assert err < 0.15, err


@pytest.mark.parametrize("kv", ["int4", "int8"])
def test_prefill_then_decode_kernel_vs_dequant(kv):
    """prefill_step fills the packed head-major cache; decode continues on
    it: the kernel and the dequant routes agree through the chain."""
    B, S, P = 2, 32, 7
    params = tparams.init_params(_cfg(kv), seed=2, device=CPU)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, 512, (B, P)).astype(np.int32))
    outs = {}
    with torch.no_grad():
        for impl in ("kernel", "dequant"):
            cfg = _cfg(kv, impl)
            lg, cache = tm.prefill_step(cfg, params, _zero_cache(cfg, B, S), {
                "tokens": toks, "positions": torch.zeros(B, dtype=torch.int32),
                "write_mask": torch.ones(B, dtype=torch.bool)})
            dl, cache = tm.decode_step(cfg, params, cache, {
                "tokens": toks[:, -1:],
                "positions": torch.full((B,), P, dtype=torch.int32)})
            outs[impl] = (lg, dl)
    for a, b in zip(outs["kernel"], outs["dequant"]):
        assert rel_err(a.numpy(), b.numpy()) < 0.05


def test_abstract_cache_matches_jax_layout():
    """The contiguous cache tree: JAX's shapes and dtypes at every kv mode
    (packed head-major at int4 / int8), for every family: dense, moe, ssm,
    hybrid, audio (with the bf16 cross KV) and vlm (the nb * 4 self layers
    and the bf16 patch KV)."""
    from repro.configs import get_arch as jax_get_arch
    from repro.configs.base import ShapeConfig
    from repro.models import model as jm
    for arch in ("qwen1.5-0.5b", "qwen3-moe-30b-a3b", "mamba2-130m",
                 "recurrentgemma-9b", "whisper-tiny",
                 "llama-3.2-vision-11b"):
        for kv in KV_MODES:
            jc = jax_get_arch(arch).reduced()
            jc = dataclasses.replace(jc, amc=dataclasses.replace(
                jc.amc, kv_mode=kv))
            want = jm.abstract_cache(jc, ShapeConfig("d", 24, 3, "decode"))
            got = tm.abstract_cache(_cfg(kv, arch=arch), 3, 24)
            got, want = dict(_spec_leaves(got)), dict(_spec_leaves(want))
            assert set(got) == set(want), (arch, kv)
            for k, spec in got.items():
                assert spec.shape == want[k].shape, (arch, kv, k)
                assert {torch.bfloat16: "bf16", torch.uint8: "u8",
                        torch.int8: "i8", torch.float32: "f32"}[
                            spec.dtype] == want[k].dtype, (arch, kv, k)


def _spec_leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _spec_leaves(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


@pytest.mark.parametrize("kv", ["int8", "int4"])
def test_engine_memory_stats_unchanged(kv):
    """The engine's logical cache figure is still the dense bf16 K / V of
    every row at max_seq (the JAX engine's figure), not the packed
    contiguous tree, before and after a stream."""
    from repro.configs import get_arch as jax_get_arch
    from repro.configs.base import ShapeConfig
    from repro.models import model as jm
    from repro.serve.engine import _abstract_bytes
    cfg = get_arch("qwen1.5-0.5b").reduced()
    cfg = dataclasses.replace(cfg, amc=dataclasses.replace(cfg.amc,
                                                           kv_mode=kv))
    jc = jax_get_arch("qwen1.5-0.5b").reduced()
    jnormal = dataclasses.replace(jc, amc=dataclasses.replace(
        jc.amc, kv_mode="normal", weight_mode="normal"))
    want_cache = _abstract_bytes(jm.abstract_cache(
        jnormal, ShapeConfig("s", 32, 2, "decode")))
    want_weights = _abstract_bytes(jm.abstract_params(jnormal))
    eng = ServeEngine(cfg, device=CPU, max_batch=2, max_seq=32, seed=0)
    before = eng.stats()
    rng = np.random.default_rng(1)
    eng.generate([Request(prompt=rng.integers(0, cfg.vocab, 4).astype(
        np.int32), max_new_tokens=3, id=i) for i in range(2)])
    after = eng.stats()
    L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    assert want_cache == 2 * L * 2 * 32 * KV * hd * 2
    for st in (before, after):
        assert st["cache_bytes_logical"] == want_cache
        assert st["weight_bytes_logical"] == want_weights
        assert st["total_bytes_logical"] == want_cache + want_weights
    for k in ("cache_bytes_physical", "weight_bytes_physical",
              "cache_capacity_factor", "capacity_factor"):
        assert after[k] == before[k], k
