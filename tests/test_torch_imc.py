"""In-memory compute in the port, held against the JAX package.

- Kernels: `quantize_activations` equals JAX's (called eagerly) bit for
  bit; the plain `imc_dot` / `imc_dual_dot` versions equal the oracles
  `repro.kernels.ref.imc_dot_ref` / `imc_dual_dot_ref` bit for bit on
  integer rows at the precision's qmax (unit activation scale, exact
  quantization: the `_int_activations` goldens of tests/test_imc.py) and
  within rel_err 0.02 on random bf16 rows; at abits 8 with unit scale
  they equal the packed matmuls' plain versions bit for bit.
- The event/energy model, `ImcEventLedger.describe()` and
  `BitSerialArray`'s logging equal `repro.imc.energy`'s to the integer.
- The engine: `stats()["imc"]` equals the JAX engine's, every event count
  of every group — int8 at matmul_impl="dense" in this process, int4 at
  "imc" in a CHILD process (the JAX engine reaches `imc_dot_pallas`,
  which this jax runs only with `pltpu.TPUCompilerParams` aliased, as in
  tests/test_torch_serve.py), where the tokens must also be identical on
  prompts whose JAX top-1/top-2 margin exceeds MIN_MARGIN at every decode
  step (checked); speculative decoding with an `imc4` draft emits the
  stepwise tokens and bills its drafts to the "draft" group.

`test_augmented_store_access_events` of tests/test_imc.py has no
counterpart: `AugmentedStore` is not ported. Its MoE test (ternary expert
banks) is ported in tests/test_torch_moe.py.
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
from repro.core import amc as jamc
from repro.core import quant as jquant
from repro.core import ternary as jternary
from repro.imc import BitSerialArray as JaxArray
from repro.imc import energy as jenergy
from repro.kernels import ref
from repro.kernels.imc_dot import quantize_activations as jax_quantize
from repro.models import model as jm
from repro.models.params import init_params as jax_init_params
from repro_torch.configs import get_arch
from repro_torch.core import amc
from repro_torch.imc import BitSerialArray, ImcEventLedger, energy
from repro_torch.kernels import ops
from repro_torch.kernels.dual_plane_matmul import dual_plane_matmul_plain
from repro_torch.kernels.imc_dot import (imc_dot_plain, imc_dual_dot_plain,
                                         mag_bits, qmax_for,
                                         quantize_activations)
from repro_torch.kernels.ternary_matmul import ternary_matmul_plain
from repro_torch.models.params import from_numpy_tree
from repro_torch.serve import Request, ServeEngine

CPU = torch.device("cpu")
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The reduced tensors are tiny: torch's intra-op threads only contend
    with XLA's thread pool in this process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tt(a) -> torch.Tensor:
    return from_numpy_tree(np.asarray(a), CPU)


def bf16(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16))


def f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def int_activations(rng, M, K, q=127) -> np.ndarray:
    """Integer-valued bf16 rows with absmax == q: unit activation scale,
    exact quantization, exact bit-serial path."""
    x = rng.integers(-q, q + 1, size=(M, K)).astype(np.float32)
    x[:, 0] = q
    return bf16(x)


def random_activations(rng, M, K) -> np.ndarray:
    x = rng.standard_normal((M, K)) * rng.uniform(0.05, 20, (M, 1))
    x[0] = 0.0                                  # a zero row
    x[1] = np.round(x[1] * 2) / 2               # half steps
    x[2] = 1.0
    x[2, 3] = 2.0                               # 1 / (2 / q): exact ties
    return bf16(x)


def weights(fmt, seed, K, N):
    """Packed weights of `fmt` from a dense numpy matrix, packed by the
    JAX package (numpy arrays: wp, scale[, lo_scale])."""
    rng = np.random.default_rng(seed)
    w = jnp.asarray(rng.standard_normal((K, N)), jnp.float32)
    if fmt == "ternary":
        t, scale = jternary.ternarize(w)
        return np.asarray(jternary.pack_ternary_2bit(t)), np.asarray(scale)
    if fmt == "int4":
        q, scale = jquant.quantize_int4(w, axis=0)
        return (np.asarray(jquant.pack_int4_pair(q[0::2], q[1::2])),
                np.asarray(scale))
    if fmt == "int8":
        q, scale = jquant.quantize_int8(w, axis=0)
        return np.asarray(q), np.asarray(scale)
    qh, sh = jquant.quantize_int4(w, axis=0)
    w2 = jnp.asarray(rng.standard_normal((K, N)), jnp.float32)
    ql, sl = jquant.quantize_int4(w2, axis=0)
    return (np.asarray(jquant.pack_int4_pair(qh, ql)), np.asarray(sh),
            np.asarray(sl))


# ---------------------------------------------------------------------------
# the activation quantizer and the plain kernels vs the JAX oracles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("abits", [1, 4, 8])
def test_quantize_activations_bit_exact_vs_jax(abits):
    """xq and xs equal JAX's `quantize_activations` called eagerly (the
    jitted form may take x * (1 / xs) and move a tie by one level)."""
    x = random_activations(np.random.default_rng(abits), 48, 256)
    jxq, jxs = jax_quantize(jnp.asarray(x), abits)
    xq, xs = quantize_activations(tt(x), abits)
    assert xq.dtype == torch.int8 and xs.dtype == torch.float32
    assert tuple(xs.shape) == (48, 1)
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jxq))
    np.testing.assert_array_equal(xs.numpy(), np.asarray(jxs))
    q = qmax_for(abits)
    assert int(xq.abs().max()) == q and not xq[0].any()
    assert mag_bits(abits) == (1 if abits == 1 else abits - 1)


@pytest.mark.parametrize("fmt", ["ternary", "int4", "int8"])
@pytest.mark.parametrize("abits", [1, 4, 8])
def test_imc_dot_plain_matches_oracle(fmt, abits):
    """Bit-exact on integer rows at the precision's qmax; rel_err < 0.02
    against the oracle on random bf16 rows."""
    M, K, N = 16, 256, 128
    wp, scale = weights(fmt, 2, K, N)
    x = int_activations(np.random.default_rng(2), M, K, q=qmax_for(abits))
    want = ref.imc_dot_ref(jnp.asarray(x), jnp.asarray(wp),
                           jnp.asarray(scale), fmt=fmt, abits=abits)
    got = imc_dot_plain(tt(x), tt(wp), tt(scale), fmt=fmt, abits=abits)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (M, N)
    np.testing.assert_array_equal(f32(got), f32(want))
    x = random_activations(np.random.default_rng(3), M, K)
    want = ref.imc_dot_ref(jnp.asarray(x), jnp.asarray(wp),
                           jnp.asarray(scale), fmt=fmt, abits=abits)
    got = imc_dot_plain(tt(x), tt(wp), tt(scale), fmt=fmt, abits=abits)
    assert ref.rel_err(f32(got), want) < 0.02


@pytest.mark.parametrize("abits", [4, 8])
def test_imc_dual_dot_plain_matches_oracle(abits):
    M, K, N = 16, 256, 128
    buf, hs, ls = weights("dual", 6, K, N)
    args = (jnp.asarray(buf), jnp.asarray(hs), jnp.asarray(ls))
    targs = (tt(buf), tt(hs), tt(ls))
    x = int_activations(np.random.default_rng(6), M, K, q=qmax_for(abits))
    want = ref.imc_dual_dot_ref(jnp.asarray(x), *args, abits=abits)
    got = imc_dual_dot_plain(tt(x), *targs, abits=abits)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(f32(g), f32(w))
    x = random_activations(np.random.default_rng(7), M, K)
    want = ref.imc_dual_dot_ref(jnp.asarray(x), *args, abits=abits)
    got = imc_dual_dot_plain(tt(x), *targs, abits=abits)
    for g, w in zip(got, want):
        assert ref.rel_err(f32(g), w) < 0.02


def test_imc_dot_bit_exact_vs_ternary_matmul():
    """At 8-bit activations with unit scale the in-array result IS the
    packed matmul's (tests/test_imc.py's acceptance golden)."""
    M, K, N = 64, 512, 256
    wp, scale = weights("ternary", 0, K, N)
    x = tt(int_activations(np.random.default_rng(0), M, K))
    got = ops.imc_dot(x, tt(wp), tt(scale), fmt="ternary", abits=8)
    assert torch.equal(got, ternary_matmul_plain(x, tt(wp), tt(scale)))


def test_imc_dual_dot_bit_exact_vs_dual_plane_matmul():
    M, K, N = 64, 256, 256
    buf, hs, ls = (tt(a) for a in weights("dual", 1, K, N))
    x = tt(int_activations(np.random.default_rng(1), M, K))
    got = ops.imc_dual_dot(x, buf, hs, ls, abits=8)
    for g, w in zip(got, dual_plane_matmul_plain(x, buf, hs, ls)):
        assert torch.equal(g, w)


def test_imc_precision_reconfigurable_monotone():
    """More activation bits, strictly better fidelity (arXiv:2008.03378)."""
    M, K, N = 64, 512, 128
    wp, scale = (tt(a) for a in weights("ternary", 7, K, N))
    x = tt(bf16(np.random.default_rng(8).standard_normal((M, K))))
    dense = ternary_matmul_plain(x, wp, scale)
    errs = [ref.rel_err(f32(ops.imc_dot(x, wp, scale, abits=a)), f32(dense))
            for a in (1, 4, 8)]
    assert errs[2] < errs[1] < errs[0], errs


def test_quantize_activations_ranges():
    x = tt(bf16(np.random.default_rng(9).standard_normal((8, 64))))
    for abits in (1, 4, 8):
        xq, xs = quantize_activations(x, abits)
        q = qmax_for(abits)
        assert int(xq.abs().max()) <= q
        err = ref.rel_err(f32(xq.float() * xs), f32(x))
        assert err < 1.0 / max(q - 1, 1) + 0.05, (abits, err)


def test_ops_take_the_plain_imc_versions_on_cpu_tensors():
    ops.reset_launch_counts()
    wp, scale = (tt(a) for a in weights("int4", 4, 128, 64))
    x = tt(bf16(np.random.default_rng(4).standard_normal((4, 128))))
    y = ops.imc_dot(x, wp, scale, fmt="int4", abits=4)
    assert torch.equal(y, imc_dot_plain(x, wp, scale, fmt="int4", abits=4))
    assert torch.equal(y, ops.imc_dot(x, wp, scale, fmt="int4", abits=4,
                                      plain=True))
    buf, hs, ls = (tt(a) for a in weights("dual", 5, 128, 64))
    yh, yl = ops.imc_dual_dot(x, buf, hs, ls, abits=1)
    wh, wl = imc_dual_dot_plain(x, buf, hs, ls, abits=1)
    assert torch.equal(yh, wh) and torch.equal(yl, wl)
    counts = ops.launch_counts()
    assert counts["imc_dot"] == counts["imc_dual_dot"] == 0


class _RecordingLibrary:
    """Stands in for the kernel library: records each entry's arguments
    instead of launching."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.mark.parametrize("fmt", ["ternary", "int4", "int8", "dual"])
def test_imc_wrapper_hands_the_library_operands_and_shapes(fmt,
                                                           monkeypatch):
    """With the library stubbed, one C call per wrapper call at every M
    (the decode route and the prepass + tiles are the C source's choice):
    x, the scratch the levels and scales come back in, the weights, the
    scales and outputs, then M, K, N, the format code and qmax, and the
    stream; no split or plan argument, one `.launches` a call, none at
    M = 0; a misaligned x is copied to an aligned one first."""
    from repro_torch.kernels import build
    from repro_torch.kernels import imc_dot as imc
    fake = _RecordingLibrary()
    monkeypatch.setattr(imc, "library", lambda: fake)
    monkeypatch.setattr(imc, "_require_cuda", lambda *a: None)
    monkeypatch.setattr(imc.torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 7}))
    K, N = 256, 128
    packed = weights(fmt, 1, K, N)
    w, scales = tt(packed[0]), [tt(a) for a in packed[1:]]
    name = "imc_dual_dot" if fmt == "dual" else "imc_dot"
    counter = imc.imc_dual_dot_cuda if fmt == "dual" else imc.imc_dot_cuda
    for M in (0, 1, 4, 16, 17, 40):
        for abits in (1, 4, 8):
            x = tt(bf16(np.ones((M, K))))
            before = counter.launches
            if fmt == "dual":
                ys, xq, xs = imc.imc_dual_dot_levels(x, w, *scales,
                                                     abits=abits)
            else:
                y, xq, xs = imc.imc_dot_levels(x, w, scales[0], fmt=fmt,
                                               abits=abits)
                ys = (y,)
            assert xq.shape == (M, K) and xq.dtype == torch.int8
            assert xs.shape == (M, 1) and xs.dtype == torch.float32
            assert all(y.shape == (M, N) and y.dtype == torch.bfloat16
                       for y in ys)
            if M == 0:
                assert not fake.calls and counter.launches == before
                continue
            assert counter.launches == before + 1
            (got, args), = fake.calls
            fake.calls.clear()
            assert got == name
            assert len(args) == len(build.SIGNATURES[name])
            code = () if fmt == "dual" else (imc.FMT_CODES[fmt],)
            assert args[0] == x.data_ptr() and args[2] == w.data_ptr()
            assert args[1] == xq.data_ptr()
            assert xs.data_ptr() == args[1] + M * K  # levels, then scales
            assert list(args[3:3 + len(scales)]) == [
                t.data_ptr() for t in scales]
            assert list(args[3 + len(scales):-5 - len(code)]) == [
                y.data_ptr() for y in ys]
            assert args[-5 - len(code):] == (M, K, N, *code,
                                             imc.qmax_for(abits), 7)
    # a misaligned x reaches the library as an aligned copy
    base = tt(bf16(np.ones((5, K + 8)))).reshape(-1)
    x = base[1:1 + 4 * K].view(4, K)
    assert x.data_ptr() % 16
    if fmt == "dual":
        imc.imc_dual_dot_levels(x, w, *scales, abits=4)
    else:
        imc.imc_dot_levels(x, w, scales[0], fmt=fmt, abits=4)
    (_, args), = fake.calls
    assert args[0] != x.data_ptr() and args[0] % 16 == 0
    with pytest.raises(ValueError, match="unsupported shapes"):
        bad = tt(bf16(np.ones((4, K - 64))))
        if fmt == "dual":
            imc.imc_dual_dot_levels(bad, w, *scales, abits=4)
        else:
            imc.imc_dot_levels(bad, w, scales[0], fmt=fmt, abits=4)


# ---------------------------------------------------------------------------
# the event/energy model against repro.imc.energy
# ---------------------------------------------------------------------------

SHAPES = [(1, 64, 32), (4, 1024, 2816), (128, 2816, 1024), (7, 2048, 512)]
STORAGES = ["dense", "ternary", "dual", "int8", "int4"]


@pytest.mark.parametrize("abits", [1, 4, 8])
def test_energy_functions_match_jax(abits):
    ledgers = (ImcEventLedger(), jenergy.ImcEventLedger())
    for M, K, N in SHAPES + [(0, 64, 32)]:
        for planes in (1, 2):
            assert energy.imc_dot_events(M, K, N, abits=abits, planes=planes) \
                == jenergy.imc_dot_events(M, K, N, abits=abits, planes=planes)
        for storage in STORAGES:
            assert energy.weight_fetch_events(K * N, storage) \
                == jenergy.weight_fetch_events(K * N, storage)
            for impl in ("dense", "packed", "imc"):
                ev = energy.matmul_events(M, K, N, storage=storage, impl=impl,
                                          abits=abits)
                assert ev == jenergy.matmul_events(
                    M, K, N, storage=storage, impl=impl, abits=abits)
                assert energy.energy_fj(ev) == jenergy.energy_fj(ev)
                for led in ledgers:
                    led.add(ev, f"{storage}/{impl}")
        for bits in (4, 8):
            assert energy.kv_read_events(M * K, N, aug_bits=bits) \
                == jenergy.kv_read_events(M * K, N, aug_bits=bits)
            assert energy.kv_write_events(M, K * N, aug_bits=bits) \
                == jenergy.kv_write_events(M, K * N, aug_bits=bits)
        assert energy.refresh_events(K * N) == jenergy.refresh_events(K * N)
        for led in ledgers:
            led.add(energy.refresh_events(K * N), "refresh")
            led.note_tokens(M)
    assert energy.EVENT_ENERGY_FJ == jenergy.EVENT_ENERGY_FJ
    assert ledgers[0].describe() == ledgers[1].describe()
    assert ledgers[0].energy_fj("refresh") == ledgers[1].energy_fj("refresh")


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "granite-3-2b"])
@pytest.mark.parametrize("reduced", [False, True])
def test_decode_matmul_events_match_jax(arch, reduced):
    tcfg, jcfg = get_arch(arch), jax_get_arch(arch)
    if reduced:
        tcfg, jcfg = tcfg.reduced(), jcfg.reduced()
    for wm in ("normal", "ternary", "dual"):
        for impl in ("dense", "packed", "imc"):
            for abits in (1, 4, 8):
                kw = dict(weight_mode=wm, matmul_impl=impl, imc_abits=abits)
                t = dataclasses.replace(tcfg, amc=dataclasses.replace(
                    tcfg.amc, **kw))
                j = dataclasses.replace(jcfg, amc=dataclasses.replace(
                    jcfg.amc, **kw))
                for n in (1, 4, 37):
                    assert energy.decode_matmul_events(t, n) \
                        == jenergy.decode_matmul_events(j, n), (wm, impl)
    bad = dataclasses.replace(tcfg, family="no-such-family")
    with pytest.raises(ValueError, match="no decode matmul model"):
        energy.decode_matmul_events(bad, 1)


def test_mode_access_events_match_jax():
    for (mode, kind), v in jamc.MODE_ACCESS_EVENTS.items():
        tmode = amc.Mode(mode.value)
        assert amc.MODE_ACCESS_EVENTS[(tmode, kind)] == v
        assert amc.mode_access_events(tmode, 37, kind) \
            == jamc.mode_access_events(mode, 37, kind)
    assert len(amc.MODE_ACCESS_EVENTS) == len(jamc.MODE_ACCESS_EVENTS)
    for n, bits, kind in ((0, 4, "read"), (9, 4, "read"), (9, 8, "write")):
        assert amc.dynamic_plane_access_events(n, bits, kind) \
            == jamc.dynamic_plane_access_events(n, bits, kind)


def test_imc_event_counts_scale_with_precision():
    e4 = energy.imc_dot_events(2, 64, 32, abits=4)
    e8 = energy.imc_dot_events(2, 64, 32, abits=8)
    assert e4["wordline"] == 2 * 64 * 3 and e8["wordline"] == 2 * 64 * 7
    assert e4["adc"] == 2 * 32 * 3
    assert energy.energy_fj(e4) < energy.energy_fj(e8)


def test_dual_plane_shares_wordlines():
    """ONE wordline stream drives BOTH planes: 2x bitline/ADC, 1x WL."""
    e1 = energy.imc_dot_events(1, 64, 32, abits=8, planes=1)
    e2 = energy.imc_dot_events(1, 64, 32, abits=8, planes=2)
    assert e2["wordline"] == e1["wordline"]
    assert e2["bitline"] == 2 * e1["bitline"]
    assert e2["adc"] == 2 * e1["adc"]


def test_augmented_reads_cost_differently_from_normal():
    """Augmented cells cost more per cell, fewer cells per value."""
    E = energy.EVENT_ENERGY_FJ
    assert E["read_8t_dynamic"] > E["read_6t"] and E["read_7t"] > E["read_6t"]
    assert 1 * E["read_7t"] < 4 * E["read_8t_dynamic"] < 16 * E["read_6t"]
    ev = energy.kv_read_events(10, 10, aug_bits=4)
    assert ev["read_6t"] == 160 and ev["read_8t_dynamic"] == 40


def test_matmul_events_by_impl():
    fetch = energy.matmul_events(4, 256, 128, storage="ternary",
                                 impl="packed")
    imc = energy.matmul_events(4, 256, 128, storage="ternary", impl="imc",
                               abits=8)
    assert fetch == {"read_7t": 256 * 128}
    assert "wordline" in imc and "read_7t" not in imc
    dense = energy.matmul_events(4, 256, 128, storage="dense", impl="imc")
    assert dense == {"read_6t": 16 * 256 * 128}


@pytest.mark.parametrize("fmt", ["ternary", "int8", "int4", "dual"])
def test_bit_serial_array_matches_jax(fmt):
    """The same resident bytes and scales as the JAX array built from the
    same dense weights (the ternary scale within rtol 1e-6), the events the JAX array logs for the same call
    (`energy.imc_dot_events` at its K, N and planes), and the oracle's
    result."""
    rng = np.random.default_rng(10)
    K, N, M = 256, 128, 8
    w = rng.standard_normal((K, N)).astype(np.float32)
    w2 = rng.standard_normal((K, N)).astype(np.float32)
    ledger = ImcEventLedger()
    if fmt == "dual":
        arr = BitSerialArray.from_dense_pair(tt(w), tt(w2), ledger=ledger)
        jarr = JaxArray.from_dense_pair(jnp.asarray(w), jnp.asarray(w2))
    else:
        arr = BitSerialArray.from_dense(tt(w), fmt=fmt, ledger=ledger)
        jarr = JaxArray.from_dense(jnp.asarray(w), fmt=fmt)
    assert (arr.K, arr.N) == (jarr.K, jarr.N) == (K, N)
    np.testing.assert_array_equal(arr.wp.numpy(), np.asarray(jarr.wp))
    # the TWN scale is a float32 mean: summed in another order than JAX's
    # (tests/test_torch_formats.py holds it to rtol 1e-6); the int scales
    # are bit-exact
    np.testing.assert_allclose(arr.scale.numpy(), np.asarray(jarr.scale),
                               rtol=1e-6 if fmt == "ternary" else 0)
    if fmt == "dual":
        np.testing.assert_array_equal(arr.lo_scale.numpy(),
                                      np.asarray(jarr.lo_scale))
    assert arr.physical_bytes() == jarr.physical_bytes()
    x = bf16(rng.standard_normal((M, K)))
    y = arr.dot(tt(x))
    y4 = arr.dot(tt(x), abits=4)
    planes = 2 if fmt == "dual" else 1
    want = ImcEventLedger()
    for a in (8, 4):
        want.add(jenergy.imc_dot_events(M, jarr.K, jarr.N, abits=a,
                                        planes=planes), "imc_dot")
    assert ledger.describe() == want.describe()
    assert ledger.counts[("imc_dot", "wordline")] == M * K * (7 + 3)
    if fmt == "dual":
        want = ref.imc_dual_dot_ref(jnp.asarray(x), jarr.wp, jarr.scale,
                                    jarr.lo_scale, abits=8)
        for g, r in zip(y, want):
            assert ref.rel_err(f32(g), r) < 0.02
        assert tuple(y4[0].shape) == (M, N)
    else:
        want = ref.imc_dot_ref(jnp.asarray(x), jarr.wp, jarr.scale, fmt=fmt,
                               abits=8)
        assert ref.rel_err(f32(y), want) < 0.02
        assert tuple(y4.shape) == (M, N)


# ---------------------------------------------------------------------------
# the engine: stats()["imc"] and tokens against the JAX engine
# ---------------------------------------------------------------------------

MIN_MARGIN = 1e-2
# 3 requests on 2 rows (queueing, row reuse, a stepwise-free chunked
# prefill) and a 2-step retention window, so every group the ledger has
# (weights, kv_read, kv_write, refresh) is billed
SPEC = {"engine": {"max_batch": 2, "max_seq": 64, "prefill_chunk": 8,
                   "retention_steps": 2},
        "prompt_lens": [20, 14, 9], "prompt_seed": 4, "max_new": 6}


def prompts():
    rng = np.random.default_rng(SPEC["prompt_seed"])
    return [rng.integers(0, 512, size=n).astype(np.int32)
            for n in SPEC["prompt_lens"]]


def _jax_ledger_oracle(kv_mode, matmul_impl, params, spec, prompts):
    """Serve `prompts` with the JAX engine (kv_impl="dequant", the given
    matmul_impl at 8-bit activations); return tokens, the smallest
    top-1/top-2 margin of any decode step and `stats()["imc"]`. Runs both
    here and, by source, in the child process."""
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
        cfg.amc, kv_impl="dequant", matmul_impl=matmul_impl, imc_abits=8))
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    eng = RecordingEngine(cfg, mesh, params=params, kv_mode=kv_mode,
                          **spec["engine"])
    out = eng.generate([Request(prompt=np.asarray(p, np.int32),
                                max_new_tokens=spec["max_new"], id=i)
                        for i, p in enumerate(prompts)])
    return {"tokens": {str(k): [int(t) for t in v] for k, v in out.items()},
            "min_margin": eng.min_margin, "imc": eng.stats()["imc"]}


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
out = _jax_ledger_oracle("int4", "imc", params, args["spec"], args["prompts"])
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
    dense_cfg = dataclasses.replace(cfg, amc=dataclasses.replace(
        cfg.amc, weight_mode="normal"))
    return jax_init_params(jm.abstract_params(dense_cfg),
                           jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def oracles(dense_params, tmp_path_factory):
    """JAX results: int4 at matmul_impl="imc" from the child process
    (started first), int8 at "dense" in this process meanwhile."""
    tmp = tmp_path_factory.mktemp("imc_oracle")
    np.savez(tmp / "params.npz", **{
        k: (np.asarray(v).view(np.uint16)
            if np.asarray(v).dtype.name == "bfloat16" else np.asarray(v))
        for k, v in _flatten(jax.tree.map(np.asarray, dense_params))})
    ps = [p.tolist() for p in prompts()]
    args = {"params": str(tmp / "params.npz"), "out": str(tmp / "imc.json"),
            "spec": SPEC, "prompts": ps}
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join(
               [str(REPO / "src"), os.environ.get("PYTHONPATH", "")])}
    child = subprocess.Popen(
        [sys.executable, "-c",
         CHILD % inspect.getsource(_jax_ledger_oracle), json.dumps(args)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        res = {("int8", "dense"): _jax_ledger_oracle(
            "int8", "dense", dense_params, SPEC, ps)}
        log, _ = child.communicate(timeout=600)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    assert child.returncode == 0, log[-4000:]
    with open(tmp / "imc.json") as f:
        res[("int4", "imc")] = json.load(f)
    return res


@pytest.fixture(scope="module")
def torch_params(dense_params):
    return from_numpy_tree(jax.tree.map(np.asarray, dense_params), CPU)


def torch_engine(params, **kw):
    return ServeEngine(get_arch("qwen1.5-0.5b").reduced(), device="cpu",
                       params=params, **kw)


@pytest.mark.parametrize("kv_mode,matmul_impl", [("int8", "dense"),
                                                 ("int4", "imc")])
def test_engine_imc_ledger_matches_jax(oracles, torch_params, kv_mode,
                                       matmul_impl):
    want = oracles[(kv_mode, matmul_impl)]
    eng = torch_engine(torch_params, kv_mode=kv_mode, matmul_impl=matmul_impl,
                       imc_abits=8, **SPEC["engine"])
    out = eng.generate([Request(prompt=p, max_new_tokens=SPEC["max_new"],
                                id=i) for i, p in enumerate(prompts())])
    got = eng.stats()["imc"]
    exp = want["imc"]
    assert {g: d["events"] for g, d in got["groups"].items()} \
        == {g: d["events"] for g, d in exp["groups"].items()}
    assert set(got["groups"]) == {"weights", "kv_read", "kv_write",
                                  "refresh"}
    for key in ("tokens", "matmul_impl", "imc_abits",
                "kv_read_fj_per_value_normal_mode",
                "kv_read_fj_per_value_augmented_mode", "event_energy_fj"):
        assert got[key] == exp[key], key
    for key in ("energy_fj_total", "energy_pj_per_token",
                "refresh_energy_fj"):
        assert got[key] == pytest.approx(exp[key], rel=1e-12), key
    weights = got["groups"]["weights"]["events"]
    if matmul_impl == "imc":
        assert set(weights) == {"wordline", "bitline", "adc"}
        assert want["min_margin"] > MIN_MARGIN, \
            f"prompt set sits on an argmax near-tie ({want['min_margin']})"
    else:
        assert set(weights) == {"read_7t"}
    # greedy tokens: identical wherever the JAX margins are clear of ties
    if want["min_margin"] > MIN_MARGIN:
        assert {str(k): v for k, v in out.items()} == want["tokens"]


def test_engine_imc_routing_decodes_and_accounts(torch_params):
    eng = torch_engine(torch_params, weight_mode="ternary", matmul_impl="imc",
                       imc_abits=8, max_batch=2, max_seq=64,
                       prefill_chunk=16)
    out = eng.generate([Request(prompt=np.array([3, 5, 7], np.int32),
                                max_new_tokens=4, id=0)])
    assert len(out[0]) == 4
    imc = eng.stats()["imc"]
    assert imc["matmul_impl"] == "imc" and imc["imc_abits"] == 8
    w = imc["groups"]["weights"]["events"]
    assert "wordline" in w and "adc" in w
    assert imc["energy_fj_total"] > 0 and imc["tokens"] == 2 + 4
    assert imc["energy_pj_per_token"] > 0


def test_engine_imc_logits_close_to_packed(torch_params):
    """abits=8 activation quantization is a small perturbation of the
    packed path on the same packed weights (the JAX package's bar)."""
    from repro_torch.models import augment
    from repro_torch.models import model as M
    from repro_torch.serve.cache_pool import PagedKVPool
    cfg = get_arch("qwen1.5-0.5b").reduced()
    packed = augment.augment_params(cfg, torch_params)
    logits = {}
    for impl in ("packed", "imc"):
        c = dataclasses.replace(cfg, amc=dataclasses.replace(
            cfg.amc, matmul_impl=impl, imc_abits=8))
        pool = PagedKVPool(c, max_batch=2, max_seq=32, device=CPU)
        for r in range(2):
            pool.admit_row(r, 8, step=0)
        tokens = np.random.default_rng(1).integers(0, cfg.vocab, (2, 8))
        batch = {**pool.device_tables(),
                 "tokens": torch.from_numpy(tokens.astype(np.int32)),
                 "positions": torch.zeros(2, dtype=torch.int32),
                 "write_mask": torch.ones(2, dtype=torch.bool)}
        with torch.no_grad():
            lg, _ = M.paged_prefill_step(c, packed, pool.arenas, batch)
        logits[impl] = f32(lg[..., :cfg.vocab])
    assert ref.rel_err(logits["imc"], logits["packed"]) < 0.1


def test_engine_kv_read_event_classes_follow_page_mode(torch_params):
    """Normal pools bill read_6t for cache reads, Augmented pools the 8T
    dynamic-read events, at different per-value cost."""
    st = {}
    for kv_mode in ("normal", "int4"):
        eng = torch_engine(torch_params, kv_mode=kv_mode, max_batch=2,
                           max_seq=64, prefill_chunk=16)
        eng.generate([Request(prompt=np.array([3, 5, 7], np.int32),
                              max_new_tokens=3, id=0)])
        st[kv_mode] = eng.stats()["imc"]
    assert set(st["normal"]["groups"]["kv_read"]["events"]) == {"read_6t"}
    assert set(st["int4"]["groups"]["kv_read"]["events"]) \
        == {"read_8t_dynamic"}
    assert st["normal"]["kv_read_fj_per_value_normal_mode"] \
        != st["int4"]["kv_read_fj_per_value_augmented_mode"]


def test_refresh_traffic_folds_into_energy_total(torch_params):
    """Pool refresh maintenance shows up in the ledger's "refresh" group
    and hence in energy_fj_total."""
    eng = torch_engine(torch_params, kv_mode="int4", retention_steps=2,
                       max_batch=2, max_seq=64, prefill_chunk=16)
    eng.generate([Request(prompt=np.array([3, 5, 7], np.int32),
                          max_new_tokens=40, id=0)])
    imc = eng.stats()["imc"]
    assert eng.store.stats["refreshes"] > 0
    refresh_fj = imc["groups"]["refresh"]["energy_fj"]
    assert refresh_fj > 0 and imc["refresh_energy_fj"] == refresh_fj
    assert imc["groups"]["refresh"]["events"]["refresh_cell"] \
        == 4 * eng.store.stats["refresh_bytes"]
    others = sum(d["energy_fj"] for g, d in imc["groups"].items()
                 if g != "refresh")
    assert imc["energy_fj_total"] == pytest.approx(others + refresh_fj)


# reduced configs; (arch, prompt seed): each seed keeps every stepwise
# decode step's top-1/top-2 margin clear of ties on the port's CPU path
SPEC_CASES = {"qwen_ternary": ("qwen1.5-0.5b", 4),
              "granite_dual": ("granite-3-2b", 1)}


@pytest.mark.parametrize("case", sorted(SPEC_CASES))
def test_spec_imc4_draft_matches_stepwise(case):
    """spec_k=4 with a 4-bit IMC draft emits exactly the stepwise tokens;
    the drafts are billed to "draft" as in-array events at 4-bit
    activations (3 cycles), the verify and stepwise dispatches to
    "weights"."""
    arch, seed = SPEC_CASES[case]
    cfg = get_arch(arch).reduced()
    rng = np.random.default_rng(seed)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab, size=n).astype(
        np.int32), max_new_tokens=m, id=i)
        for i, (n, m) in enumerate([(5, 9), (9, 6), (3, 7)])]
    outs, engs = {}, {}
    for k in (1, 4):
        eng = ServeEngine(cfg, device="cpu", max_batch=2, max_seq=40,
                          prefill_chunk=8, seed=0, spec_k=k,
                          spec_draft_impl="imc4")
        outs[k] = eng.generate([dataclasses.replace(r) for r in reqs])
        engs[k] = eng
    assert outs[4] == outs[1]
    st = engs[4].stats()
    sp, imc = st["spec"], st["imc"]
    assert sp["draft_dispatches"] == 3 * sp["verify_dispatches"] > 0
    assert engs[4]._draft_cfg.amc.matmul_impl == "imc"
    assert engs[4]._draft_cfg.amc.imc_abits == 4
    draft = imc["groups"]["draft"]["events"]
    assert draft["wordline"] > 0 and draft["adc"] > 0
    assert "wordline" not in imc["groups"]["weights"]["events"]
    # 3 magnitude-bit cycles a token: wordline = 3 * sum of K over the
    # draft's in-array matmuls, for every drafted row
    per_row = energy.decode_matmul_events(engs[4]._draft_cfg, 1)
    assert per_row["wordline"] % 3 == 0
    assert draft["wordline"] % per_row["wordline"] == 0
    assert imc["tokens"] == engs[1].stats()["imc"]["tokens"]


def test_unknown_matmul_impl_raises():
    from repro_torch.configs.base import AMCConfig
    from repro_torch.models import augment
    wp, scale = (tt(a) for a in weights("ternary", 13, 8, 8))
    x = torch.ones((4, 8), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="matmul_impl"):
        augment.ternary_apply(x, wp, scale,
                              amc=AMCConfig(matmul_impl="nonsense"))
    y = augment.ternary_apply(x, wp, scale,
                              amc=AMCConfig(matmul_impl="imc", imc_abits=4))
    assert torch.equal(y, imc_dot_plain(x, wp, scale, fmt="ternary",
                                        abits=4))
