"""The core stores of the port held against the JAX package: the 8T dual
plane (`core/dual_plane.py`), the mode-switchable `AugmentedStore` with
its FILO ledger, retention expiry and refresh, capacity accounting and
access events (`core/amc.py`), and stochastic rounding in `core/quant.py`.

Mirrors the dual-plane and store tests of tests/test_core_amc.py:112-220
and tests/test_imc.py:227, and holds every deterministic byte and scale
bit for bit against the JAX store fed the same inputs (JAX runs in this
process: `repro.core` reaches no Pallas call). Stochastic rounding draws
from a `torch.Generator` where JAX takes a key, so its draws are held
statistically on 65,536+ values: every level within one of the
deterministic level, the mean error within 3 standard errors of 0, the
same draws for the same seed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import amc as jamc
from repro.core import dual_plane as jdp
from repro.core import quant as jquant
from repro_torch.core import amc
from repro_torch.core import dual_plane as dp
from repro_torch.core import quant
from repro_torch.core import (AugmentedStore, FILOViolation, Mode,
                              RetentionExpired)

CPU = torch.device("cpu")
FMTS = ("base3", "2bit")


def rnd(shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def bits(a) -> np.ndarray:
    """Bytes of a torch tensor or a JAX array, bf16 as uint16."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def same(got, want, what="") -> None:
    g, w = bits(got), bits(want)
    assert g.shape == w.shape and g.dtype == w.dtype, (what, g.dtype,
                                                       w.dtype)
    np.testing.assert_array_equal(g, w, err_msg=what)


def store(shape, **kw) -> AugmentedStore:
    return AugmentedStore(shape, device=CPU, **kw)


# ---------------------------------------------------------------------------
# dual plane
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_dual_plane_bytes_match_jax(dtype):
    w, a = rnd((32, 48), 0), rnd((32, 48), 1)
    tdt, jdt = ((torch.float32, jnp.float32) if dtype == "f32"
                else (torch.bfloat16, jnp.bfloat16))
    t = dp.write_static(dp.alloc((32, 48), device="cpu"),
                        torch.from_numpy(w).to(tdt))
    j = jdp.write_static(jdp.alloc((32, 48)), jnp.asarray(w, jdt))
    same(t.buf, j.buf, "static buf")
    same(t.static_scale, j.static_scale, "static scale")
    t = dp.write_dynamic(t, torch.from_numpy(a).to(tdt))
    j = jdp.write_dynamic(j, jnp.asarray(a, jdt))
    same(t.buf, j.buf, "dual buf")
    same(t.dynamic_scale, j.dynamic_scale, "dynamic scale")
    for read in ("read_static", "read_dynamic", "read_static_q",
                 "read_dynamic_q"):
        same(getattr(dp, read)(t), getattr(jdp, read)(j), read)


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a CPU-only "
                    "torch: the bare call resolves to the card")
def test_dual_plane_alloc_defaults_to_the_card():
    """alloc() without a device resolves it as every constructor of the
    port does: CUDA, so it raises on a CPU-only torch rather than falling
    back to the CPU."""
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dp.alloc((4, 4))
    assert dp.alloc((4, 4), device="cpu").buf.device.type == "cpu"


def test_dual_plane_planes_independent():
    d = dp.write_static(dp.alloc((32, 32), device="cpu"),
                        torch.from_numpy(rnd((32, 32), 0)))
    static0 = dp.read_static(d).clone()
    d = dp.write_dynamic(d, torch.from_numpy(rnd((32, 32), 1)))
    assert torch.equal(dp.read_static(d), static0)


def test_dual_plane_static_write_destroys_dynamic():
    d = dp.write_static(dp.alloc((16, 16), device="cpu"),
                        torch.from_numpy(rnd((16, 16), 0)))
    d = dp.write_dynamic(d, torch.from_numpy(rnd((16, 16), 1)))
    assert (dp.read_dynamic_q(d) != 0).any()
    d = dp.write_static(d, torch.from_numpy(rnd((16, 16), 2)))
    assert (dp.read_dynamic_q(d) == 0).all()


def test_dual_plane_quantization_error_bounded():
    w = rnd((64, 64), 2)
    d = dp.write_static(dp.alloc((64, 64), device="cpu"),
                        torch.from_numpy(w), axis=0)
    err = np.abs(dp.read_static(d).float().numpy() - w)
    lsb = d.static_scale.numpy()
    assert (err <= lsb * 0.75 + 1e-3).all()


# ---------------------------------------------------------------------------
# AugmentedStore
# ---------------------------------------------------------------------------

def test_store_filo_violation_raises_and_force_destroys():
    st_ = store((16, 16))
    st_.write_static(torch.from_numpy(rnd((16, 16), 0)))
    st_.set_mode(Mode.AUGMENTED_DUAL)
    st_.push_dynamic(torch.from_numpy(rnd((16, 16), 1)))
    assert (st_._dual.buf & 0x0F).any()
    with pytest.raises(FILOViolation):
        st_.read_static()
    with pytest.raises(FILOViolation):
        st_.set_mode(Mode.NORMAL)
    # force=True is the physics: the access zeroes the dynamic nibble
    _ = st_.read_static(force=True)
    assert not st_.dynamic_live
    assert st_.stats["filo_faults"] == 1
    assert not (st_._dual.buf & 0x0F).any()


def test_store_filo_drain_then_static_ok():
    st_ = store((8, 8))
    st_.write_static(torch.ones((8, 8)))
    st_.set_mode(Mode.AUGMENTED_DUAL)
    st_.push_dynamic(torch.ones((8, 8)) * 0.5)
    _ = st_.pop_dynamic()
    _ = st_.read_static()
    with pytest.raises(RuntimeError, match="no live dynamic data"):
        st_.pop_dynamic()


def test_store_retention_expiry_and_refresh():
    st_ = store((8, 8), retention_steps=2)
    st_.write_static(torch.ones((8, 8)))
    st_.set_mode(Mode.AUGMENTED_DUAL)
    st_.push_dynamic(torch.ones((8, 8)) * 0.25)
    st_.tick(3)
    with pytest.raises(RetentionExpired):
        st_.pop_dynamic()
    with pytest.raises(RetentionExpired):
        st_.peek_dynamic()
    st_.refresh(torch.ones((8, 8)) * 0.25)
    out = st_.pop_dynamic()
    assert np.allclose(out.float().numpy(), 0.25, atol=0.05)
    assert st_.stats["refreshes"] == 1


@pytest.mark.parametrize("fmt", FMTS)
def test_store_capacity_factors(fmt):
    """tests/test_core_amc.py's (10, 16) store; (20, 16) for the 2-bit
    format, whose packing takes 4 rows a byte."""
    shape = (10, 16) if fmt == "base3" else (20, 16)
    n = shape[0] * shape[1]
    st_ = store(shape, ternary_fmt=fmt)
    assert st_.capacity_factor() == 1.0
    assert st_.physical_bytes() == 2 * n
    st_.set_mode(Mode.AUGMENTED_DUAL)
    assert st_.capacity_factor() == 4.0
    assert st_.physical_bytes() == n          # one byte a logical index
    st_.set_mode(Mode.AUGMENTED_TERNARY)
    assert st_.capacity_factor() == (10.0 if fmt == "base3" else 8.0)
    assert st_.physical_bytes() == (n // 5 if fmt == "base3" else n // 4)


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("n", [1, 4, 5, 7, 160, 1001, 65536, 1 << 20])
def test_capacity_factor_and_physical_bytes_agree(n, fmt):
    """tests/test_core_amc.py's property on a grid of sizes, and every
    figure equal to the JAX package's."""
    for mode in Mode:
        jmode = jamc.Mode(mode.value)
        bpv = amc.mode_bits_per_value(mode, fmt)
        assert bpv == jamc.mode_bits_per_value(jmode, fmt)
        assert amc.capacity_factor(mode, fmt) == jamc.capacity_factor(
            jmode, fmt)
        assert amc.capacity_factor(mode, fmt) * bpv == pytest.approx(16.0)
        g = 5 if mode is Mode.AUGMENTED_TERNARY and fmt == "base3" else \
            4 if mode is Mode.AUGMENTED_TERNARY else 1
        nn = -(-n // g) * g
        phys = amc.mode_physical_bytes(nn, mode, fmt)
        values = 2 * nn if mode is Mode.AUGMENTED_DUAL else nn
        assert phys * 8 == pytest.approx(values * bpv), (mode, fmt, nn)
        exact = amc.mode_physical_bytes(n, mode, fmt)
        assert exact == jamc.mode_physical_bytes(n, jmode, fmt)
        lower = (2 * n if mode is Mode.AUGMENTED_DUAL else n) * bpv / 8
        assert lower <= exact < lower + 1 + 1e-9, (mode, fmt, n)


def _physical_tensors(st_) -> int:
    """Bytes the store really holds for its current mode's data."""
    if st_.mode == Mode.NORMAL:
        return st_._dense.numel() * st_._dense.element_size()
    if st_.mode == Mode.AUGMENTED_DUAL:
        return st_._dual.buf.numel()
    return st_._tern_packed.numel()


def _state(st_) -> dict:
    """The store's tensors as they stand (either package)."""
    out = {}
    if st_._dense is not None:
        out["dense"] = st_._dense
    if st_._dual is not None:
        out.update(buf=st_._dual.buf, static_scale=st_._dual.static_scale,
                   dynamic_scale=st_._dual.dynamic_scale)
    if st_.mode == Mode.AUGMENTED_TERNARY or (
            getattr(st_.mode, "value", None) == "augmented_ternary"):
        out.update(tern=st_._tern_packed, tern_scale=st_._tern_scale)
    return out


@pytest.mark.parametrize("fmt", FMTS)
def test_store_matches_jax_through_modes(fmt):
    """NORMAL -> AUGMENTED_DUAL -> push / peek / pop -> AUGMENTED_TERNARY
    -> NORMAL on the same inputs in both packages: every byte and scale,
    every read, the events, energy and stats equal; physical_bytes equals
    what the store holds in each mode."""
    shape = (20, 24)
    t, j = store(shape, ternary_fmt=fmt), jamc.AugmentedStore(
        shape, ternary_fmt=fmt)
    w, a = rnd(shape, 3), rnd(shape, 4)

    def check(what):
        assert t.mode.value == j.mode.value, what
        ts, js = _state(t), _state(j)
        assert set(ts) == set(js), what
        for k in ts:
            same(ts[k], js[k], f"{what}: {k}")
        assert t.events == j.events, what
        assert t.stats == j.stats, what
        assert t.physical_bytes() == j.physical_bytes() \
            == _physical_tensors(t), what

    t.write_static(torch.from_numpy(w))
    j.write_static(jnp.asarray(w))
    check("normal")
    for mode in (Mode.AUGMENTED_DUAL,):
        t.set_mode(mode)
        j.set_mode(jamc.Mode(mode.value))
    check("dual")
    same(t.read_static(), j.read_static(), "dual static read")
    t.push_dynamic(torch.from_numpy(a))
    j.push_dynamic(jnp.asarray(a))
    check("pushed")
    same(t.peek_dynamic(), j.peek_dynamic(), "peek")
    same(t.pop_dynamic(), j.pop_dynamic(), "pop")
    check("popped")
    t.set_mode(Mode.AUGMENTED_TERNARY)
    j.set_mode(jamc.Mode.AUGMENTED_TERNARY)
    check("ternary")
    same(t.read_static(), j.read_static(), "ternary read")
    t.set_mode(Mode.NORMAL)
    j.set_mode(jamc.Mode.NORMAL)
    check("normal again")
    assert t.energy_fj() == pytest.approx(j.energy_fj(), rel=1e-12)


def test_store_force_clobber_matches_jax():
    shape = (16, 16)
    t, j = store(shape), jamc.AugmentedStore(shape)
    for s_, x in ((t, torch.from_numpy(rnd(shape, 5))),
                  (j, jnp.asarray(rnd(shape, 5)))):
        s_.write_static(x)
    t.set_mode(Mode.AUGMENTED_DUAL)
    j.set_mode(jamc.Mode.AUGMENTED_DUAL)
    t.push_dynamic(torch.from_numpy(rnd(shape, 6)))
    j.push_dynamic(jnp.asarray(rnd(shape, 6)))
    t.write_static(torch.from_numpy(rnd(shape, 7)), force=True)
    j.write_static(jnp.asarray(rnd(shape, 7)), force=True)
    same(t._dual.buf, j._dual.buf, "forced static write")
    assert not (t._dual.buf & 0x0F).any() and not t.dynamic_live


def test_augmented_store_access_events():
    """tests/test_imc.py:227."""
    st_ = store((8, 8))
    st_.write_static(torch.ones((8, 8)))
    assert st_.events == {"write_6t": 16 * 64}
    st_.set_mode(Mode.AUGMENTED_DUAL)
    st_.push_dynamic(torch.ones((8, 8)) * 0.5)
    _ = st_.pop_dynamic()
    assert st_.events["write_8t_dynamic"] == 4 * 64
    assert st_.events["read_8t_dynamic"] == 4 * 64
    assert st_.energy_fj() > 0


def test_store_lives_on_the_card_unless_asked():
    if torch.cuda.is_available():
        assert AugmentedStore((4, 4))._dense.is_cuda
    else:
        with pytest.raises(RuntimeError):
            AugmentedStore((4, 4))
    assert store((4, 4))._dense.device == CPU


# ---------------------------------------------------------------------------
# quantization: deterministic bits, stochastic statistics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits_", [4, 8])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_deterministic_quantize_matches_jax(bits_, dtype):
    x = rnd((64, 96), 8) * 3
    tdt, jdt = ((torch.float32, jnp.float32) if dtype == "f32"
                else (torch.bfloat16, jnp.bfloat16))
    tq = quant.quantize_int4 if bits_ == 4 else quant.quantize_int8
    jq = jquant.quantize_int4 if bits_ == 4 else jquant.quantize_int8
    for axis in (0, -1):
        q, s = tq(torch.from_numpy(x).to(tdt), dim=axis)
        jqv, js = jq(jnp.asarray(x, jdt), axis=axis)
        same(q, jqv, f"levels axis {axis}")
        same(s, js, f"scale axis {axis}")


N_STOCH = 1 << 17


@pytest.mark.parametrize("bits_", [4, 8])
def test_stochastic_rounding_statistics(bits_):
    qmax = quant.INT4_MAX if bits_ == 4 else quant.INT8_MAX
    fn = quant.quantize_int4 if bits_ == 4 else quant.quantize_int8
    x = torch.from_numpy(rnd((N_STOCH // 256, 256), 9))
    det, scale = fn(x)
    gen = torch.Generator().manual_seed(11)
    q, s2 = fn(x, stochastic=True, generator=gen)
    assert torch.equal(s2, scale) and q.dtype == torch.int8
    assert q.numel() >= 65536
    assert (q.int() - det.int()).abs().max() <= 1
    assert q.abs().max() <= qmax
    # unbiased: E[q] = x / scale away from the clip (the row maxima sit
    # at +-qmax exactly)
    y = x / scale
    err = (q.double() - y.double())
    mean, se = err.mean(), err.std() / err.numel() ** 0.5
    assert abs(float(mean)) < 3 * float(se), (float(mean), float(se))
    # the error of a level is uniform-like: about a third of the values
    # take the other neighbour than round() does
    moved = float((q != det).float().mean())
    assert 0.15 < moved < 0.5, moved


def test_stochastic_rounding_same_draws_for_same_seed():
    x = torch.from_numpy(rnd((256, 256), 10))
    a = quant.quantize_int4(x, stochastic=True,
                            generator=torch.Generator().manual_seed(3))[0]
    b = quant.quantize_int4(x, stochastic=True,
                            generator=torch.Generator().manual_seed(3))[0]
    c = quant.quantize_int4(x, stochastic=True,
                            generator=torch.Generator().manual_seed(4))[0]
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="Generator"):
        quant.quantize_int4(x, stochastic=True)


def test_stochastic_dynamic_write_is_unbiased():
    """The store's dynamic write with stochastic rounding (the paper's
    word-line boosting): a weak value below half an LSB lands on the
    next level in proportion, so the mean read-back tracks the value."""
    st_ = store((256, 256))
    st_.write_static(torch.ones((256, 256)))
    st_.set_mode(Mode.AUGMENTED_DUAL)
    x = torch.full((256, 256), 0.3)
    x[:, 0] = 7.0                       # each row's scale: 1.0 per level
    gen = torch.Generator().manual_seed(0)
    st_.push_dynamic(x, stochastic=True, generator=gen)
    got = st_.pop_dynamic().float()[:, 1:]
    assert set(torch.unique(got).tolist()) <= {0.0, 1.0}
    assert abs(float(got.mean()) - 0.3) < 3 * (0.3 * 0.7 / got.numel()) ** 0.5
