"""The port's retention model (`core/retention.py`: `LeakageModel`,
`RefreshPolicy` with `from_leakage`, `quant_error_halflife`) against
`repro.core.retention` on the same inputs.

The calibration table, retention times, step budgets, half-LSB budgets
and the policy's clock must be equal exactly (the same float64 formulas).
`decay` runs in float32 on both sides (jnp and torch), so it is held to a
relative error of 1e-6 (a few float32 ulps: `exp` may round differently);
`readable` must agree exactly away from the sense threshold."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import retention as JR
from repro_torch.core import retention as TR

TEMPS = (-40.0, 0.0, 25.0, 55.0, 85.0, 105.0)


def test_paper_calibration_points():
    assert TR.PAPER_RETENTION_US == JR.PAPER_RETENTION_US
    assert TR.V_SENSE_FRACTION == JR.V_SENSE_FRACTION
    m = TR.LeakageModel("8T")
    assert m.retention_us(85.0) == 25.0 and m.retention_us(25.0) == 250.0
    m = TR.LeakageModel("7T")
    assert m.retention_us(85.0) == 4.0 and m.retention_us(25.0) == 50.0


@pytest.mark.parametrize("cell", ["8T", "7T"])
@pytest.mark.parametrize("temp", TEMPS)
def test_leakage_model_equals_jax(cell, temp):
    j, t = JR.LeakageModel(cell), TR.LeakageModel(cell)
    assert t.retention_us(temp) == j.retention_us(temp)
    assert t.tau_us(temp) == j.tau_us(temp)
    rng = np.random.default_rng(int(temp) + 100)
    level = rng.uniform(0.1, 1.0, size=64).astype(np.float32)
    dt = rng.uniform(0.0, 3 * j.retention_us(temp), size=64).astype(
        np.float32)
    want = np.asarray(j.decay(jnp.asarray(level), jnp.asarray(dt), temp))
    got = t.decay(torch.from_numpy(level), torch.from_numpy(dt),
                  temp).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # away from the sense threshold the verdicts agree exactly
    far = np.abs(dt - j.retention_us(temp)) > 1e-3 * j.retention_us(temp)
    rj = np.asarray(j.readable(jnp.asarray(level), jnp.asarray(dt), temp))
    rt = t.readable(torch.from_numpy(level), torch.from_numpy(dt),
                    temp).numpy()
    assert (rj[far] == rt[far]).all() and rt.any() and not rt.all()


@pytest.mark.parametrize("cell", ["8T", "7T"])
@pytest.mark.parametrize("temp", TEMPS)
@pytest.mark.parametrize("step_us", [0.5, 3.0, 40.0, 1e4])
def test_from_leakage_equals_jax(cell, temp, step_us):
    got = TR.RefreshPolicy.from_leakage(cell, temp, step_us)
    want = JR.RefreshPolicy.from_leakage(cell, temp, step_us)
    assert got.retention_steps == want.retention_steps >= 1


@pytest.mark.parametrize("bits", [2, 4, 8, 16])
def test_quant_error_halflife_equals_jax(bits):
    assert TR.quant_error_halflife(bits) == JR.quant_error_halflife(bits)


def test_refresh_policy_clock_equals_jax():
    for steps in (1, 3, 8):
        j, t = JR.RefreshPolicy(steps), TR.RefreshPolicy(steps)
        for s in range(12):
            if s in (0, 5, 6):
                j.stamp(s)
                t.stamp(s)
            assert (t.valid(s), t.age(s), t.needs_refresh(s),
                    t.expires_at()) == (j.valid(s), j.age(s),
                                        j.needs_refresh(s), j.expires_at())
