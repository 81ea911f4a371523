"""Retention / leakage model and the step-based refresh policy.

Same semantics as `repro.core.retention`. The paper's augmented planes
are DYNAMIC: charge leaks, and past the retention time the sense circuit
cannot recover the bit (Tables I-II: 8T 25us @85C / 250us @25C; 7T 4us
@85C / 50us @25C). Two views are kept:

  * `LeakageModel`, calibrated to those table points (the fault model's
    temperature scale and `RefreshPolicy.from_leakage` read it);
  * `RefreshPolicy`, the step budget the pools use: a unit written at
    step s is valid while step - s < retention_steps and must then be
    refreshed (re-written from its master or promoted back to Normal).
"""
from __future__ import annotations

import dataclasses
import math

import torch

# calibration points of the paper (85C with its bias knobs)
PAPER_RETENTION_US = {
    # cell: {temp_C: retention_us}
    "8T": {85: 25.0, 25: 250.0},
    "7T": {85: 4.0, 25: 50.0},
}
V_SENSE_FRACTION = 0.5  # sense succeeds while >50% of the written level remains


@dataclasses.dataclass(frozen=True)
class LeakageModel:
    """Exponential-decay leakage calibrated to the paper's two points:
    retention(T) = r25 * (r85 / r25) ** ((T - 25) / 60), log-linear in T."""
    cell: str = "8T"

    def retention_us(self, temp_c: float) -> float:
        r = PAPER_RETENTION_US[self.cell]
        r25, r85 = r[25], r[85]
        return r25 * (r85 / r25) ** ((temp_c - 25.0) / 60.0)

    def tau_us(self, temp_c: float) -> float:
        """Decay constant: the level hits V_SENSE_FRACTION at retention."""
        return self.retention_us(temp_c) / math.log(1.0 / V_SENSE_FRACTION)

    def decay(self, level: torch.Tensor, dt_us, temp_c) -> torch.Tensor:
        """Continuous decay of a stored (normalized) level after dt_us."""
        dt = torch.as_tensor(dt_us, dtype=level.dtype, device=level.device)
        return level * torch.exp(-dt / self.tau_us(temp_c))

    def readable(self, level0: torch.Tensor, dt_us, temp_c) -> torch.Tensor:
        """Can the sense circuit still recover the datum after dt_us?"""
        return self.decay(level0, dt_us, temp_c) > V_SENSE_FRACTION * level0


@dataclasses.dataclass
class RefreshPolicy:
    retention_steps: int = 1
    _written_at: int = dataclasses.field(default=-1, init=False)

    @classmethod
    def from_leakage(cls, cell: str, temp_c: float,
                     step_time_us: float) -> "RefreshPolicy":
        """The step budget from the analog model: how many steps of
        `step_time_us` fit in the cell's retention window at `temp_c`
        (at least 1, else an augmented unit could never be read back)."""
        ret_us = LeakageModel(cell=cell).retention_us(temp_c)
        return cls(retention_steps=max(1, int(ret_us // step_time_us)))

    def stamp(self, step: int) -> None:
        self._written_at = step

    def valid(self, step: int) -> bool:
        if self._written_at < 0:
            return False
        return (step - self._written_at) < self.retention_steps

    def expires_at(self) -> int:
        return self._written_at + self.retention_steps

    def age(self, step: int) -> int:
        """Steps since the last stamp (0 if never written)."""
        if self._written_at < 0:
            return 0
        return step - self._written_at

    def needs_refresh(self, step: int) -> bool:
        return self._written_at >= 0 and not self.valid(step)


def quant_error_halflife(bits: int) -> float:
    """Half-LSB error budget of a `bits`-wide symmetric plane (normalized)."""
    qmax = 2 ** (bits - 1) - 1
    return 0.5 / qmax
