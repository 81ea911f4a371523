"""Retention-fault model for the augmented (dynamic) planes.

The paper's Augmented mode is DYNAMIC storage: charge leaks, and past the
retention window (Tables I-II: 8T 25us @85C / 250us @25C, 7T 4us @85C)
the sense circuit simply cannot recover the bit.  `core/retention.py`
models the *nominal* window; this module models its TAILS — the cells
that fall off the retention cliff early (process variation, hot spots),
the refresh cycles that miss their slot under bank contention, and the
rare whole-array loss (power/pd-gating event taking a macro down).

Everything is sampled DETERMINISTICALLY from `(seed, unit, step)` via a
counter-based hash, so a chaos run is exactly reproducible: the same
seed injects the same corruption at the same steps, which is what lets
the chaos harness prove token-identity against the fault-free run.

Fault probability follows the leakage physics:

  * scales with temperature through `LeakageModel.retention_us` (the
    85C/25C asymmetry of Tables I-II: a hot array faults ~10x more),
  * grows linearly with the unit's AGE within its retention window —
    freshly (re)written cells sit at full level, cells near expiry sit
    at the sense margin where variation bites,
  * becomes CERTAIN once age exceeds `retention_steps` (past the window
    the stored level is below V_SENSE_FRACTION by construction — this
    only happens after a missed refresh).

The static (Normal / 6T) plane never faults here: that is the paper's
static-survives / dynamic-decays asymmetry, and the reason the serving
stack pins repeat-offender units back to Normal mode.

`integrity_word` is the checksum over packed payload + scale bytes that
the stores stamp when a page is written and verify on every scan; the
paged pool computes the same word on the device
(`serve.cache_pool.PagedKVPool._page_words`).
"""
from __future__ import annotations

import dataclasses
import zlib

import numpy as np

from repro_torch.core.retention import LeakageModel


def integrity_word(*arrays) -> int:
    """Byte-weighted checksum over any number of arrays (packed payload
    planes + scale planes of one page/slab): word = sum_i (i + 1) * b_i
    mod 2**32 over the concatenated little-endian bytes.  The weight
    makes the word order-sensitive (a swap of two bytes changes it), and
    any single-byte corruption changes it by construction."""
    word = np.uint64(0)
    offset = 1
    for a in arrays:
        b = np.frombuffer(np.ascontiguousarray(a).tobytes(), np.uint8)
        if b.size == 0:
            continue
        w = np.arange(offset, offset + b.size, dtype=np.uint64)
        word = word + np.uint64((b.astype(np.uint64) * w).sum())
        offset += b.size
    return int(word % np.uint64(2 ** 32))


@dataclasses.dataclass(frozen=True)
class FaultModel:
    """Seeded sampler of retention faults for dynamic-plane units.

    `rate` is the per-unit, per-decode-step fault probability at the
    calibration temperature (85C) for a unit at the END of its retention
    window; younger units scale down linearly, colder arrays scale down
    through the leakage model.  `array_loss_rate` is the per-step
    probability of a whole-array failure event (handled by the engine's
    Supervisor as drain-and-requeue, not per-unit corruption)."""
    rate: float = 0.0
    seed: int = 0
    cell: str = "8T"
    temp_c: float = 85.0
    array_loss_rate: float = 0.0
    pin_threshold: int = 3

    # -- deterministic uniform draws -----------------------------------------

    def _u(self, tag: str, unit, step: int) -> float:
        """Uniform in [0, 1) from a stable hash of (seed, tag, unit, step)."""
        h = zlib.crc32(f"{self.seed}|{tag}|{unit}|{step}".encode())
        return h / 2 ** 32

    # -- physics-scaled probabilities ----------------------------------------

    def temp_scale(self) -> float:
        """Fault-rate multiplier vs the 85C calibration point: retention
        shrinks as temperature rises, so the tail probability grows in
        proportion (Tables I-II: the 8T window is 10x shorter at 85C
        than at 25C)."""
        m = LeakageModel(cell=self.cell)
        return m.retention_us(85.0) / m.retention_us(self.temp_c)

    def p_fault(self, age: int, retention_steps: int) -> float:
        """Early-expiry probability for a unit `age` steps after its last
        write under a `retention_steps` window.  age == 0 (just written,
        full level) never faults; age > retention_steps (only reachable
        after a missed refresh) always does."""
        if age <= 0:
            return 0.0
        retention_steps = max(retention_steps, 1)
        if age > retention_steps:
            return 1.0
        return min(1.0, self.rate * self.temp_scale()
                   * (age / retention_steps))

    # -- event samplers ------------------------------------------------------

    def fault(self, unit, step: int, age: int, retention_steps: int) -> bool:
        """Does dynamic unit `unit` suffer an early retention expiry at
        this step?"""
        p = self.p_fault(age, retention_steps)
        return p > 0.0 and self._u("fault", unit, step) < p

    def refresh_miss(self, unit, step: int) -> bool:
        """Does this unit's due refresh cycle miss its slot (bank
        contention)?  The unit keeps aging; past the window the NEXT
        fault draw is certain — a miss is never silent for long."""
        p = min(1.0, self.rate * self.temp_scale())
        return p > 0.0 and self._u("miss", unit, step) < p

    def array_loss(self, step: int) -> bool:
        """Whole-array failure event at this step."""
        return (self.array_loss_rate > 0.0
                and self._u("array", "loss", step) < self.array_loss_rate)

    def corruption_mask(self, unit, step: int) -> int:
        """Nonzero byte the injector XORs over the unit's packed payload
        — deterministic per (seed, unit, step), so the same chaos run
        corrupts the same bits."""
        h = zlib.crc32(f"{self.seed}|mask|{unit}|{step}".encode())
        return 1 + h % 255
