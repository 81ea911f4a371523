"""Fault tolerance & straggler mitigation (host-side supervisor).

On a real cluster these hooks bind to the runtime's health API and the
coordination service; here they are driven by injectable simulators so the
behaviour is testable:

  * `Supervisor.run_step` catches worker failure (SimulatedFailure or any
    exception matching `retryable`), restores the latest checkpoint
    (including the data-iterator position) and resumes — the fault path the
    multi-pod deployment relies on.
  * `StragglerMonitor` tracks a per-step wall-time EWMA; a step slower than
    `threshold` x EWMA flags the step, and after `patience` consecutive
    flags requests mitigation (on a real pod: demote the slow host /
    re-shard its data; here: recorded + callback).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional


class SimulatedFailure(RuntimeError):
    """Injected node failure for tests/examples."""


@dataclasses.dataclass
class StragglerMonitor:
    threshold: float = 2.0
    patience: int = 3
    decay: float = 0.9
    on_straggler: Optional[Callable[[int, float, float], None]] = None
    _ewma: float = dataclasses.field(default=0.0, init=False)
    _flags: int = dataclasses.field(default=0, init=False)
    events: list = dataclasses.field(default_factory=list, init=False)
    # aggregate wall-time accumulators over every recorded step
    n_steps: int = dataclasses.field(default=0, init=False)
    total_s: float = dataclasses.field(default=0.0, init=False)
    min_s: float = dataclasses.field(default=0.0, init=False)
    max_s: float = dataclasses.field(default=0.0, init=False)

    def record(self, step: int, dt: float) -> bool:
        """Returns True if mitigation was requested at this step."""
        self.min_s = dt if self.n_steps == 0 else min(self.min_s, dt)
        self.max_s = dt if self.n_steps == 0 else max(self.max_s, dt)
        self.n_steps += 1
        self.total_s += dt
        if self._ewma == 0.0:
            self._ewma = dt
            return False
        slow = dt > self.threshold * self._ewma
        self._flags = self._flags + 1 if slow else 0
        # slow steps poison the EWMA less
        w = self.decay if not slow else 0.98
        self._ewma = w * self._ewma + (1 - w) * dt
        if self._flags >= self.patience:
            self.events.append((step, dt, self._ewma))
            if self.on_straggler:
                self.on_straggler(step, dt, self._ewma)
            self._flags = 0
            return True
        return False

    def describe(self) -> dict:
        """Pure wall-time summary of every recorded step (engine
        stats()["step_times"])."""
        return {
            "n_steps": self.n_steps,
            "min_s": self.min_s,
            "mean_s": self.total_s / self.n_steps if self.n_steps else 0.0,
            "max_s": self.max_s,
            "ewma_s": self._ewma,
            "mitigations": len(self.events),
        }


class Supervisor:
    """Wraps the train loop with catch -> restore -> resume."""

    def __init__(self, restore_fn: Callable[[], int], max_restarts: int = 5,
                 retryable=(SimulatedFailure,)):
        self.restore_fn = restore_fn
        self.max_restarts = max_restarts
        self.retryable = retryable
        self.restarts = 0

    def run_step(self, step_fn: Callable[[], None]) -> bool:
        """Returns True if the step ran, False if it was recovered."""
        try:
            step_fn()
            return True
        except self.retryable:
            self.restarts += 1
            if self.restarts > self.max_restarts:
                raise
            self.restore_fn()
            return False
