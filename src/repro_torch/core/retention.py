"""Step-based retention window of a dynamic (Augmented) storage unit.

Same semantics as `repro.core.retention.RefreshPolicy`: a unit written
at step s is valid while step - s < retention_steps and must then be
refreshed (re-written from its master or promoted back to Normal)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class RefreshPolicy:
    retention_steps: int = 1
    _written_at: int = dataclasses.field(default=-1, init=False)

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
