"""The core AMC library: the mode-switchable augmented store with its FILO
ledger and retention, the dual-plane and ternary formats, quantization,
retention and fault models (the port of `repro.core`)."""
from repro_torch.core.amc import (AugmentedStore, FILOViolation, Mode,
                                  RetentionExpired)
from repro_torch.core.retention import LeakageModel, RefreshPolicy

__all__ = [
    "AugmentedStore", "Mode", "FILOViolation", "RetentionExpired",
    "LeakageModel", "RefreshPolicy",
]
