"""Logical/physical byte accounting of the augmented storage modes (the
part of `repro.core.amc` that `ServeEngine.stats()` reports)."""
from __future__ import annotations

import enum


class Mode(enum.Enum):
    NORMAL = "normal"
    AUGMENTED_DUAL = "augmented_dual"
    AUGMENTED_TERNARY = "augmented_ternary"


BITS_PER_VALUE = {
    Mode.NORMAL: 16.0,
    Mode.AUGMENTED_DUAL: 4.0,     # two int4 values per byte
    Mode.AUGMENTED_TERNARY: 1.6,  # base-3, 5 trits/byte
}

WEIGHT_MODES = {"normal": Mode.NORMAL, "dual": Mode.AUGMENTED_DUAL,
                "ternary": Mode.AUGMENTED_TERNARY}
KV_BITS_PER_VALUE = {"normal": 16.0, "int8": 8.0, "int4": 4.0}


def mode_bits_per_value(mode: Mode, ternary_fmt: str = "base3") -> float:
    """Physical bits per logical value for a storage mode."""
    if mode == Mode.AUGMENTED_TERNARY and ternary_fmt == "2bit":
        return 2.0
    return BITS_PER_VALUE[mode]
