"""Logical/physical byte accounting of the augmented storage modes and
their array access events (the parts of `repro.core.amc` that
`ServeEngine.stats()` and the IMC event ledger use)."""
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


# Array access events per logical VALUE, by mode (the paper's Tables
# III/IV access structure; per-event energies live in `imc.energy`).
# NORMAL reads 16 6T cells per bf16 value; AUGMENTED_DUAL touches 4 8T
# cells per int4 value (static plane sensed through the dynamic node,
# dynamic plane with the boosted WL); AUGMENTED_TERNARY reads one 7T cell
# per trit.
MODE_ACCESS_EVENTS = {
    (Mode.NORMAL, "read"): ("read_6t", 16),
    (Mode.NORMAL, "write"): ("write_6t", 16),
    (Mode.AUGMENTED_DUAL, "read"): ("read_8t_static", 4),
    (Mode.AUGMENTED_DUAL, "read_dynamic"): ("read_8t_dynamic", 4),
    (Mode.AUGMENTED_DUAL, "write"): ("write_8t_dual", 4),
    (Mode.AUGMENTED_DUAL, "write_dynamic"): ("write_8t_dynamic", 4),
    (Mode.AUGMENTED_TERNARY, "read"): ("read_7t", 1),
    (Mode.AUGMENTED_TERNARY, "write"): ("write_7t", 1),
}


def mode_access_events(mode: Mode, n_values: int, kind: str) -> dict:
    """{event_class: count} of one `kind` access to `n_values` values
    stored in `mode`."""
    cls, cells = MODE_ACCESS_EVENTS[(mode, kind)]
    return {cls: cells * n_values}


def dynamic_plane_access_events(n_values: int, bits: int,
                                kind: str = "read") -> dict:
    """{event_class: count} for `bits`-wide packed DYNAMIC-plane data (the
    Augmented KV pages): one boosted-WL 8T cell per stored bit."""
    cls = "read_8t_dynamic" if kind == "read" else "write_8t_dynamic"
    return {cls: bits * n_values} if n_values else {}
