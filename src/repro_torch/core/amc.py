"""`AugmentedStore`, the paper's mode-switchable augmented memory, and the
logical/physical byte accounting of the storage modes with their array
access events (what `ServeEngine.stats()` and the IMC event ledger use).

A store owns ONE physical allocation and runs in one of three modes,
switchable at run time (the paper's per-sub-array mode configuration):

  NORMAL            dense bf16, one value per 16-bit word (the 6T mode)
  AUGMENTED_DUAL    uint8 dual plane: static int4 + dynamic int4 (8T)
  AUGMENTED_TERNARY packed trits, 1.6 or 2 bits a value (7T)

The host-side ledger enforces the paper's access discipline: a static
read or write in AUGMENTED_DUAL runs through the dynamic node, so while
dynamic data is live it raises `FILOViolation` unless `force=True`, which
really zeroes the dynamic nibble; every dynamic write is stamped, a read
past `retention_steps` raises `RetentionExpired`, and `refresh()`
rewrites the plane from its master. The port of `repro.core.amc`: the
tensors live on one device (the card unless the caller asks for another),
and the bytes and scales of each mode equal the JAX store's bit for bit.
"""
from __future__ import annotations

import enum
import math
from typing import Optional

import torch

from repro_torch.core import dual_plane as dp
from repro_torch.core import ternary
from repro_torch.core.retention import RefreshPolicy
from repro_torch.device import resolve_device


class Mode(enum.Enum):
    NORMAL = "normal"
    AUGMENTED_DUAL = "augmented_dual"
    AUGMENTED_TERNARY = "augmented_ternary"


class FILOViolation(RuntimeError):
    """Static-plane access while dynamic data is live (paper SS.II-B)."""


class RetentionExpired(RuntimeError):
    """Dynamic plane read past its retention window without refresh."""


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


def mode_physical_bytes(n_values: int, mode: Mode,
                        ternary_fmt: str = "base3") -> int:
    """Bytes `n_values` logical values take in `mode`: 2 each in NORMAL,
    1 in AUGMENTED_DUAL (one byte holds a static and a dynamic value), 5
    (base-3) or 4 (2-bit) trits a byte rounded up in AUGMENTED_TERNARY."""
    if mode == Mode.NORMAL:
        return 2 * n_values
    if mode == Mode.AUGMENTED_DUAL:
        return n_values
    per = 5 if ternary_fmt == "base3" else 4
    return (n_values + per - 1) // per


def capacity_factor(mode: Mode, ternary_fmt: str = "base3") -> float:
    """Storage augmentation against NORMAL mode (values per physical
    bit)."""
    return (BITS_PER_VALUE[Mode.NORMAL]
            / mode_bits_per_value(mode, ternary_fmt))


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


class AugmentedStore:
    """One logical (shape) tensor in one of the three storage modes, with
    the FILO ledger, retention stamps and access events. `device`: where
    its tensors live (`resolve_device`: the card unless given)."""

    def __init__(self, shape, *, retention_steps: int = 4,
                 ternary_fmt: str = "base3", device=None):
        self.shape = tuple(shape)
        self.device = resolve_device(device)
        self.mode = Mode.NORMAL
        self.ternary_fmt = ternary_fmt
        self._dense: Optional[torch.Tensor] = torch.zeros(
            self.shape, dtype=torch.bfloat16, device=self.device)
        self._dual: Optional[dp.DualPlane] = None
        self._tern_packed = None
        self._tern_scale = None
        self._dynamic_live = False
        self._static_written = False
        self._step = 0
        self.policy = RefreshPolicy(retention_steps=retention_steps)
        self.stats = {"refreshes": 0, "filo_faults": 0, "mode_switches": 0}
        # array access events by class (energies in imc.energy)
        self.events: dict = {}

    def _put(self, x) -> torch.Tensor:
        return torch.as_tensor(x).to(self.device)

    def _note_access(self, kind: str) -> None:
        n = math.prod(self.shape)
        for cls, c in mode_access_events(self.mode, n, kind).items():
            self.events[cls] = self.events.get(cls, 0) + c

    def energy_fj(self) -> float:
        """Modelled energy of every access so far (imported here, so core
        does not import the imc package at load)."""
        from repro_torch.imc.energy import energy_fj
        return energy_fj(self.events)

    # -- mode switching (the paper's word-line / source-line reconfiguration)

    def _ternary_write(self, x: torch.Tensor) -> None:
        t, scale = ternary.ternarize(x)
        if self.ternary_fmt == "base3":
            self._tern_packed = ternary.pack_ternary_base3(t)
        else:
            self._tern_packed = ternary.pack_ternary_2bit(t)
        self._tern_scale = scale

    def set_mode(self, mode: Mode) -> None:
        if mode == self.mode:
            return
        if self._dynamic_live:
            raise FILOViolation(
                "mode switch while dynamic plane is live; drain first")
        self.stats["mode_switches"] += 1
        if mode == Mode.NORMAL:
            self._dense = self.read_static()
            self._dual = None
            self._tern_packed = None
        elif mode == Mode.AUGMENTED_DUAL:
            master = self._materialize_master()
            self._dual = dp.write_static(
                dp.alloc(self.shape, device=self.device), master)
            self._dense = None
            self._tern_packed = None
        elif mode == Mode.AUGMENTED_TERNARY:
            self._ternary_write(self._materialize_master())
            self._dense = None
            self._dual = None
        self.mode = mode
        self._static_written = True

    def _materialize_master(self) -> torch.Tensor:
        if self._dense is not None:
            return self._dense
        return self.read_static()

    # -- static plane -------------------------------------------------------

    def write_static(self, x, *, force: bool = False) -> None:
        self._guard_filo(force)
        x = self._put(x)
        if self.mode == Mode.NORMAL:
            self._dense = x.to(torch.bfloat16)
        elif self.mode == Mode.AUGMENTED_DUAL:
            base = (self._dual if self._dual is not None
                    else dp.alloc(self.shape, device=self.device))
            self._dual = dp.write_static(base, x)   # zeroes the dynamic nibble
        else:
            self._ternary_write(x)
        self._note_access("write")
        self._static_written = True
        self._dynamic_live = False

    def read_static(self, *, force: bool = False) -> torch.Tensor:
        if self.mode == Mode.AUGMENTED_DUAL:
            # the SRAM read path runs through the dynamic node
            self._guard_filo(force)
        self._note_access("read")
        if self.mode == Mode.NORMAL:
            return self._dense
        if self.mode == Mode.AUGMENTED_DUAL:
            return dp.read_static(self._dual)
        k = self.shape[0]
        if self.ternary_fmt == "base3":
            t = ternary.unpack_ternary_base3(self._tern_packed, k)
        else:
            t = ternary.unpack_ternary_2bit(self._tern_packed, k)
        return ternary.ternary_dequant(t, self._tern_scale)

    def _guard_filo(self, force: bool) -> None:
        if self._dynamic_live:
            if not force:
                self.stats["filo_faults"] += 1
                raise FILOViolation(
                    "static access while dynamic plane live (FILO: drain the "
                    "dynamic plane first, or pass force=True to clobber it)")
            # the physics: the access destroys the dynamic bit
            if self._dual is not None:
                self._dual = dp.DualPlane(self._dual.buf & 0xF0,
                                          self._dual.static_scale,
                                          self._dual.dynamic_scale)
            self._dynamic_live = False

    # -- dynamic plane (AUGMENTED_DUAL only) --------------------------------

    def push_dynamic(self, x, *, stochastic: bool = False,
                     generator: Optional[torch.Generator] = None) -> None:
        if self.mode != Mode.AUGMENTED_DUAL:
            raise RuntimeError("dynamic plane exists only in AUGMENTED_DUAL")
        self._dual = dp.write_dynamic(self._dual, self._put(x),
                                      stochastic=stochastic,
                                      generator=generator)
        self._note_access("write_dynamic")
        self._dynamic_live = True
        self.policy.stamp(self._step)

    def pop_dynamic(self) -> torch.Tensor:
        """Read and drain the dynamic plane (the last-out of FILO)."""
        if not self._dynamic_live:
            raise RuntimeError("no live dynamic data")
        if self.policy.needs_refresh(self._step):
            raise RetentionExpired(
                f"dynamic plane expired at step {self.policy.expires_at()}, "
                f"now {self._step}; refresh() from master first")
        self._note_access("read_dynamic")
        out = dp.read_dynamic(self._dual)
        self._dynamic_live = False
        return out

    def peek_dynamic(self) -> torch.Tensor:
        if self.policy.needs_refresh(self._step):
            raise RetentionExpired("dynamic plane expired")
        self._note_access("read_dynamic")
        return dp.read_dynamic(self._dual)

    def refresh(self, master) -> None:
        """DRAM-style refresh: rewrite the dynamic plane from its master."""
        if self.mode != Mode.AUGMENTED_DUAL or not self._dynamic_live:
            return
        self._dual = dp.write_dynamic(self._dual, self._put(master))
        self._note_access("write_dynamic")
        self.policy.stamp(self._step)
        self.stats["refreshes"] += 1

    # -- clock / accounting -------------------------------------------------

    def tick(self, n: int = 1) -> None:
        self._step += n

    @property
    def dynamic_live(self) -> bool:
        return self._dynamic_live

    def bits_per_value(self) -> float:
        return mode_bits_per_value(self.mode, self.ternary_fmt)

    def capacity_factor(self) -> float:
        """Storage augmentation against NORMAL mode."""
        return capacity_factor(self.mode, self.ternary_fmt)

    def physical_bytes(self) -> int:
        return mode_physical_bytes(math.prod(self.shape), self.mode,
                                   self.ternary_fmt)
