"""Fleet placement: which logical SRAM array a request lands on.

The paper's unit of capacity is an *array*: its own Normal/Augmented
planes, byte budget and retention clock. `ArrayFleet` (serve/fleet.py)
runs one `ServeEngine` per array; this module holds the two pure pieces
the fleet composes:

  * `PlacementPolicy` subclasses score `ArrayView` snapshots and pick an
    array for each incoming request:
      - least-loaded      fewest running + queued requests (the default)
      - budget-headroom   most free bytes (budget - live)
      - affinity          the array whose prefix cache holds the prompt's
                          deepest prefix, else a stable hash of the first
                          tokens, falling back to least-loaded when that
                          array cannot admit right now
  * device partitioning: N arrays over the CUDA devices, contiguous
    groups when devices >= arrays, round-robin sharing otherwise (one
    H100 puts every array on cuda:0). An array runs on the first device
    of its group: the port has no tensor-parallel sharding inside an
    array.

Policies never touch engines: they read `ArrayView` snapshots the fleet
builds per decision. Ported from `repro.serve.placement` (plain Python
and numpy, decision for decision).
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass
class ArrayView:
    """One array's admission-relevant state at a placement decision."""
    aid: int                     # array index in the fleet
    alive: bool                  # False once drained by an array loss
    running: int                 # active rows
    queued: int                  # scheduler queue depth
    free_rows: int               # max_batch - running
    live_bytes: int
    budget_bytes: int
    # store.can_admit_tokens probe (counts augmentation headroom)
    admit_probe: Optional[Callable[[int], bool]] = None
    # engine.prefix_probe: tokens of a prompt the array's prefix cache
    # already holds (None on fleets without prefix caching)
    prefix_probe: Optional[Callable[[np.ndarray], int]] = None

    @property
    def load(self) -> int:
        return self.running + self.queued

    @property
    def headroom_bytes(self) -> int:
        return self.budget_bytes - self.live_bytes

    def can_admit_now(self, n_tokens: int) -> bool:
        if self.free_rows <= 0:
            return False
        if self.admit_probe is None:
            return True
        return self.admit_probe(max(int(n_tokens), 1))


class PlacementPolicy:
    """Base: pick an alive array for a prompt. Deterministic: equal
    scores break toward the lower array id, so fleet runs reproduce."""

    name = "base"

    def place(self, prompt: np.ndarray, views: list[ArrayView]) -> int:
        alive = [v for v in views if v.alive]
        if not alive:
            raise RuntimeError(
                "no surviving arrays in the fleet — every array was "
                "drained by an array-loss event")
        return self._pick(prompt, alive)

    def _pick(self, prompt: np.ndarray, alive: list[ArrayView]) -> int:
        raise NotImplementedError


class LeastLoaded(PlacementPolicy):
    name = "least-loaded"

    def _pick(self, prompt, alive):
        return min(alive,
                   key=lambda v: (v.load, -v.headroom_bytes, v.aid)).aid


class BudgetHeadroom(PlacementPolicy):
    name = "budget-headroom"

    def _pick(self, prompt, alive):
        return min(alive,
                   key=lambda v: (-v.headroom_bytes, v.load, v.aid)).aid


class Affinity(PlacementPolicy):
    """Shared-prefix locality, strongest signal first:

    1. PREFIX: the array whose `PrefixIndex` already holds the deepest
       cached prefix of this prompt (ties to the lower array id).
    2. HASH: no array holds the prefix yet; crc32 of the first
       `prefix_tokens` tokens picks a stable preferred array (crc32, not
       Python's salted hash: placement reproduces across processes).
    3. FALLBACK: the choice above cannot admit right now; least-loaded
       among the OTHER alive arrays.

    `last_reason` records which rung decided; the fleet counts it in
    `stats()["placement"]["decisions"]`."""

    name = "affinity"
    prefix_tokens = 8

    def __init__(self):
        self.last_reason = "hash"

    def _pick(self, prompt, alive):
        flat = np.asarray(prompt, np.int32).reshape(-1)
        best, best_m = None, 0
        for v in alive:
            if v.prefix_probe is None:
                continue
            m = v.prefix_probe(flat)
            if m > best_m:
                best, best_m = v, m
        if best is not None and best.can_admit_now(flat.size):
            self.last_reason = "prefix"
            return best.aid
        h = zlib.crc32(flat[:self.prefix_tokens].tobytes())
        preferred = alive[h % len(alive)]
        if preferred.can_admit_now(flat.size):
            self.last_reason = "hash"
            return preferred.aid
        self.last_reason = "fallback"
        others = [v for v in alive if v.aid != preferred.aid]
        return LeastLoaded()._pick(prompt, others or alive)


POLICIES = {p.name: p for p in (LeastLoaded, BudgetHeadroom, Affinity)}


def make_policy(name: str) -> PlacementPolicy:
    if name not in POLICIES:
        raise ValueError(
            f"unknown placement policy {name!r} "
            f"(expected one of {sorted(POLICIES)})")
    return POLICIES[name]()


# -- device partitioning -------------------------------------------------------

def partition_devices(devices: list, num_arrays: int) -> list[list]:
    """N arrays over the available devices: contiguous equal groups when
    devices >= arrays (remainder devices stay idle, so every array has
    the same compute), round-robin sharing otherwise (several logical
    arrays a physical device)."""
    if num_arrays < 1:
        raise ValueError(f"num_arrays must be >= 1, got {num_arrays}")
    n = len(devices)
    if n >= num_arrays:
        per = n // num_arrays
        return [list(devices[i * per:(i + 1) * per])
                for i in range(num_arrays)]
    return [[devices[i % n]] for i in range(num_arrays)]


def make_array_meshes(num_arrays: int, device=None
                      ) -> list[list[torch.device]]:
    """One device group per array over a partition of the devices
    `resolve_device(device)` names: every CUDA device when it is the bare
    "cuda" (the default), the one device otherwise (``device="cpu"``, or
    an indexed ``cuda:N``). The JAX package builds a mesh per group; the
    port runs an array on its group's first device."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    else:
        devices = [dev]
    return partition_devices(devices, num_arrays)
