"""Paged, mode-switchable augmented KV pool.

Fixed-size pages (``cfg.amc.page_size`` tokens x all layers x K+V) each
live in one of two planes:

  Normal     bf16 rows in the ``kn``/``vn`` arena.
  Augmented  int4/int8-packed rows + per-token bf16 scales in the
             ``kp``/``vp``/``ks``/``vs`` arena.

One byte budget models the physical array: a Normal page charges
`page_bytes_normal` against it, an Augmented page `page_bytes_aug`.
Under ``augment-on-pressure`` the pool augments cold Normal pages in
place to make room. Augmented pages carry a `RefreshPolicy`; expired
pages are restamped in place or promoted back to Normal by the
scheduler's refresh pass.

Host-side metadata (numpy page tables, free lists, stamps) drives the
device arenas (torch tensors the model scatters into in place).

Ported from `repro.serve.cache_pool` without the prefix band, shared-page
refcounts / copy-on-write and the fault machinery, which arrive with
their slices.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.retention import RefreshPolicy
from repro_torch.kernels import ops as K
from repro_torch.models import layers as L

POOL_MODES = ("normal-only", "augment-on-pressure", "always-augmented")


def resolve_pool_mode(cfg: ModelConfig) -> str:
    mode = cfg.amc.resolved_pool_mode
    if mode not in POOL_MODES:
        raise ValueError(f"unknown pool_mode {mode!r}")
    return mode


@dataclasses.dataclass(frozen=True)
class PageGeometry:
    n_layers: int
    kv_heads: int
    head_dim: int
    page_size: int
    aug_bits: int

    @property
    def d_store(self) -> int:
        return self.head_dim // 2 if self.aug_bits == 4 else self.head_dim

    @property
    def page_bytes_normal(self) -> int:
        # K + V, all layers, bf16
        return 2 * self.n_layers * self.kv_heads * self.page_size \
            * self.head_dim * 2

    @property
    def page_bytes_aug(self) -> int:
        # K + V packed rows + bf16 per-(token, head) scales
        return 2 * self.n_layers * self.kv_heads * self.page_size \
            * (self.d_store + 2)

    @property
    def capacity_factor(self) -> float:
        return self.page_bytes_normal / self.page_bytes_aug


class PagedKVPool:
    """`max_batch` bounds the running batch (rows of the page table);
    capacity in tokens is bound by the byte budget."""

    kind = "paged"

    def __init__(self, cfg: ModelConfig, *, max_batch: int, max_seq: int,
                 device: torch.device,
                 budget_bytes: Optional[int] = None,
                 retention_steps: Optional[int] = None):
        a = cfg.amc
        self.cfg = cfg
        self.device = device
        self.pool_mode = resolve_pool_mode(cfg)
        self.geom = PageGeometry(cfg.n_layers, cfg.n_kv_heads, cfg.hd,
                                 a.page_size, a.aug_bits)
        self.max_batch = max_batch
        self.max_pages = -(-max_seq // a.page_size)
        self.retention_steps = (a.retention_steps if retention_steps is None
                                else retention_steps)
        B, maxP = max_batch, self.max_pages
        pbn, pba = self.geom.page_bytes_normal, self.geom.page_bytes_aug
        # every row can reach max_seq tokens in any mode the policy may pick
        self.pages_normal = 0 if self.pool_mode == "always-augmented" \
            else B * maxP
        self.pages_packed = 0 if self.pool_mode == "normal-only" else B * maxP
        self.budget_bytes = (B * maxP * pbn if budget_bytes is None
                             else budget_bytes)
        seq_cost = maxP * (pbn if self.pool_mode == "normal-only" else pba)
        if self.budget_bytes < seq_cost:
            raise ValueError(
                f"budget_bytes={self.budget_bytes} cannot hold one full "
                f"sequence ({seq_cost} B in the pool's cheapest mode)")
        self.live_bytes = 0

        # device arenas — physical page 0 of each is the write-dump page
        # (masked-off scatter rows land there), so usable pages start at 1
        g = self.geom
        Nn, Np = self.pages_normal + 1, self.pages_packed + 1
        Lg, KV, P = g.n_layers, g.kv_heads, g.page_size
        packed_dt = torch.uint8 if g.aug_bits == 4 else torch.int8

        def zeros(shape, dt):
            return torch.zeros(shape, dtype=dt, device=device)

        self.arenas = {
            "kn": zeros((Lg, Nn, KV, P, g.head_dim), torch.bfloat16),
            "vn": zeros((Lg, Nn, KV, P, g.head_dim), torch.bfloat16),
            "kp": zeros((Lg, Np, KV, P, g.d_store), packed_dt),
            "vp": zeros((Lg, Np, KV, P, g.d_store), packed_dt),
            "ks": zeros((Lg, Np, KV, P), torch.bfloat16),
            "vs": zeros((Lg, Np, KV, P), torch.bfloat16),
        }

        self.page_table = np.zeros((B, maxP), np.int32)
        self.page_mode = np.zeros((B, maxP), np.int32)   # 0 normal, 1 aug
        self.allocated = np.zeros((B, maxP), bool)
        self.last_write = np.full((B, maxP), -1, np.int64)
        self.free_normal = list(range(Nn - 1, 0, -1))    # pop() -> low first
        self.free_packed = list(range(Np - 1, 0, -1))
        self.policies: dict[tuple[int, int], RefreshPolicy] = {}
        self._tables_cache: Optional[dict] = None   # dropped on any change
        self._live_by_mode = [0, 0]
        self.stats = {
            "augment_events": 0, "promote_events": 0, "refreshes": 0,
            "refresh_bytes": 0, "augment_bytes": 0,
            "maintenance_dispatches": 0, "alloc_failures": 0,
            "peak_live_bytes": 0, "retracted_pages": 0,
        }

    # -- byte accounting ------------------------------------------------------

    def _cost(self, mode: int) -> int:
        return self.geom.page_bytes_normal if mode == 0 \
            else self.geom.page_bytes_aug

    def free_page_count(self, mode: int) -> int:
        return len(self.free_normal if mode == 0 else self.free_packed)

    def can_admit_tokens(self, n_tokens: int) -> bool:
        """Could `n_tokens` more tokens be stored right now, augmenting
        cold pages if the policy allows?"""
        pages = -(-n_tokens // self.geom.page_size)
        free_b = self.budget_bytes - self.live_bytes
        free0, free1 = self.free_page_count(0), self.free_page_count(1)
        if self.pool_mode == "normal-only":
            return pages <= free0 and pages * self._cost(0) <= free_b
        if (self.pool_mode == "augment-on-pressure" and pages <= free0
                and pages * self._cost(0) <= free_b):
            return True
        if pages > free1:
            return False
        need = pages * self._cost(1) - free_b
        if need <= 0:
            return True
        per = self._cost(0) - self._cost(1)   # bytes one augmentation frees
        n_aug = -(-need // per)
        # each augmentation takes one free packed page on top of the
        # request's own pages
        return (self.pool_mode == "augment-on-pressure"
                and n_aug <= self._live_by_mode[0]
                and pages + n_aug <= free1)

    # -- allocation -----------------------------------------------------------

    def alloc_page(self, row: int, lp: int, step: int) -> bool:
        """Allocate logical page (row, lp). normal-only / always-augmented
        pin the plane; augment-on-pressure prefers Normal, falls back to
        Augmented, and augments cold pages when even that does not fit.
        False = pool exhausted."""
        assert not self.allocated[row, lp], (row, lp)
        order = {"normal-only": (0,), "always-augmented": (1,),
                 "augment-on-pressure": (0, 1)}[self.pool_mode]
        for mode in order:
            if self._try_place(row, lp, mode, step):
                return True
        if self.pool_mode == "augment-on-pressure":
            while (self.live_bytes + self._cost(1) > self.budget_bytes
                   or self.free_page_count(1) == 0):
                if not self._augment_coldest(step):
                    break
            if self._try_place(row, lp, 1, step):
                return True
        self.stats["alloc_failures"] += 1
        return False

    def _try_place(self, row: int, lp: int, mode: int, step: int) -> bool:
        cost = self._cost(mode)
        free = self.free_normal if mode == 0 else self.free_packed
        if not free or self.live_bytes + cost > self.budget_bytes:
            return False
        phys = free.pop()
        self._tables_cache = None
        self.page_table[row, lp] = phys
        self.page_mode[row, lp] = mode
        self.allocated[row, lp] = True
        self.last_write[row, lp] = step
        self.live_bytes += cost
        self._live_by_mode[mode] += 1
        self.stats["peak_live_bytes"] = max(self.stats["peak_live_bytes"],
                                            self.live_bytes)
        if mode == 1:
            pol = RefreshPolicy(retention_steps=self.retention_steps)
            pol.stamp(step)
            self.policies[(row, lp)] = pol
        return True

    def admit_row(self, row: int, n_tokens: int, step: int) -> bool:
        """All-or-nothing admission of the prompt's pages."""
        pages = -(-max(n_tokens, 1) // self.geom.page_size)
        for lp in range(pages):
            if not self.alloc_page(row, lp, step):
                for d in range(lp):
                    self._release(row, d)
                return False
        return True

    def ensure_position(self, row: int, pos: int, step: int) -> bool:
        """The page holding `pos` must exist before a dispatch writes it."""
        lp = pos // self.geom.page_size
        if lp >= self.max_pages:
            raise ValueError(f"position {pos} past the page table "
                             f"({self.max_pages} pages)")
        return bool(self.allocated[row, lp]) or self.alloc_page(row, lp, step)

    def release_row(self, row: int) -> None:
        for lp in np.flatnonzero(self.allocated[row]):
            self._release(row, int(lp))

    def _release(self, row: int, lp: int) -> None:
        mode = int(self.page_mode[row, lp])
        phys = int(self.page_table[row, lp])
        (self.free_normal if mode == 0 else self.free_packed).append(phys)
        self._tables_cache = None
        self.live_bytes -= self._cost(mode)
        self._live_by_mode[mode] -= 1
        self.allocated[row, lp] = False
        self.page_table[row, lp] = 0
        self.page_mode[row, lp] = 0
        self.last_write[row, lp] = -1
        self.policies.pop((row, lp), None)

    def max_row_tokens(self) -> int:
        """Most tokens ONE row can ever hold (the rest of the pool empty)."""
        if self.pool_mode == "normal-only":
            arena, cheapest = self.pages_normal, self._cost(0)
        elif self.pool_mode == "always-augmented":
            arena, cheapest = self.pages_packed, self._cost(1)
        else:
            arena = self.pages_normal + self.pages_packed
            cheapest = self._cost(1)
        pages = min(self.max_pages, arena, self.budget_bytes // cheapest)
        return max(pages, 0) * self.geom.page_size

    @property
    def aug_bits(self) -> int:
        return self.geom.aug_bits

    def physical_bytes(self) -> int:
        """Usable staged capacity of both planes (dump pages excluded)."""
        return (self.pages_normal * self.geom.page_bytes_normal
                + self.pages_packed * self.geom.page_bytes_aug)

    # -- array event accounting (the engine folds these into its ledger) -------

    @property
    def _values_per_token(self) -> int:
        g = self.geom
        return 2 * g.n_layers * g.kv_heads * g.head_dim

    def read_value_counts(self, rows: np.ndarray,
                          lengths: np.ndarray) -> tuple[int, int]:
        """(normal, augmented) cache VALUES a decode dispatch reads for
        `rows` at valid `lengths`, split by page mode."""
        if rows.size == 0:
            return 0, 0
        page = self.geom.page_size
        tok = np.clip(lengths[:, None]
                      - np.arange(self.max_pages)[None, :] * page, 0, page)
        alloc = self.allocated[rows]
        modes = self.page_mode[rows]
        v = self._values_per_token
        return (int((tok * (alloc & (modes == 0))).sum()) * v,
                int((tok * (alloc & (modes == 1))).sum()) * v)

    def write_value_counts(self, rows: np.ndarray, n_new: int,
                           write_starts: np.ndarray) -> tuple[int, int]:
        """(normal, augmented) cache VALUES one dispatch writes: `n_new`
        tokens per row from `write_starts`, costed by the mode of the
        page each token lands in."""
        if rows.size == 0:
            return 0, 0
        page = self.geom.page_size
        pos = write_starts[:, None] + np.arange(n_new)[None, :]
        lp = np.minimum(pos // page, self.max_pages - 1)
        mode = self.page_mode[rows[:, None], lp]
        alive = self.allocated[rows[:, None], lp]
        v = self._values_per_token
        return (int((alive & (mode == 0)).sum()) * v,
                int((alive & (mode == 1)).sum()) * v)

    # -- mode switching --------------------------------------------------------

    def _coldest_normal(self) -> Optional[tuple[int, int]]:
        cand = self.allocated & (self.page_mode == 0)
        if not cand.any():
            return None
        age = np.where(cand, self.last_write, np.iinfo(np.int64).max)
        row, lp = np.unravel_index(int(age.argmin()), age.shape)
        return int(row), int(lp)

    def _augment_coldest(self, step: int) -> bool:
        target = self._coldest_normal()
        if target is None or not self.free_packed:
            return False
        self.augment_page(*target, step=step)
        return True

    def augment_page(self, row: int, lp: int, step: int) -> None:
        """Normal -> Augmented in place: quantize-pack the page into the
        packed plane and give the byte difference back to the budget."""
        assert self.page_mode[row, lp] == 0 and self.allocated[row, lp]
        src = int(self.page_table[row, lp])
        dst = self.free_packed.pop()
        _augment_page_op(self.arenas, src, dst, cfg=self.cfg)
        self.stats["maintenance_dispatches"] += 1
        self.free_normal.append(src)
        self._tables_cache = None
        self.page_table[row, lp] = dst
        self.page_mode[row, lp] = 1
        self.live_bytes -= self._cost(0) - self._cost(1)
        self._live_by_mode[0] -= 1
        self._live_by_mode[1] += 1
        pol = RefreshPolicy(retention_steps=self.retention_steps)
        pol.stamp(step)
        self.policies[(row, lp)] = pol
        self.stats["augment_events"] += 1
        self.stats["augment_bytes"] += self._cost(0) + self._cost(1)

    def promote_page(self, row: int, lp: int, step: int) -> bool:
        """Augmented -> Normal when the budget has room again."""
        assert self.page_mode[row, lp] == 1 and self.allocated[row, lp]
        cost_up = self._cost(0) - self._cost(1)
        if not self.free_normal \
                or self.live_bytes + cost_up > self.budget_bytes:
            return False
        src = int(self.page_table[row, lp])
        dst = self.free_normal.pop()
        _promote_page_op(self.arenas, src, dst, aug_bits=self.geom.aug_bits)
        self.stats["maintenance_dispatches"] += 1
        self.free_packed.append(src)
        self._tables_cache = None
        self.page_table[row, lp] = dst
        self.page_mode[row, lp] = 0
        self.last_write[row, lp] = step
        self.live_bytes += cost_up
        self._live_by_mode[1] -= 1
        self._live_by_mode[0] += 1
        self.policies.pop((row, lp), None)
        self.stats["promote_events"] += 1
        return True

    # -- retention / refresh ----------------------------------------------------

    def note_token_writes(self, rows: np.ndarray, positions: np.ndarray,
                          step: int) -> None:
        """Stamp the pages the given absolute positions land in: resets
        both coldness and the retention clock."""
        lps = np.asarray(positions).ravel() // self.geom.page_size
        for row, lp in zip(np.asarray(rows).ravel(), lps):
            row, lp = int(row), int(lp)
            if not self.allocated[row, lp]:
                continue
            self.last_write[row, lp] = step
            pol = self.policies.get((row, lp))
            if pol is not None:
                pol.stamp(step)

    def retract_token_writes(self, rows: np.ndarray,
                             new_lengths: np.ndarray) -> int:
        """Speculative rollback: release the pages that hold ONLY draft
        tokens the verify pass rejected (pages whose first slot is at or
        past the row's post-accept length). The rejected slots of the
        surviving boundary page were already scrubbed by the verify
        step's masked commit; a retracted page may keep stale bytes but is
        never read (the attention walk stops at the row's length, and a
        re-allocation is written before it is read). Returns the number
        of pages released."""
        page = self.geom.page_size
        n = 0
        for row, length in zip(np.asarray(rows).ravel(),
                               np.asarray(new_lengths).ravel()):
            row, length = int(row), int(length)
            first_dead = -(-max(length, 0) // page)      # ceil
            for lp in np.flatnonzero(self.allocated[row]):
                if int(lp) >= first_dead:
                    self._release(row, int(lp))
                    n += 1
        self.stats["retracted_pages"] += n
        return n

    def refresh_due(self, step: int) -> list[tuple[int, int]]:
        return [key for key, pol in self.policies.items()
                if pol.needs_refresh(step)]

    def refresh_page(self, row: int, lp: int, step: int) -> None:
        """Refresh one expired Augmented page: promote back to Normal when
        the policy allows and the budget has room, else re-write it in
        place (restamp) and account the traffic."""
        if self.pool_mode == "augment-on-pressure" \
                and self.cfg.amc.refresh_promote \
                and self.promote_page(row, lp, step):
            self.stats["refreshes"] += 1
            self.stats["refresh_bytes"] += self._cost(1) + self._cost(0)
            return
        pol = self.policies.get((row, lp))
        if pol is None:
            return
        pol.stamp(step)
        self.stats["refreshes"] += 1
        self.stats["refresh_bytes"] += 2 * self._cost(1)   # read + re-write

    def refresh(self, key: tuple, step: int) -> None:
        self.refresh_page(key[0], key[1], step)

    # -- device views -----------------------------------------------------------

    @property
    def state(self) -> dict:
        """The device arenas, under the name every store gives its device
        state (the paged steps update them in place)."""
        return self.arenas

    @state.setter
    def state(self, new: dict) -> None:
        self.arenas = new

    def device_tables(self) -> dict:
        """The true (page_table, page_modes) on the device, cached until
        the tables change."""
        if self._tables_cache is None:
            self._tables_cache = {
                "page_table": torch.from_numpy(self.page_table.copy()).to(
                    self.device),
                "page_modes": torch.from_numpy(self.page_mode.copy()).to(
                    self.device)}
        return self._tables_cache

    def arena_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.arenas.values())

    def describe(self) -> dict:
        g = self.geom
        return {
            "kind": self.kind,
            "pool_mode": self.pool_mode,
            "page_size": g.page_size,
            "aug_bits": g.aug_bits,
            "pages_live_normal": self._live_by_mode[0],
            "pages_live_augmented": self._live_by_mode[1],
            "page_bytes_normal": g.page_bytes_normal,
            "page_bytes_aug": g.page_bytes_aug,
            "page_capacity_factor": g.capacity_factor,
            "budget_bytes": self.budget_bytes,
            "live_bytes": self.live_bytes,
            "arena_bytes": self.arena_bytes(),
            "retention_steps": self.retention_steps,
            **self.stats,
        }


# ---------------------------------------------------------------------------
# maintenance ops: move one physical page between planes, in place
# ---------------------------------------------------------------------------

def _augment_page_op(arenas: dict, src: int, dst: int, *,
                     cfg: ModelConfig) -> None:
    """Quantize-pack Normal page `src` into packed page `dst` (all layers,
    K and V) through the same write driver the model's scatter uses."""
    for plane, packed, scale in (("kn", "kp", "ks"), ("vn", "vp", "vs")):
        x = arenas[plane][:, src]                      # (L, KV, page, hd)
        if cfg.amc.aug_bits == 4:
            p, s = K.quantize_pack_kv(x)
        else:
            p, s = L.pack_kv_int8(x)
        arenas[packed][:, dst] = p
        arenas[scale][:, dst] = s[..., 0].to(torch.bfloat16)


def _promote_page_op(arenas: dict, src: int, dst: int, *,
                     aug_bits: int) -> None:
    """Dequantize packed page `src` back into Normal page `dst`."""
    unpack = L.unpack_kv_int4 if aug_bits == 4 else L.unpack_kv_int8
    for plane, packed, scale in (("kn", "kp", "ks"), ("vn", "vp", "vs")):
        d = unpack(arenas[packed][:, src], arenas[scale][:, src][..., None])
        arenas[plane][:, dst] = d.to(torch.bfloat16)


def _zero_page_op(arenas: dict, phys: int, *, mode: int) -> None:
    """Scrub one physical page in its plane."""
    for k in (("kn", "vn") if mode == 0 else ("kp", "vp", "ks", "vs")):
        arenas[k][:, phys] = 0
