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

Static prefix band (``prefix_tokens`` > 0, the audio family): rows
[B, 2B) of the page table hold each slot's STATIC-LENGTH prefix pages,
the encoder-decoder cross KV, allocated and zeroed at admission and read
at the fixed length ``prefix_tokens`` every decode step (the paper's
static plane; cold by construction, so under pressure these are the
first pages augmented). The table is as wide as the wider band.

Shared prefixes (``cfg.amc.prefix_cache`` > 0): a SHARE band of
`share_entries` page-table rows follows the decode (and prefix) rows.
Each anchors one cached prompt prefix (`serve.prefix.PrefixIndex` owns
the token hashes); decode rows alias its physical pages by refcount, and
the first write into a shared page copies it on write (`_cow_page`).
Under pressure cold prefix pages demote Normal -> Augmented, and idle
entries (refcount 0 outside the band) are evicted last.

Retention faults (an attached `core.faults.FaultModel`): Augmented pages
are corrupted on the device from the model's seeded schedule, detected
through integrity words over their packed bytes (computed on the device,
one scalar a page back to the host), and healed from a host master copy
where one exists (prefix- and share-band pages) or by the engine's
recompute.

With an observability facade attached (`attach_obs`), every mode
transition (augment, demote, promote, restamp, copy on write,
decommission) and every injected fault becomes a refresh- or fault-lane
event, from host bookkeeping only.

Host-side metadata (numpy page tables, free lists, stamps) drives the
device arenas (torch tensors the model and the maintenance ops update in
place). Ported from `repro.serve.cache_pool`; `device_tables` gives
the true page tables, not the TPU kernel's hold-previous indices.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import faults as F
from repro_torch.core.retention import RefreshPolicy
from repro_torch.kernels import ops as K
from repro_torch.models import layers as L

POOL_MODES = ("normal-only", "augment-on-pressure", "always-augmented")
PACKED_PLANES = ("kp", "vp", "ks", "vs")    # an integrity word's byte order
WORD_CHUNK_BYTES = 1 << 22    # page bytes a chunk of `_page_words` sums
FAULT_COUNTERS = ("faults_injected", "faults_detected", "faults_masked",
                  "refresh_misses", "integrity_checks", "pinned_normal",
                  "pages_decommissioned")


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
    capacity in tokens is bound by the byte budget. `n_layers` (default:
    the config's) sets the layers a page spans: the vlm family's pool
    holds its self-attention layers only."""

    kind = "paged"

    def __init__(self, cfg: ModelConfig, *, max_batch: int, max_seq: int,
                 device: torch.device,
                 budget_bytes: Optional[int] = None,
                 retention_steps: Optional[int] = None,
                 prefix_tokens: int = 0, n_layers: Optional[int] = None):
        a = cfg.amc
        self.cfg = cfg
        self.device = device
        self.pool_mode = resolve_pool_mode(cfg)
        self.geom = PageGeometry(cfg.n_layers if n_layers is None
                                 else n_layers, cfg.n_kv_heads, cfg.hd,
                                 a.page_size, a.aug_bits)
        self.max_batch = max_batch
        self.max_pages = -(-max_seq // a.page_size)
        self.prefix_tokens = prefix_tokens
        self.prefix_pages = -(-prefix_tokens // a.page_size)
        self.retention_steps = (a.retention_steps if retention_steps is None
                                else retention_steps)
        B, maxP = max_batch, self.max_pages
        pbn, pba = self.geom.page_bytes_normal, self.geom.page_bytes_aug
        # a row's pages: the decode band and its static prefix band; every
        # row can reach max_seq tokens in any mode the policy may pick
        row_pages = maxP + self.prefix_pages
        self.pages_normal = 0 if self.pool_mode == "always-augmented" \
            else B * row_pages
        self.pages_packed = 0 if self.pool_mode == "normal-only" \
            else B * row_pages
        self.budget_bytes = (B * row_pages * pbn if budget_bytes is None
                             else budget_bytes)
        seq_cost = row_pages * (pbn if self.pool_mode == "normal-only"
                                else pba)
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

        # rows [0, B) are the decode rows; with a static prefix rows
        # [B, 2B) are each slot's prefix band; with prefix_cache > 0 the
        # share band's `share_entries` rows follow, one per cached entry.
        # The table is as wide as the wider of the two bands.
        self._share_base = 2 * B if self.prefix_pages else B
        self.share_entries = int(a.prefix_cache)
        n_rows = self._share_base + self.share_entries
        self.table_width = max(maxP, self.prefix_pages)
        tw = self.table_width
        self.page_table = np.zeros((n_rows, tw), np.int32)
        self.page_mode = np.zeros((n_rows, tw), np.int32)  # 0 normal, 1 aug
        self.allocated = np.zeros((n_rows, tw), bool)
        self.last_write = np.full((n_rows, tw), -1, np.int64)
        self.free_normal = list(range(Nn - 1, 0, -1))    # pop() -> low first
        self.free_packed = list(range(Np - 1, 0, -1))
        self.policies: dict[tuple[int, int], RefreshPolicy] = {}
        self._tables_cache: Optional[dict] = None   # dropped on any change
        self._live_by_mode = [0, 0]
        self._obs = None        # EngineObs facade (attach_obs), optional
        self.stats = {
            "augment_events": 0, "promote_events": 0, "refreshes": 0,
            "refresh_bytes": 0, "augment_bytes": 0,
            "maintenance_dispatches": 0, "alloc_failures": 0,
            "peak_live_bytes": 0, "retracted_pages": 0,
            "faults_injected": 0, "faults_detected": 0, "faults_masked": 0,
            "refresh_misses": 0, "integrity_checks": 0, "pinned_normal": 0,
            "pages_decommissioned": 0,
            "cow_events": 0, "cow_bytes": 0, "prefix_demotions": 0,
            "prefix_evictions": 0,
        }
        # physical-page reference counts, keyed (mode, phys): every
        # allocated page carries one; shared-prefix aliases raise it.
        # live_bytes charges each PHYSICAL page once — aliases are free.
        self._refcount: dict[tuple[int, int], int] = {}
        self._prefix_index = None   # serve.prefix.PrefixIndex (optional)
        # retention-fault machinery — inert until a FaultModel is
        # attached; every dict stays empty at fault_rate == 0
        self._fm: Optional[F.FaultModel] = None
        self._integrity = False
        self._fault_tag = ""
        self._words: dict[tuple[int, int], int] = {}   # integrity words
        self._dirty: set[tuple[int, int]] = set()      # rewritten since flush
        self._pending: set[tuple[int, int]] = set()    # injected, unscanned
        self._masters: dict[tuple[int, int], tuple] = {}  # host copies
        self._offenders: dict[str, int] = {}           # by physical unit id
        self._decommission: set[int] = set()           # weak packed pages
        self._word_weights: Optional[torch.Tensor] = None

    # -- byte accounting ------------------------------------------------------

    def _cost(self, mode: int) -> int:
        return self.geom.page_bytes_normal if mode == 0 \
            else self.geom.page_bytes_aug

    def free_page_count(self, mode: int) -> int:
        return len(self.free_normal if mode == 0 else self.free_packed)

    def can_admit_tokens(self, n_tokens: int) -> bool:
        """Could `n_tokens` more tokens be stored right now, augmenting
        cold pages if the policy allows? The static prefix band's pages
        count on top of the prompt's own. The IDLE shared-prefix pages
        (cached entries no live request maps) count as headroom: the
        allocator evicts those entries before it fails."""
        pages = -(-n_tokens // self.geom.page_size) + self.prefix_pages
        idle_n, idle_a = self._prefix_idle_counts()
        free_b = (self.budget_bytes - self.live_bytes
                  + idle_n * self._cost(0) + idle_a * self._cost(1))
        free0 = self.free_page_count(0) + idle_n
        free1 = self.free_page_count(1) + idle_a
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
                and n_aug <= self._augmentable_count()
                and pages + n_aug <= free1)

    # -- allocation -----------------------------------------------------------

    def alloc_page(self, row: int, lp: int, step: int) -> bool:
        """Allocate logical page (row, lp). normal-only / always-augmented
        pin the plane; augment-on-pressure prefers Normal, falls back to
        Augmented, and augments cold pages (shared-prefix pages among
        them) when even that does not fit. Idle cached prefixes are
        evicted last. False = pool exhausted."""
        assert not self.allocated[row, lp], (row, lp)
        order = {"normal-only": (0,), "always-augmented": (1,),
                 "augment-on-pressure": (0, 1)}[self.pool_mode]
        while True:
            for mode in order:
                if self._try_place(row, lp, mode, step):
                    return True
            if self.pool_mode == "augment-on-pressure":
                while (self.live_bytes + self._cost(1) > self.budget_bytes
                       or self.free_page_count(1) == 0):
                    if self._augment_coldest(step):
                        continue
                    if self._reclaim_prefix(step):
                        continue
                    self.stats["alloc_failures"] += 1
                    return False
                if self._try_place(row, lp, 1, step):
                    return True
            # pinned-mode pools reach here with their plane exhausted:
            # evicting one idle cached prefix frees pages and bytes
            if not self._reclaim_prefix(step):
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
        self._refcount[(mode, phys)] = 1
        self.live_bytes += cost
        self._live_by_mode[mode] += 1
        self.stats["peak_live_bytes"] = max(self.stats["peak_live_bytes"],
                                            self.live_bytes)
        if mode == 1:
            pol = RefreshPolicy(retention_steps=self.retention_steps)
            pol.stamp(step)
            self.policies[(row, lp)] = pol
            if self._fm is not None:
                self._dirty.add((row, lp))
        return True

    def _prefix_row(self, row: int) -> int:
        return self.max_batch + row

    def admit_row(self, row: int, n_tokens: int, step: int, *,
                  shared=None) -> bool:
        """All-or-nothing admission of the prompt's pages and (with a
        static prefix) the row's prefix pages, zeroed so that a recycled
        physical page never leaks a previous row's KV through the
        static-length read. With ``shared=(erow, m)`` the first ``m``
        prompt tokens are covered by the cached prefix anchored at
        share-band row ``erow``: its pages are mapped into this row by
        refcount (no storage, no prefill); only the tail allocates fresh
        pages."""
        pages = -(-max(n_tokens, 1) // self.geom.page_size)
        done: list[tuple[int, int]] = []
        share_pages = 0
        if shared is not None and self.share_entries:
            erow, m = shared
            # ceil: a mid-page match maps the entry's boundary page too;
            # the first write past the match copies it (ensure_position)
            share_pages = min(-(-m // self.geom.page_size), pages)
            for lp in range(share_pages):
                self.share_page(erow, lp, row, lp, step)
                done.append((row, lp))
        prow = self._prefix_row(row)
        wanted = ([(row, lp) for lp in range(share_pages, pages)]
                  + [(prow, lp) for lp in range(self.prefix_pages)])
        for r, lp in wanted:
            if not self.alloc_page(r, lp, step):
                for d in done:
                    self._release(*d)
                return False
            done.append((r, lp))
            if r == prow:
                self._zero_physical(r, lp)
        return True

    def _zero_physical(self, row: int, lp: int) -> None:
        """Zero the physical page behind (row, lp) in its plane: a prefix
        page is read to its full static length, so a recycled page's
        stale bytes must go at allocation."""
        _zero_page_op(self.arenas, int(self.page_table[row, lp]),
                      mode=int(self.page_mode[row, lp]))
        self.stats["maintenance_dispatches"] += 1

    def ensure_position(self, row: int, pos: int, step: int) -> bool:
        """The page holding `pos` must exist, and be this row's own,
        before a dispatch writes it."""
        lp = pos // self.geom.page_size
        if lp >= self.max_pages:
            raise ValueError(f"position {pos} past the page table "
                             f"({self.max_pages} pages)")
        if self.allocated[row, lp]:
            key = (int(self.page_mode[row, lp]),
                   int(self.page_table[row, lp]))
            if self._refcount.get(key, 1) > 1:
                # about to write into a shared-prefix page: copy the
                # tokens below `pos` into a private page first
                return self._cow_page(row, lp,
                                      pos - lp * self.geom.page_size, step)
            return True
        return self.alloc_page(row, lp, step)

    def free_row(self, row: int) -> None:
        for lp in np.flatnonzero(self.allocated[row]):
            self._release(row, int(lp))

    def release_row(self, row: int) -> None:
        self.free_row(row)
        if self.prefix_pages:
            self.free_row(self._prefix_row(row))

    def _release(self, row: int, lp: int) -> None:
        mode = int(self.page_mode[row, lp])
        phys = int(self.page_table[row, lp])
        rck = (mode, phys)
        rc = self._refcount.get(rck, 1)
        if rc > 1:
            # shared physical page: drop this alias only. The byte charge
            # and the canonical refresh/integrity metadata stay with the
            # surviving refs (rehomed if this alias carried them).
            self._refcount[rck] = rc - 1
            self._rehome_meta((row, lp), mode, phys)
            self._tables_cache = None
            self.allocated[row, lp] = False
            self.page_table[row, lp] = 0
            self.page_mode[row, lp] = 0
            self.last_write[row, lp] = -1
            return
        self._refcount.pop(rck, None)
        if mode == 1 and phys in self._decommission:
            # repeat-offender packed page: map the weak array out instead
            # of recycling it — capacity shrinks
            self._decommission.discard(phys)
            self.pages_packed -= 1
            self.stats["pages_decommissioned"] += 1
            if self._obs is not None:
                self._obs.store_event("decommission", f"pg{phys}", -1)
        else:
            (self.free_normal if mode == 0 else self.free_packed).append(phys)
        key = (row, lp)
        if key in self._pending:
            # the corruption went with the storage before any read
            self._pending.discard(key)
            self.stats["faults_masked"] += 1
        self._words.pop(key, None)
        self._masters.pop(key, None)
        self._dirty.discard(key)
        self._tables_cache = None
        self.live_bytes -= self._cost(mode)
        self._live_by_mode[mode] -= 1
        self.allocated[row, lp] = False
        self.page_table[row, lp] = 0
        self.page_mode[row, lp] = 0
        self.last_write[row, lp] = -1
        self.policies.pop((row, lp), None)

    def max_row_tokens(self) -> int:
        """Most tokens ONE row can ever hold (the rest of the pool empty):
        the table's depth, the cheapest plane's arena and the budget in
        the cheapest mode, each less the row's static prefix pages."""
        if self.pool_mode == "normal-only":
            arena, cheapest = self.pages_normal, self._cost(0)
        elif self.pool_mode == "always-augmented":
            arena, cheapest = self.pages_packed, self._cost(1)
        else:
            arena = self.pages_normal + self.pages_packed
            cheapest = self._cost(1)
        pages = min(self.max_pages, arena - self.prefix_pages,
                    self.budget_bytes // cheapest - self.prefix_pages)
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
        `rows` at valid `lengths`, split by page mode; the prefix band's
        pages are read to their full static length every step."""
        if rows.size == 0:
            return 0, 0
        page = self.geom.page_size
        first = np.arange(self.table_width)[None, :] * page
        bands = [(rows, np.clip(lengths[:, None] - first, 0, page))]
        if self.prefix_pages:
            bands.append((self._prefix_row(rows), np.broadcast_to(
                np.clip(self.prefix_tokens - first, 0, page),
                (rows.size, self.table_width))))
        n_norm = n_aug = 0
        for band_rows, tok in bands:
            alloc = self.allocated[band_rows]
            modes = self.page_mode[band_rows]
            n_norm += int((tok * (alloc & (modes == 0))).sum())
            n_aug += int((tok * (alloc & (modes == 1))).sum())
        v = self._values_per_token
        return n_norm * v, n_aug * v

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

    # -- shared-prefix page reuse (refcounted aliases + copy-on-write) ---------
    # Every cached prefix is anchored by one SHARE-band row (its "entry
    # row") whose table maps the run's physical pages; decode rows alias
    # the same pages by refcount. Invariants:
    #   * live_bytes charges each PHYSICAL page exactly once;
    #   * the refresh/integrity metadata (policies, _words, _masters,
    #     _pending, _dirty) of a shared page lives on exactly ONE key —
    #     the entry row while the entry lives — so an expiring shared
    #     page restamps once, not once per sharer.

    def entry_row(self, slot: int) -> int:
        return self._share_base + slot

    def attach_prefix_index(self, idx) -> None:
        """Wire the engine's PrefixIndex so allocation pressure can evict
        idle cached prefixes (refcount 0) as the last reclaim rung."""
        self._prefix_index = idx

    def _reclaim_prefix(self, step: int) -> bool:
        if self._prefix_index is None:
            return False
        return self._prefix_index.evict_one(self, step)

    def _refs(self, mode: int, phys: int) -> list[tuple[int, int]]:
        """All logical keys currently mapping physical page (mode, phys)."""
        hits = np.argwhere(self.allocated & (self.page_mode == mode)
                           & (self.page_table == phys))
        return [(int(r), int(l)) for r, l in hits]

    def page_refcount(self, row: int, lp: int) -> int:
        if not self.allocated[row, lp]:
            return 0
        return self._refcount.get((int(self.page_mode[row, lp]),
                                   int(self.page_table[row, lp])), 1)

    def bytes_shared(self) -> int:
        """Bytes the sharing saves now: each extra ref of a physical page
        is storage a private copy would have cost."""
        return sum((rc - 1) * self._cost(m)
                   for (m, _p), rc in self._refcount.items() if rc > 1)

    def share_page(self, src_row: int, src_lp: int, dst_row: int,
                   dst_lp: int, step: int) -> None:
        """Alias the physical page behind (src_row, src_lp) into
        (dst_row, dst_lp): table writes and a refcount bump only."""
        assert self.allocated[src_row, src_lp], (src_row, src_lp)
        assert not self.allocated[dst_row, dst_lp], (dst_row, dst_lp)
        mode = int(self.page_mode[src_row, src_lp])
        phys = int(self.page_table[src_row, src_lp])
        self.page_table[dst_row, dst_lp] = phys
        self.page_mode[dst_row, dst_lp] = mode
        self.allocated[dst_row, dst_lp] = True
        self.last_write[dst_row, dst_lp] = step
        k = (mode, phys)
        self._refcount[k] = self._refcount.get(k, 1) + 1
        self._tables_cache = None

    def _move_canonical(self, src: tuple[int, int],
                        dst: tuple[int, int]) -> None:
        """Move whatever refresh/integrity metadata `src` holds to `dst`."""
        if src == dst:
            return
        pol = self.policies.pop(src, None)
        if pol is not None:
            self.policies[dst] = pol
        for d in (self._words, self._masters):
            if src in d:
                d[dst] = d.pop(src)
        for s in (self._dirty, self._pending):
            if src in s:
                s.discard(src)
                s.add(dst)

    def _rehome_meta(self, key: tuple[int, int], mode: int,
                     phys: int) -> None:
        """An alias of shared page (mode, phys) is releasing: if it held
        the canonical metadata, hand it to a surviving ref (the highest
        row: the share band outranks decode rows, so an entry keeps
        custody of its own pages)."""
        if (key not in self.policies and key not in self._words
                and key not in self._masters and key not in self._pending
                and key not in self._dirty):
            return
        refs = [r for r in self._refs(mode, phys) if r != key]
        if not refs:
            return
        self._move_canonical(key, max(refs))

    def register_entry_pages(self, erow: int, src_row: int, n_pages: int,
                             step: int) -> None:
        """Anchor a freshly prefilled prefix: alias `src_row`'s first
        `n_pages` pages into share-band row `erow` and move each page's
        canonical metadata there."""
        for lp in range(n_pages):
            self.share_page(src_row, lp, erow, lp, step)
            self._move_canonical((src_row, lp), (erow, lp))

    def note_entry_use(self, erow: int, n_tokens: int, step: int) -> None:
        """A hit re-warmed the entry's first ceil(n/page) pages: reset
        coldness (NOT the retention clock — no bits were rewritten)."""
        for lp in range(-(-n_tokens // self.geom.page_size)):
            if self.allocated[erow, lp]:
                self.last_write[erow, lp] = step

    def _prefix_idle_counts(self) -> tuple[int, int]:
        """(normal, augmented) physical pages held ONLY by share-band
        entries: headroom, since `_reclaim_prefix` frees them."""
        if not self.share_entries:
            return 0, 0
        counts: dict[tuple[int, int], int] = {}
        base = self._share_base
        for erow in range(base, base + self.share_entries):
            for lp in np.flatnonzero(self.allocated[erow]):
                k = (int(self.page_mode[erow, lp]),
                     int(self.page_table[erow, lp]))
                counts[k] = counts.get(k, 0) + 1
        idle = [k for k, n in counts.items()
                if self._refcount.get(k, 0) == n]
        return (sum(1 for m, _ in idle if m == 0),
                sum(1 for m, _ in idle if m == 1))

    def _cow_page(self, row: int, lp: int, keep: int, step: int) -> bool:
        """Copy-on-write: (row, lp) aliases a shared physical page and is
        about to diverge at token `keep` of the page. Copy tokens
        [0, keep) into a private page, scrub the rest, and repoint only
        this row. False = pool exhausted."""
        src_mode = int(self.page_mode[row, lp])
        src_phys = int(self.page_table[row, lp])
        order = {"normal-only": (0,), "always-augmented": (1,),
                 "augment-on-pressure": (0, 1)}[self.pool_mode]
        dst_mode = None
        while dst_mode is None:
            for mode in order:
                free = self.free_normal if mode == 0 else self.free_packed
                if free and self.live_bytes + self._cost(mode) \
                        <= self.budget_bytes:
                    dst_mode = mode
                    break
            else:
                if self.pool_mode == "augment-on-pressure" \
                        and self._augment_coldest(step):
                    continue
                if self._reclaim_prefix(step):
                    # the reclaim may have freed the source's last other
                    # ref: the page is then private and needs no copy
                    if self._refcount.get((src_mode, src_phys), 1) == 1:
                        return True
                    continue
                self.stats["alloc_failures"] += 1
                return False
        free = self.free_normal if dst_mode == 0 else self.free_packed
        dst_phys = free.pop()
        _cow_page_op(self.arenas, src_phys, dst_phys, keep,
                     src_mode=src_mode, dst_mode=dst_mode,
                     aug_bits=self.geom.aug_bits)
        self.stats["maintenance_dispatches"] += 1
        self.stats["cow_events"] += 1
        self.stats["cow_bytes"] += self._cost(src_mode) + self._cost(dst_mode)
        sk = (src_mode, src_phys)
        self._refcount[sk] = self._refcount.get(sk, 2) - 1
        self._refcount[(dst_mode, dst_phys)] = 1
        self._rehome_meta((row, lp), src_mode, src_phys)
        self.page_table[row, lp] = dst_phys
        self.page_mode[row, lp] = dst_mode
        self.last_write[row, lp] = step
        self.live_bytes += self._cost(dst_mode)
        self._live_by_mode[dst_mode] += 1
        self.stats["peak_live_bytes"] = max(self.stats["peak_live_bytes"],
                                            self.live_bytes)
        if dst_mode == 1:
            pol = RefreshPolicy(retention_steps=self.retention_steps)
            pol.stamp(step)
            self.policies[(row, lp)] = pol
            if self._fm is not None:
                self._dirty.add((row, lp))
        self._tables_cache = None
        if self._obs is not None:
            self._obs.store_event("cow", f"pg{src_phys}>{dst_phys}", step)
        return True

    # -- mode switching --------------------------------------------------------

    def _augmentable_count(self) -> int:
        # PHYSICAL Normal pages the pressure ladder may demote; shared
        # pages (refcount > 1) stay in place under their readers
        return sum(1 for (m, _p), rc in self._refcount.items()
                   if m == 0 and rc == 1)

    def _coldest_normal(self) -> Optional[tuple[int, int]]:
        cand = self.allocated & (self.page_mode == 0)
        if self.share_entries:
            for (m, phys), rc in self._refcount.items():
                if m == 0 and rc > 1:
                    cand &= ~((self.page_table == phys)
                              & (self.page_mode == 0))
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
        packed plane and give the byte difference back to the budget.
        Every alias of a shared page moves; a share-band page taking this
        path is a prefix DEMOTION (the alternative to eviction)."""
        assert self.page_mode[row, lp] == 0 and self.allocated[row, lp]
        src = int(self.page_table[row, lp])
        refs = self._refs(0, src)
        dst = self.free_packed.pop()
        _augment_page_op(self.arenas, src, dst, cfg=self.cfg)
        self.stats["maintenance_dispatches"] += 1
        self.free_normal.append(src)
        self._tables_cache = None
        for r, l in refs:
            self.page_table[r, l] = dst
            self.page_mode[r, l] = 1
        rc = self._refcount.pop((0, src), 1)
        self._refcount[(1, dst)] = rc
        self.live_bytes -= self._cost(0) - self._cost(1)
        self._live_by_mode[0] -= 1
        self._live_by_mode[1] += 1
        ckey = max(refs) if refs else (row, lp)
        pol = RefreshPolicy(retention_steps=self.retention_steps)
        pol.stamp(step)
        self.policies[ckey] = pol
        if self._fm is not None:
            self._dirty.add(ckey)
        self.stats["augment_events"] += 1
        self.stats["augment_bytes"] += self._cost(0) + self._cost(1)
        demoted = self.share_entries and ckey[0] >= self._share_base
        if demoted:
            self.stats["prefix_demotions"] += 1
        if self._obs is not None:
            self._obs.store_event("demote" if demoted else "augment",
                                  f"pg{dst}", step)

    def promote_page(self, row: int, lp: int, step: int) -> bool:
        """Augmented -> Normal when the budget has room again. Every alias
        of a shared page moves; its one canonical metadata key clears."""
        assert self.page_mode[row, lp] == 1 and self.allocated[row, lp]
        src = int(self.page_table[row, lp])
        refs = self._refs(1, src)
        ckey = max(refs) if refs else (row, lp)
        if ckey in self._pending:
            # never materialize a corrupted packed page into the Normal
            # plane: the fault pass must detect and heal it first
            return False
        cost_up = self._cost(0) - self._cost(1)
        if not self.free_normal \
                or self.live_bytes + cost_up > self.budget_bytes:
            return False
        dst = self.free_normal.pop()
        _promote_page_op(self.arenas, src, dst, aug_bits=self.geom.aug_bits)
        self.stats["maintenance_dispatches"] += 1
        self.free_packed.append(src)
        self._tables_cache = None
        for r, l in refs:
            self.page_table[r, l] = dst
            self.page_mode[r, l] = 0
            self.last_write[r, l] = step
        rc = self._refcount.pop((1, src), 1)
        self._refcount[(0, dst)] = rc
        self.live_bytes += cost_up
        self._live_by_mode[1] -= 1
        self._live_by_mode[0] += 1
        self.policies.pop(ckey, None)
        self._words.pop(ckey, None)
        self._masters.pop(ckey, None)
        self._dirty.discard(ckey)
        self.stats["promote_events"] += 1
        if self._obs is not None:
            self._obs.store_event("promote", f"pg{dst}", step)
        return True

    # -- retention / refresh ----------------------------------------------------

    def note_writes(self, rows: np.ndarray, lps: np.ndarray,
                    step: int) -> None:
        """Stamp pages written by this dispatch: resets both coldness and
        the retention clock."""
        for row, lp in zip(np.asarray(rows).ravel(), np.asarray(lps).ravel()):
            row, lp = int(row), int(lp)
            if not self.allocated[row, lp]:
                continue
            self.last_write[row, lp] = step
            pol = self.policies.get((row, lp))
            if pol is not None:
                pol.stamp(step)
                if self._fm is not None:
                    self._dirty.add((row, lp))

    def note_token_writes(self, rows: np.ndarray, positions: np.ndarray,
                          step: int) -> None:
        """Stamp the pages the given absolute positions land in."""
        self.note_writes(rows, np.asarray(positions).ravel()
                         // self.geom.page_size, step)

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
        if (self._fm is not None and (row, lp) in self.policies
                and self._fm.refresh_miss(self._unit_id((row, lp)), step)):
            # the refresh pulse itself failed: the page keeps its old
            # stamp and ages toward a certain fault that the scan catches
            self.stats["refresh_misses"] += 1
            return
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
        if self._obs is not None:
            self._obs.store_event("restamp", f"r{row}.p{lp}", step)

    def refresh(self, key: tuple, step: int) -> None:
        self.refresh_page(key[0], key[1], step)

    def max_augmented_age(self, step: int) -> int:
        """Oldest unrefreshed Augmented page, in steps (the scheduler
        keeps it <= retention_steps)."""
        return max((pol.age(step) for pol in self.policies.values()),
                   default=0)

    # -- observability ----------------------------------------------------------

    def attach_obs(self, obs) -> None:
        """Wire the engine's observability facade: mode transitions and
        fault injections emit refresh- and fault-lane events from here."""
        self._obs = obs

    def mode_mix(self) -> tuple[int, int]:
        """(live Normal pages, live Augmented pages): one sample of the
        mode-mix timeline. O(1), from the incremental counters;
        `describe()` reports the same pair."""
        return self._live_by_mode[0], self._live_by_mode[1]

    # -- retention-fault injection / detection / healing ------------------------
    # Only Augmented pages are at risk: the Normal plane is the paper's
    # static configuration and never decays.

    def attach_fault_model(self, fm: F.FaultModel, *,
                           integrity: bool = True, tag: str = "") -> None:
        """`tag` prefixes every unit id (a composite store names its
        part), so the seeded fault draws follow it."""
        self._fm = fm
        self._integrity = integrity
        self._fault_tag = tag
        # pages placed before the attach have no integrity words yet
        self._dirty.update(self.policies.keys())

    def _unit_id(self, key: tuple[int, int]) -> str:
        """PHYSICAL identity of the cells behind a logical page: repeat
        offenders are tracked by the weak array, not its tenant."""
        return f"{self._fault_tag}pg{int(self.page_table[key])}"

    def _page_words(self, keys: list) -> list[int]:
        """Integrity words of the packed pages behind `keys`, computed on
        the device: each page's kp, vp, ks, vs bytes (all layers, in that
        order) times their running 1-based offsets, summed in int64 and
        cut to 32 bits — `core.faults.integrity_word` of the same bytes
        (the sum stays far below 2**63, so int64 keeps its low 32 bits
        exactly as the uint64 sum does). Pages are summed WORD_CHUNK_BYTES
        of page bytes at a time, so the int64 temporaries stay bounded
        whatever the pool holds. One host copy for all keys."""
        if not keys:
            return []
        phys = torch.tensor([int(self.page_table[k]) for k in keys],
                            device=self.device)
        page_bytes = sum(self.arenas[k][:, 0].numel()
                         * self.arenas[k].element_size()
                         for k in PACKED_PLANES)
        if self._word_weights is None:
            self._word_weights = torch.arange(
                1, page_bytes + 1, dtype=torch.int64, device=self.device)
        n = max(1, WORD_CHUNK_BYTES // page_bytes)
        words = []
        for sel in phys.split(n):
            data = torch.cat([self.arenas[k].index_select(1, sel)
                              .movedim(1, 0).contiguous().view(torch.uint8)
                              .reshape(len(sel), -1)
                              for k in PACKED_PLANES], dim=1)
            words.append((data.to(torch.int64) * self._word_weights)
                         .sum(dim=1))
        return [int(w) for w in (torch.cat(words) & 0xFFFFFFFF).cpu()]

    def _flush_integrity(self) -> None:
        """Bring the integrity words up to date for every Augmented page
        (re)written since the last flush. Prefix- and share-band pages
        (rows >= max_batch, written once) also stash a host master copy,
        the source of `scrub_from_master`."""
        keys = [key for key in self.policies
                if key not in self._words or key in self._dirty]
        for key, word in zip(keys, self._page_words(keys)):
            self._words[key] = word
            if key[0] >= self.max_batch:
                phys = int(self.page_table[key])
                # a copy (`.cpu()` of a CPU tensor would alias the arena)
                self._masters[key] = (tuple(
                    self.arenas[k][:, phys].to("cpu", copy=True)
                    for k in PACKED_PLANES), word)
        self._dirty.clear()

    def inject_faults(self, step: int) -> int:
        """Sample retention faults for every live Augmented page and
        corrupt its packed bytes on the device (deterministic under the
        model's seed). Returns the number of pages corrupted."""
        if self._fm is None:
            return 0
        self._flush_integrity()
        n = 0
        for key, pol in list(self.policies.items()):
            if key in self._pending:
                continue
            uid = self._unit_id(key)
            if self._fm.fault(uid, step, pol.age(step), self.retention_steps):
                phys = int(self.page_table[key])
                _corrupt_page_op(self.arenas, phys,
                                 self._fm.corruption_mask(uid, step))
                self._pending.add(key)
                self.stats["faults_injected"] += 1
                if self._obs is not None:
                    self._obs.on_fault("inject", uid, step)
                n += 1
        return n

    def scan_integrity(self, step: int) -> list[tuple[int, int]]:
        """Check every Augmented page against its stored integrity word;
        return the corrupted keys (detected, never served). With
        integrity off this is a no-op and zero silent corruption is
        forfeited by the config."""
        if self._fm is None or not self._integrity:
            return []
        self._flush_integrity()
        keys = list(self._words)
        bad: list[tuple[int, int]] = []
        for key, now in zip(keys, self._page_words(keys)):
            self.stats["integrity_checks"] += 1
            if now == self._words[key]:
                continue
            bad.append(key)
            self._pending.discard(key)
            self.stats["faults_detected"] += 1
            uid = self._unit_id(key)
            self._offenders[uid] = self._offenders.get(uid, 0) + 1
            if (self._offenders[uid] >= self._fm.pin_threshold
                    and key[0] < self.max_batch):
                # decode-row repeat offender: retire the weak physical
                # page when its current tenant releases it
                self._decommission.add(int(self.page_table[key]))
        return bad

    def scrub_from_master(self, key: tuple[int, int]) -> bool:
        """Heal a detected-corrupt page by re-writing it from its host
        master (prefix- and share-band pages only; decode-row pages have
        none and are recomputed). A repeat offender is pinned back to the
        Normal plane when the budget allows."""
        master = self._masters.get(key)
        if master is None:
            return False
        planes, word = master
        _restore_page_op(self.arenas, int(self.page_table[key]), planes)
        self.stats["maintenance_dispatches"] += 1
        self._words[key] = word
        self._dirty.discard(key)
        if self._offenders.get(self._unit_id(key), 0) \
                >= self._fm.pin_threshold:
            if self.promote_page(key[0], key[1], step=0):
                self.stats["pinned_normal"] += 1
        return True

    def fault_row(self, key: tuple[int, int]) -> Optional[int]:
        """Engine row whose request owns the faulted page (a prefix-band
        row maps back to its slot; share-band rows have no single owner:
        an unhealed fault there is left to entry eviction, not to
        retrying one request)."""
        row = key[0]
        if row >= self._share_base:
            return None
        return row if row < self.max_batch else row - self.max_batch

    def fault_unit_bytes(self, key: tuple[int, int]) -> int:
        return self.geom.page_bytes_aug

    def fault_counters(self) -> dict:
        return {k: self.stats[k] for k in FAULT_COUNTERS}

    def faults_pending(self) -> int:
        """Injected corruptions not yet scanned, still in the arenas."""
        return len(self._pending)

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
        """The decode band's (page_table, page_modes) on the device, each
        band at its own width, cached until the tables change (the share
        band is never read). With a static prefix, also the prefix band's
        as ``cross_table`` / ``cross_modes`` and ``cross_lengths``: the
        prefix length on a row whose band is allocated, 0 on an idle
        slot."""
        if self._tables_cache is None:
            B, maxP, Pc = self.max_batch, self.max_pages, self.prefix_pages

            def dev(a: np.ndarray) -> torch.Tensor:
                return torch.from_numpy(np.ascontiguousarray(a)).to(
                    self.device)
            tables = {"page_table": dev(self.page_table[:B, :maxP]),
                      "page_modes": dev(self.page_mode[:B, :maxP])}
            if Pc:
                band = slice(B, 2 * B)
                tables.update(
                    cross_table=dev(self.page_table[band, :Pc]),
                    cross_modes=dev(self.page_mode[band, :Pc]),
                    cross_lengths=dev(np.where(
                        self.allocated[band, :Pc].any(axis=1),
                        self.prefix_tokens, 0).astype(np.int32)))
            self._tables_cache = tables
        return self._tables_cache

    def arena_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.arenas.values())

    def describe(self) -> dict:
        g = self.geom
        # PHYSICAL live pages (aliases of a shared page count once), by
        # reduction: the cross-check of mode_mix()'s incremental counters
        live_n = sum(1 for (m, _p) in self._refcount if m == 0)
        live_a = sum(1 for (m, _p) in self._refcount if m == 1)
        return {
            "kind": self.kind,
            "pool_mode": self.pool_mode,
            "page_size": g.page_size,
            "aug_bits": g.aug_bits,
            "prefix_tokens": self.prefix_tokens,
            "pages_live_normal": live_n,
            "pages_live_augmented": live_a,
            "pages_shared": sum(1 for rc in self._refcount.values()
                                if rc > 1),
            "bytes_shared": self.bytes_shared(),
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
# maintenance ops: each updates the arenas in place
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
    """Scrub one physical page in its plane (prefix-page allocation)."""
    for k in (("kn", "vn") if mode == 0 else ("kp", "vp", "ks", "vs")):
        arenas[k][:, phys] = 0


def _cow_page_op(arenas: dict, src: int, dst: int, keep: int, *,
                 src_mode: int, dst_mode: int, aug_bits: int) -> None:
    """Masked page copy for a copy-on-write divergence: tokens [0, keep)
    of physical page `src` land in `dst` (crossing planes when the modes
    differ), the rest of `dst` is scrubbed to the plane's neutral value
    (zeros, scale 1). The Normal -> Augmented int4 leg packs through
    `quantize_pack_kv(x, valid)`: the masked pack (kernel 3b) on a card."""
    P = arenas["kn"].shape[3]
    tok = torch.arange(P, device=arenas["kn"].device) < keep
    row_mask = tok[None, None, :, None]                  # (1, 1, page, 1)
    if src_mode == 0 and dst_mode == 0:
        for k in ("kn", "vn"):
            arenas[k][:, dst] = torch.where(row_mask, arenas[k][:, src], 0)
    elif src_mode == 1 and dst_mode == 1:
        for p, s in (("kp", "ks"), ("vp", "vs")):
            pg = arenas[p][:, src]
            sc = arenas[s][:, src]
            arenas[p][:, dst] = torch.where(row_mask, pg,
                                            torch.zeros_like(pg))
            arenas[s][:, dst] = torch.where(tok[None, None, :], sc,
                                            torch.ones_like(sc))
    elif src_mode == 0 and dst_mode == 1:
        for plane, packed, scale in (("kn", "kp", "ks"), ("vn", "vp", "vs")):
            x = arenas[plane][:, src]                    # (L, KV, page, hd)
            if aug_bits == 4:
                p, s = K.quantize_pack_kv(x, tok[None, None, :])
            else:
                p, s = L.pack_kv_int8(x)
                p = torch.where(row_mask, p, torch.zeros_like(p))
                s = torch.where(row_mask, s, torch.ones_like(s))
            arenas[packed][:, dst] = p
            arenas[scale][:, dst] = s[..., 0].to(torch.bfloat16)
    else:                                                # Augmented -> Normal
        unpack = L.unpack_kv_int4 if aug_bits == 4 else L.unpack_kv_int8
        for plane, packed, scale in (("kn", "kp", "ks"), ("vn", "vp", "vs")):
            d = unpack(arenas[packed][:, src],
                       arenas[scale][:, src][..., None])
            arenas[plane][:, dst] = torch.where(row_mask, d, 0).to(
                torch.bfloat16)


def _corrupt_page_op(arenas: dict, phys: int, mask: int) -> None:
    """Retention-fault injection: XOR the packed bytes of physical page
    `phys` (K and V, all layers) with the nonzero byte `mask`, through a
    uint8 view that serves the int4 and int8 planes alike."""
    for k in ("kp", "vp"):
        arenas[k][:, phys].view(torch.uint8).bitwise_xor_(mask)


def _restore_page_op(arenas: dict, phys: int, planes: tuple) -> None:
    """Scrub on detect: re-write packed page `phys` from its host master
    (kp, vp, ks, vs)."""
    for k, v in zip(PACKED_PLANES, planes):
        arenas[k][:, phys] = v.to(arenas[k].device)
