"""Fleet-visible prefix index: token-hash lookup of cached prompt-prefix
page runs in a `PagedKVPool`'s share band.

Production prompts are dominated by shared system prompts and multi-turn
sessions; re-prefilling the common prefix per request is the biggest
redundant cost in the serving hot path. This index closes it:

  * `register` anchors a freshly prefilled prefix: the engine aliases
    the request's first full pages into a SHARE-band row of the pool
    (`register_entry_pages`) and this index records a CHAIN HASH per
    page-aligned depth (`H_i = crc32(tokens[i*P:(i+1)*P], H_{i-1})`).
  * `match` walks a new prompt's chain hashes deepest-first; a hit is
    verified token-exact, then extended token-granularly into the
    entry's boundary page — so mid-page sharing works, with the pool's
    copy-on-write path covering the divergence write.
  * Entries are evicted LRU at refcount 0 only; under byte pressure the
    pool DEMOTES cold entry pages Normal -> Augmented instead (the
    dual-context ROM-augmented 8T RAM of arXiv:2304.02908 — the second
    context keeps the data alive in denser, refresh-backed storage).

The index is host-only metadata (no device state); the pool owns the
pages, refcounts, and byte accounting.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Optional

import numpy as np


def chain_hashes(tokens: np.ndarray, page_size: int) -> list[int]:
    """Chained crc32 per full page of `tokens`: hash i covers pages
    [0, i] — prefix containment is a chain-walk, not a rehash."""
    tokens = np.ascontiguousarray(np.asarray(tokens, np.int32))
    out: list[int] = []
    h = 0
    for i in range(tokens.size // page_size):
        h = zlib.crc32(tokens[i * page_size:(i + 1) * page_size].tobytes(), h)
        out.append(h)
    return out


@dataclasses.dataclass
class PrefixEntry:
    slot: int                   # share-band slot (pool row = entry_row(slot))
    row: int                    # pool share-band row anchoring the pages
    tokens: np.ndarray          # the cached run (page-aligned length)
    n_pages: int
    hashes: list[int]           # chain hash per page depth
    hits: int = 0
    last_use_step: int = -1
    created_step: int = -1


class PrefixIndex:
    """Hash index over cached prefix entries. Pure host metadata —
    `match` never mutates pool state, so placement can probe it."""

    def __init__(self, entries: int, page_size: int):
        self.capacity = entries
        self.page_size = page_size
        self.entries: dict[int, PrefixEntry] = {}        # by slot
        self._free_slots = list(range(entries - 1, -1, -1))
        self._by_hash: dict[int, list[int]] = {}         # hash -> slots
        self.stats = {"hits": 0, "misses": 0, "tokens_shared": 0,
                      "registered": 0, "evicted": 0, "invalidated": 0}

    # -- lookup ----------------------------------------------------------------

    def match(self, tokens: np.ndarray) -> tuple[Optional[PrefixEntry], int]:
        """Deepest cached prefix of `tokens`: (entry, n_matched_tokens),
        or (None, 0). Page-granular via the chain hashes, then extended
        token-granularly into the entry's boundary page (only possible
        when the entry has a page past the matched depth). PURE."""
        tokens = np.asarray(tokens, np.int32)
        P = self.page_size
        hs = chain_hashes(tokens, P)
        for d in range(len(hs), 0, -1):
            slots = self._by_hash.get(hs[d - 1])
            if not slots:
                continue
            # among same-depth candidates, the one whose boundary page
            # extends furthest wins (ties -> first registered)
            best, best_m = None, 0
            for slot in slots:
                e = self.entries.get(slot)
                if e is None or e.n_pages < d:
                    continue
                if not np.array_equal(e.tokens[:d * P], tokens[:d * P]):
                    continue        # crc collision — verify token-exact
                m = d * P
                if d < e.n_pages:   # extend into the boundary page
                    lim = min(tokens.size, (d + 1) * P)
                    while m < lim and int(e.tokens[m]) == int(tokens[m]):
                        m += 1
                if best is None or m > best_m:
                    best, best_m = e, m
            if best is not None:
                return best, best_m
        return None, 0

    def note_hit(self, e: PrefixEntry, m: int, step: int) -> None:
        e.hits += 1
        e.last_use_step = step
        self.stats["hits"] += 1
        self.stats["tokens_shared"] += m

    def note_miss(self) -> None:
        self.stats["misses"] += 1

    # -- registration / eviction -----------------------------------------------

    def acquire_slot(self, pool, step: int) -> Optional[int]:
        """A free share-band slot, LRU-evicting an idle entry if full.
        None when every entry's pages are still mapped by live rows."""
        if self._free_slots:
            return self._free_slots.pop()
        if self.evict_one(pool, step):
            return self._free_slots.pop()
        return None

    def add_entry(self, slot: int, row: int, tokens: np.ndarray,
                  step: int) -> PrefixEntry:
        tokens = np.asarray(tokens, np.int32).copy()
        hashes = chain_hashes(tokens, self.page_size)
        n_pages = len(hashes)
        assert n_pages and tokens.size == n_pages * self.page_size
        e = PrefixEntry(slot=slot, row=row, tokens=tokens, n_pages=n_pages,
                        hashes=hashes, last_use_step=step, created_step=step)
        self.entries[slot] = e
        for h in hashes:
            self._by_hash.setdefault(h, []).append(slot)
        self.stats["registered"] += 1
        return e

    def _unlink(self, e: PrefixEntry) -> None:
        for h in e.hashes:
            slots = self._by_hash.get(h)
            if slots and e.slot in slots:
                slots.remove(e.slot)
                if not slots:
                    del self._by_hash[h]
        self.entries.pop(e.slot, None)
        self._free_slots.append(e.slot)

    def _idle(self, pool, e: PrefixEntry) -> bool:
        """Every page of `e` is held only by share-band refs (refcount
        == share-band aliases) — freeing the entry row drops them to 0."""
        for lp in range(e.n_pages):
            if not pool.allocated[e.row, lp]:
                continue
            if pool.page_refcount(e.row, lp) > 1:
                return False
        return True

    def evict_one(self, pool, step: int) -> bool:
        """Evict the least-recently-used IDLE entry, freeing its pages
        (refcount 0 by construction). False = every entry is live."""
        cand = [e for e in self.entries.values() if self._idle(pool, e)]
        if not cand:
            return False
        victim = min(cand, key=lambda e: (e.last_use_step, e.created_step))
        pool.free_row(victim.row)
        pool.stats["prefix_evictions"] += 1
        self._unlink(victim)
        self.stats["evicted"] += 1
        return True

    def invalidate(self, pool) -> None:
        """Drop every entry (array loss: the arenas behind the pages are
        gone; the hash index must not serve stale physical pages)."""
        for e in list(self.entries.values()):
            pool.free_row(e.row)
            self._unlink(e)
            self.stats["invalidated"] += 1

    # -- placement probe / introspection ---------------------------------------

    def probe(self, tokens: np.ndarray) -> int:
        """Matched-token count only (pure, cheap) — the affinity
        placement policy's prefix-locality signal."""
        _e, m = self.match(tokens)
        return m

    def describe(self) -> dict:
        total = self.stats["hits"] + self.stats["misses"]
        return {
            "capacity": self.capacity,
            "entries": len(self.entries),
            "hit_rate": self.stats["hits"] / total if total else 0.0,
            **self.stats,
        }
