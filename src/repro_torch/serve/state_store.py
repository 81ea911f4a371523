"""Decode-state stores behind one interface, and the per-family step
functions over them.

Ports `repro.serve.state_store`: dense and moe rows on a `PagedKVPool`
(serve/cache_pool.py), audio rows on one with a static prefix band (the
cross KV), ssm and hybrid rows on an `AugmentedStatePool` of FIXED-SIZE
per-row slabs (the SSD state and conv ring of an ssm row; the LRU state,
conv tails and ring-window KV of a hybrid row), and vlm rows on a
`CompositeStore` of both: the self KV on pages, the static patch KV on a
write-once slab store. A slab lives in one of two modes against one byte
budget:

  Normal     native dtype (bf16 / f32) rows in the ``normal`` plane
  Augmented  int8 or nibble-packed int4 rows + per-vector bf16 scales
             (``packed`` + ``scale`` planes)

Under pressure the pool augments cold slabs in place so that more rows
can be admitted. An Augmented slab is dynamic storage: every decode step
reads it through the sense amplifier (dequantize), updates it, and writes
it back through the write driver (quantize), which restamps its
`RefreshPolicy`. Integer leaves (the already-packed ring KV) and their
trailing-dim-1 scale leaves pass through the normal plane unchanged.

Speculative decoding on slabs snapshots the planes before the drafts and
restores them before the verify, which replays the window as W calls of
the family's single-token step and commits the state after the accepted
prefix (`slab_verify`). With a `FaultModel` attached, Augmented slabs
fault by retention, carry integrity words (`core.faults.integrity_word`
of their packed and scale bytes, computed on the device), and are scanned
every step; repeat offenders are pinned to the Normal plane.

The planes key their leaves by the JAX package's key strings
("['blocks']['conv_a']"), so a plane of either package is addressed by
the same name.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import faults as F
from repro_torch.core import quant
from repro_torch.core.retention import RefreshPolicy
from repro_torch.models import model as M
from repro_torch.models.params import PSpec
from repro_torch.serve.cache_pool import (FAULT_COUNTERS, WORD_CHUNK_BYTES,
                                         PagedKVPool, resolve_pool_mode)


def _flatten(tree: dict, prefix: str = ""):
    """(key string, leaf) pairs in sorted-key order, keyed as
    `jax.tree_util.keystr` keys a dict tree."""
    for k in sorted(tree):
        v = tree[k]
        key = f"{prefix}['{k}']"
        if isinstance(v, dict):
            yield from _flatten(v, key)
        else:
            yield key, v


def _map(tree: dict, fn, prefix: str = "") -> dict:
    """The same tree with fn(key, leaf) at every leaf."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}['{k}']"
        out[k] = _map(v, fn, key) if isinstance(v, dict) else fn(key, v)
    return out


def _leaf_at(tree: dict, key: str):
    for part in key[2:-2].split("']['"):
        tree = tree[part]
    return tree


# ---------------------------------------------------------------------------
# slab-plane ops (plain torch, on the device the planes live on)
# ---------------------------------------------------------------------------

def _quant_leaf(x: torch.Tensor, bits: int):
    """Float leaf -> (packed, scale) with per-vector (last-axis) scales,
    quantized in float32. int8 stores one value a byte; int4 nibble-packs
    adjacent pairs."""
    if bits == 8:
        q, s = quant.quantize_int8(x.float())
        return q, s.to(torch.bfloat16)
    q, s = quant.quantize_int4(x.float())
    return (quant.pack_int4_pair(q[..., ::2], q[..., 1::2]),
            s.to(torch.bfloat16))


def _dequant_leaf(p: torch.Tensor, s: torch.Tensor, bits: int,
                  dtype) -> torch.Tensor:
    if bits == 8:
        return quant.dequantize(p, s, dtype)
    q = torch.stack([quant.unpack_int4_hi(p), quant.unpack_int4_lo(p)],
                    dim=-1).reshape(*p.shape[:-1], -1)
    return quant.dequantize(q, s, dtype)


def _packed_zeros(leaf: torch.Tensor, bits: int):
    """(packed, scale) zero planes matching `leaf` (level 0 reads back as
    an exact 0.0 whatever the scale)."""
    if bits == 8:
        p = torch.zeros(leaf.shape, dtype=torch.int8, device=leaf.device)
    else:
        if leaf.shape[-1] % 2:
            raise ValueError(f"state_bits=4 needs an even trailing dim, got "
                             f"{tuple(leaf.shape)}")
        p = torch.zeros(leaf.shape[:-1] + (leaf.shape[-1] // 2,),
                        dtype=torch.uint8, device=leaf.device)
    s = torch.ones(leaf.shape[:-1] + (1,), dtype=torch.bfloat16,
                   device=leaf.device)
    return p, s


def _row_view(mask: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """(B,) per-slot mask -> broadcastable over a slab leaf (batch at axis
    1)."""
    return mask.reshape((1, mask.shape[0]) + (1,) * (leaf.ndim - 2))


def _quantizable(leaf) -> bool:
    """Whether a slab leaf takes the packed plane: float data with a real
    vector axis. Integer leaves are packed storage already, and
    trailing-dim-1 float leaves are the SCALES of such storage; both pass
    through the normal plane."""
    return leaf.dtype.is_floating_point and leaf.shape[-1] > 1


def slab_reconstitute(state: dict, modes: Optional[torch.Tensor],
                      bits: int) -> dict:
    """Merge the planes into the logical native-dtype cache tree the family
    decode step consumes: Normal slots read the ``normal`` plane,
    Augmented slots dequantize the ``packed`` plane. A single-plane state
    (normal-only pool) passes through."""
    if "packed" not in state:
        return state["normal"]

    def merge(key, leaf):
        if key not in state["packed"]:
            return leaf
        d = _dequant_leaf(state["packed"][key], state["scale"][key], bits,
                          leaf.dtype)
        return torch.where(_row_view(modes == 1, leaf), d, leaf)
    return _map(state["normal"], merge)


def slab_store_back(state: dict, new_cache: dict,
                    modes: Optional[torch.Tensor], bits: int,
                    write: Optional[torch.Tensor] = None) -> dict:
    """Write the updated cache back into each slot's plane: Normal slots
    into ``normal``, Augmented slots quantized into ``packed`` (the write
    driver); each written slot's other plane is zeroed. Rows outside the
    (B,) `write` mask keep both planes bit-identical. Returns a new state;
    the planes given are not modified."""
    if "packed" not in state:
        if write is None:
            return {"normal": new_cache}
        return {"normal": _map(new_cache, lambda key, new: torch.where(
            _row_view(write, new), new, _leaf_at(state["normal"], key)))}
    packed_out, scale_out = dict(state["packed"]), dict(state["scale"])

    def back(key, leaf):
        old = _leaf_at(state["normal"], key)
        w = (torch.ones((), dtype=torch.bool, device=leaf.device)
             if write is None else _row_view(write, leaf))
        if key in state["packed"]:
            aug = _row_view(modes == 1, leaf)
            q, s = _quant_leaf(leaf, bits)
            packed_out[key] = torch.where(
                w & aug, q, torch.where(w, torch.zeros_like(q),
                                        state["packed"][key]))
            scale_out[key] = torch.where(
                w & aug, s, torch.where(w, torch.ones_like(s),
                                        state["scale"][key]))
            leaf = torch.where(aug, torch.zeros_like(leaf), leaf)
        return torch.where(w, leaf, old)
    normal_out = _map(new_cache, back)
    return {"normal": normal_out, "packed": packed_out, "scale": scale_out}


def _reset_row_op(state: dict, row: int) -> None:
    """Zero one slot across every plane, in place (admission starts from
    fresh state; a recycled row must not leak its last request's)."""
    for _, leaf in _flatten(state["normal"]):
        if leaf.ndim >= 2 and leaf.shape[0] != 0:
            leaf[:, row] = 0
    if "packed" in state:
        for v in state["packed"].values():
            v[:, row] = 0
        for v in state["scale"].values():
            v[:, row] = 1


def _augment_row_op(state: dict, row: int, *, bits: int) -> None:
    """Normal -> Augmented for one slot, in place: quantize its float rows
    into the packed plane and drop the native master."""
    for key, leaf in _flatten(state["normal"]):
        if key in state["packed"]:
            q, s = _quant_leaf(leaf[:, row], bits)
            state["packed"][key][:, row] = q
            state["scale"][key][:, row] = s
            leaf[:, row] = 0


def _promote_row_op(state: dict, row: int, *, bits: int) -> None:
    """Augmented -> Normal for one slot (refresh-promote), in place."""
    for key, leaf in _flatten(state["normal"]):
        if key in state["packed"]:
            leaf[:, row] = _dequant_leaf(state["packed"][key][:, row],
                                         state["scale"][key][:, row], bits,
                                         leaf.dtype)
            state["packed"][key][:, row] = 0


def _corrupt_row_op(state: dict, row: int, mask: int) -> None:
    """Retention-fault injection: XOR slot `row` of every packed plane
    with the nonzero byte `mask`, in place, through a uint8 view that
    serves the int8 and the nibble-packed planes alike."""
    for v in state["packed"].values():
        v[:, row].view(torch.uint8).bitwise_xor_(mask)


def _restore_row_op(state: dict, row: int, packed: dict,
                    scale: dict) -> None:
    """Scrub on detect: re-write slot `row`'s packed and scale planes from
    host masters, in place."""
    for plane, src in (("packed", packed), ("scale", scale)):
        for k, v in state[plane].items():
            v[:, row] = src[k].to(v.device)


# ---------------------------------------------------------------------------
# AugmentedStatePool — fixed-size per-row decode-state slabs
# ---------------------------------------------------------------------------

class AugmentedStatePool:
    """See the module docstring. `specs` is the family's decode-state tree
    (`PSpec` leaves, batch at axis 1). `static=True` marks a write-once
    store (a prefix that decode never rewrites): its Augmented slabs age
    until refreshed, and their integrity flush keeps a host master copy,
    the source of `scrub_from_master`. `table_key` names the slot-mode
    table in `device_tables` (a vlm prefix store's is "prefix_modes")."""

    kind = "slab"

    def __init__(self, cfg: ModelConfig, specs: dict, *, max_batch: int,
                 device: torch.device, budget_bytes: Optional[int] = None,
                 retention_steps: Optional[int] = None,
                 static: bool = False, table_key: str = "slot_modes"):
        self.cfg = cfg
        self.device = device
        self.max_batch = max_batch
        self.static = static
        self.table_key = table_key
        # "auto" pins slabs to Normal: kv_mode governs the KV cache (the
        # family packs its ring KV itself); quantizing the accumulated
        # recurrent state is a lossy decision pool_mode must opt into
        self.pool_mode = ("normal-only" if cfg.amc.pool_mode == "auto"
                          else resolve_pool_mode(cfg))
        self.state_bits = cfg.amc.state_bits
        if self.state_bits not in (4, 8):
            raise ValueError(f"state_bits must be 4 or 8, got "
                             f"{self.state_bits}")
        self.retention_steps = (cfg.amc.retention_steps
                                if retention_steps is None
                                else retention_steps)

        def zeros(key, s: PSpec):
            if len(s.shape) < 2 or s.shape[1] != max_batch:
                raise ValueError(f"slab leaf {key} must carry the batch at "
                                 f"axis 1: {s.shape}")
            return torch.zeros(s.shape, dtype=s.dtype, device=device)
        normal = _map(specs, zeros)
        self._state = {"normal": normal}
        self.mixed = self.pool_mode != "normal-only"
        n_norm = n_aug = n_values = 0
        for _, leaf in _flatten(normal):
            per_slot = leaf.numel() // max_batch
            per_slot_bytes = per_slot * leaf.element_size()
            n_norm += per_slot_bytes
            n_values += per_slot
            if _quantizable(leaf):
                n_aug += (per_slot * self.state_bits // 8
                          + 2 * (per_slot // leaf.shape[-1]))
            else:
                n_aug += per_slot_bytes
        self.slab_bytes_normal, self.slab_bytes_aug = n_norm, n_aug
        self.values_per_slot = n_values
        if self.mixed:
            packed, scale = {}, {}
            for key, leaf in _flatten(normal):
                if _quantizable(leaf):
                    packed[key], scale[key] = _packed_zeros(leaf,
                                                            self.state_bits)
            self._state["packed"], self._state["scale"] = packed, scale
        cheapest = n_aug if self.mixed else n_norm
        self.budget_bytes = (max_batch * n_norm if budget_bytes is None
                             else budget_bytes)
        if self.budget_bytes < cheapest:
            raise ValueError(f"budget_bytes={self.budget_bytes} cannot hold "
                             f"one slab ({cheapest} B in the pool's "
                             f"cheapest mode)")
        self.live_bytes = 0
        self.slot_mode = np.zeros(max_batch, np.int32)   # 0 normal, 1 aug
        self.slot_alloc = np.zeros(max_batch, bool)
        self.last_write = np.full(max_batch, -1, np.int64)
        self.policies: dict[int, RefreshPolicy] = {}
        self._tables_cache: Optional[dict] = None
        self._spec_snapshot: Optional[dict] = None
        self._live_by_mode = [0, 0]
        self._obs = None        # EngineObs facade (attach_obs), optional
        self.stats = {
            "augment_events": 0, "promote_events": 0, "refreshes": 0,
            "refresh_bytes": 0, "augment_bytes": 0,
            "maintenance_dispatches": 0, "alloc_failures": 0,
            "peak_live_bytes": 0, "spec_snapshots": 0, "spec_rollbacks": 0,
            **dict.fromkeys(FAULT_COUNTERS[:-1], 0),
        }
        # retention faults: inert until a FaultModel is attached
        self._fm: Optional[F.FaultModel] = None
        self._integrity = False
        self._fault_tag = ""
        self._words: dict[int, int] = {}       # integrity word a slab
        self._dirty: set[int] = set()          # rewritten since a flush
        self._pending: set[int] = set()        # injected, not yet scanned
        self._masters: dict[int, tuple] = {}   # static stores' host copies
        self._offenders: dict[str, int] = {}   # detections a unit id
        self._pin_normal = np.zeros(max_batch, bool)   # repeat offenders
        self._word_weights: Optional[torch.Tensor] = None

    # -- byte accounting ------------------------------------------------------

    @property
    def aug_bits(self) -> int:
        return self.state_bits

    def _cost(self, mode: int) -> int:
        return self.slab_bytes_normal if mode == 0 else self.slab_bytes_aug

    def can_admit_tokens(self, n_tokens: int) -> bool:
        """Fixed-size slabs: the token count does not matter, only whether
        one more slab fits, augmenting cold Normal slabs if the policy
        allows."""
        free_b = self.budget_bytes - self.live_bytes
        if self.pool_mode == "normal-only":
            return self._cost(0) <= free_b
        if self.pool_mode == "augment-on-pressure" \
                and self._cost(0) <= free_b:
            return True
        need = self._cost(1) - free_b
        if need <= 0:
            return True
        if self.pool_mode != "augment-on-pressure":
            return False
        per = self._cost(0) - self._cost(1)
        n_norm = int((self.slot_alloc & (self.slot_mode == 0)).sum())
        return -(-need // per) <= n_norm

    # -- allocation -----------------------------------------------------------

    def admit_row(self, row: int, n_tokens: int, step: int) -> bool:
        assert not self.slot_alloc[row], row
        order = {"normal-only": (0,), "always-augmented": (1,),
                 "augment-on-pressure": (0, 1)}[self.pool_mode]
        if self._pin_normal[row] and self.pool_mode != "normal-only":
            # a repeat offender's dynamic cells misbehave: the static
            # plane first whenever the budget allows
            order = (0,) + tuple(m for m in order if m != 0)
        mode = None
        for m in order:
            if self.live_bytes + self._cost(m) <= self.budget_bytes:
                mode = m
                break
        if mode is None and self.pool_mode == "augment-on-pressure":
            while self.live_bytes + self._cost(1) > self.budget_bytes:
                if not self._augment_coldest(step):
                    self.stats["alloc_failures"] += 1
                    return False
            mode = 1
        if mode is None:
            self.stats["alloc_failures"] += 1
            return False
        self.slot_alloc[row] = True
        self.slot_mode[row] = mode
        self.last_write[row] = step
        self.live_bytes += self._cost(mode)
        self._live_by_mode[mode] += 1
        self.stats["peak_live_bytes"] = max(self.stats["peak_live_bytes"],
                                            self.live_bytes)
        if mode == 1:
            pol = RefreshPolicy(retention_steps=self.retention_steps)
            pol.stamp(step)
            self.policies[row] = pol
            if self._fm is not None:
                self._dirty.add(row)
        _reset_row_op(self._state, row)
        self.stats["maintenance_dispatches"] += 1
        self._tables_cache = None
        return True

    def ensure_position(self, row: int, pos: int, step: int) -> bool:
        """Slabs are fixed-size: an admitted row always has room."""
        return bool(self.slot_alloc[row])

    def max_row_tokens(self) -> Optional[int]:
        """A slab holds a row's whole state whatever its length: no
        per-row token bound."""
        return None

    def release_row(self, row: int) -> None:
        if not self.slot_alloc[row]:
            return
        if row in self._pending:
            # the corruption went with the row's state before any scan
            # reached it
            self._pending.discard(row)
            self.stats["faults_masked"] += 1
        self._words.pop(row, None)
        self._masters.pop(row, None)
        self._dirty.discard(row)
        mode = int(self.slot_mode[row])
        self.live_bytes -= self._cost(mode)
        self._live_by_mode[mode] -= 1
        self.slot_alloc[row] = False
        self.slot_mode[row] = 0
        self.last_write[row] = -1
        self.policies.pop(row, None)
        self._tables_cache = None

    # -- mode switching -------------------------------------------------------

    def _coldest_normal(self) -> Optional[int]:
        cand = self.slot_alloc & (self.slot_mode == 0) & ~self._pin_normal
        if not cand.any():
            return None
        age = np.where(cand, self.last_write, np.iinfo(np.int64).max)
        return int(age.argmin())

    def _augment_coldest(self, step: int) -> bool:
        row = self._coldest_normal()
        if row is None or not self.mixed:
            return False
        self.augment_slot(row, step)
        return True

    def augment_slot(self, row: int, step: int) -> None:
        """Normal -> Augmented in place: quantize the slab into the packed
        plane and give the byte difference back to the budget; the slab is
        then dynamic data on the retention clock."""
        assert self.mixed and self.slot_alloc[row] \
            and self.slot_mode[row] == 0
        _augment_row_op(self._state, row, bits=self.state_bits)
        self.stats["maintenance_dispatches"] += 1
        self.slot_mode[row] = 1
        self.live_bytes -= self._cost(0) - self._cost(1)
        self._live_by_mode[0] -= 1
        self._live_by_mode[1] += 1
        pol = RefreshPolicy(retention_steps=self.retention_steps)
        pol.stamp(step)
        self.policies[row] = pol
        if self._fm is not None:
            self._dirty.add(row)
        self.stats["augment_events"] += 1
        self.stats["augment_bytes"] += self._cost(0) + self._cost(1)
        self._tables_cache = None
        if self._obs is not None:
            self._obs.store_event("augment", f"slab{row}", step)

    def promote_slot(self, row: int, step: int) -> bool:
        """Augmented -> Normal (refresh-promote) when the budget has room."""
        assert self.slot_alloc[row] and self.slot_mode[row] == 1
        if row in self._pending:
            # never promote a corrupt packed slab into the static plane:
            # the fault pass detects and heals it first
            return False
        cost_up = self._cost(0) - self._cost(1)
        if self.live_bytes + cost_up > self.budget_bytes:
            return False
        _promote_row_op(self._state, row, bits=self.state_bits)
        self.stats["maintenance_dispatches"] += 1
        self.slot_mode[row] = 0
        self.live_bytes += cost_up
        self._live_by_mode[1] -= 1
        self._live_by_mode[0] += 1
        self.last_write[row] = step
        self.policies.pop(row, None)
        self._words.pop(row, None)
        self._masters.pop(row, None)
        self._dirty.discard(row)
        self.stats["promote_events"] += 1
        self._tables_cache = None
        if self._obs is not None:
            self._obs.store_event("promote", f"slab{row}", step)
        return True

    # -- retention / refresh --------------------------------------------------

    def note_token_writes(self, rows: np.ndarray, positions: np.ndarray,
                          step: int) -> None:
        """Decode rewrote these rows' slabs through the write driver:
        restamp coldness and (Augmented rows) the retention clock. A static
        store is never rewritten by decode."""
        if self.static:
            return
        for row in np.asarray(rows).ravel():
            row = int(row)
            if not self.slot_alloc[row]:
                continue
            self.last_write[row] = step
            pol = self.policies.get(row)
            if pol is not None:
                pol.stamp(step)
                if self._fm is not None:
                    self._dirty.add(row)

    def refresh_due(self, step: int) -> list[int]:
        return [row for row, pol in self.policies.items()
                if pol.needs_refresh(step)]

    def refresh(self, row: int, step: int) -> None:
        """Refresh one expired Augmented slab: promote it back to Normal
        when allowed and affordable, else restamp it in place and account
        the traffic."""
        pol = self.policies.get(row)
        if pol is None:
            return
        if (self._fm is not None
                and self._fm.refresh_miss(self._unit_id(row), step)):
            # the refresh pulse missed its slot: the slab keeps aging
            # toward a certain fault, which inject / scan then catch
            self.stats["refresh_misses"] += 1
            return
        if self.pool_mode == "augment-on-pressure" \
                and self.cfg.amc.refresh_promote \
                and self.promote_slot(row, step):
            self.stats["refreshes"] += 1
            self.stats["refresh_bytes"] += self._cost(1) + self._cost(0)
            return
        pol.stamp(step)
        self.stats["refreshes"] += 1
        self.stats["refresh_bytes"] += 2 * self._cost(1)   # read + re-write
        self.last_write[row] = step
        if self._obs is not None:
            self._obs.store_event("restamp", f"slab{row}", step)

    def max_augmented_age(self, step: int) -> int:
        """Oldest unrefreshed Augmented slab, in steps."""
        return max((pol.age(step) for pol in self.policies.values()),
                   default=0)

    # -- observability ----------------------------------------------------------

    def attach_obs(self, obs) -> None:
        """Wire the engine's observability facade: mode transitions emit
        refresh-lane events from here."""
        self._obs = obs

    def mode_mix(self) -> tuple[int, int]:
        """(live Normal slabs, live Augmented slabs): one sample of the
        mode-mix timeline. O(1), from the incremental counters;
        `describe()` recomputes the pair by reduction."""
        return self._live_by_mode[0], self._live_by_mode[1]

    # -- retention faults: inject / detect / heal ------------------------------
    # The page-level machinery of `PagedKVPool` at slab granularity. A
    # slab's physical unit is its slot (rows never migrate), so offender
    # tracking keys on the row.

    def attach_fault_model(self, fm: F.FaultModel, *,
                           integrity: bool = True, tag: str = "") -> None:
        """`tag` prefixes every unit id (a composite store names its
        part), so the seeded fault draws follow it."""
        self._fm = fm
        self._integrity = integrity
        self._fault_tag = tag
        # slabs augmented before the attach have no integrity words yet
        self._dirty.update(self.policies.keys())

    def _unit_id(self, row: int) -> str:
        return f"{self._fault_tag}slab{row}"

    def _packed_keys(self) -> list[str]:
        return sorted(self._state.get("packed", {}))

    def _payload(self, rows: torch.Tensor) -> list[torch.Tensor]:
        """The integrity payload of each slot in `rows`, one (len(rows),
        bytes) uint8 tensor a plane: each packed plane's bytes and then
        its scales', planes in sorted-key order."""
        st = self._state
        return [st[plane][key].index_select(1, rows).movedim(1, 0)
                .contiguous().view(torch.uint8).reshape(len(rows), -1)
                for key in self._packed_keys()
                for plane in ("packed", "scale")]

    def _slab_words(self, rows: list[int]) -> list[int]:
        """Integrity words of the slabs in `rows`, computed on the device:
        each slab's payload bytes times their running 1-based offsets,
        summed in int64 and cut to 32 bits, `core.faults.integrity_word`
        of the same bytes (the sum stays far below 2**63). Slabs are
        summed WORD_CHUNK_BYTES of payload at a time, so the int64
        temporaries stay bounded; one host copy for all rows."""
        if not rows:
            return []
        n = max(1, WORD_CHUNK_BYTES // self.slab_bytes_aug)
        words = []
        for sel in torch.tensor(rows, device=self.device).split(n):
            data = torch.cat(self._payload(sel), dim=1)
            if self._word_weights is None:
                self._word_weights = torch.arange(
                    1, data.shape[1] + 1, dtype=torch.int64,
                    device=self.device)
            words.append((data.to(torch.int64) * self._word_weights)
                         .sum(dim=1))
        return [int(w) for w in (torch.cat(words) & 0xFFFFFFFF).cpu()]

    def _flush_integrity(self) -> None:
        """Bring the integrity words up to date for every Augmented slab
        (re)written since the last flush; a static store also keeps a host
        master copy of each."""
        rows = [row for row in self.policies
                if row not in self._words or row in self._dirty]
        for row, word in zip(rows, self._slab_words(rows)):
            self._words[row] = word
            if self.static:
                # a copy (`.cpu()` of a CPU tensor would alias the plane)
                st = self._state
                self._masters[row] = (tuple(
                    st[plane][key][:, row].to("cpu", copy=True)
                    for key in self._packed_keys()
                    for plane in ("packed", "scale")), word)
        self._dirty.clear()

    def inject_faults(self, step: int) -> int:
        """Sample retention faults for every live Augmented slab and
        corrupt its packed planes on the device (deterministic under the
        model's seed). Returns the number of slabs corrupted."""
        if self._fm is None or not self.mixed:
            return 0
        self._flush_integrity()
        n = 0
        for row, pol in list(self.policies.items()):
            if row in self._pending:
                continue
            uid = self._unit_id(row)
            if self._fm.fault(uid, step, pol.age(step), self.retention_steps):
                _corrupt_row_op(self._state, row,
                                self._fm.corruption_mask(uid, step))
                self._pending.add(row)
                self.stats["faults_injected"] += 1
                if self._obs is not None:
                    self._obs.on_fault("inject", uid, step)
                n += 1
        return n

    def scan_integrity(self, step: int) -> list[int]:
        """Check every Augmented slab against its integrity word; return
        the corrupted rows (detected, never served). A row detected
        `pin_threshold` times is pinned to the Normal plane."""
        if self._fm is None or not self._integrity:
            return []
        self._flush_integrity()
        rows = list(self._words)
        bad: list[int] = []
        for row, now in zip(rows, self._slab_words(rows)):
            self.stats["integrity_checks"] += 1
            if now == self._words[row]:
                continue
            bad.append(row)
            self._pending.discard(row)
            self.stats["faults_detected"] += 1
            uid = self._unit_id(row)
            self._offenders[uid] = self._offenders.get(uid, 0) + 1
            if (self._offenders[uid] >= self._fm.pin_threshold
                    and not self._pin_normal[row]):
                self._pin_normal[row] = True
                self.stats["pinned_normal"] += 1
        return bad

    def scrub_from_master(self, row: int) -> bool:
        """Heal a detected-corrupt slab from its host master (static
        stores only; a decode slab has none and is recomputed). A pinned
        row goes back to the Normal plane when the budget allows."""
        master = self._masters.get(row)
        if master is None:
            return False
        planes, word = master
        keys = self._packed_keys()
        _restore_row_op(self._state, row,
                        dict(zip(keys, planes[0::2])),
                        dict(zip(keys, planes[1::2])))
        self.stats["maintenance_dispatches"] += 1
        self._words[row] = word
        self._dirty.discard(row)
        if self._pin_normal[row]:
            self.promote_slot(row, step=0)
        return True

    def fault_row(self, row: int) -> Optional[int]:
        return row

    def fault_unit_bytes(self, row: int) -> int:
        return self.slab_bytes_aug

    def fault_counters(self) -> dict:
        """The fault counters of `PagedKVPool` but its decommissioned
        pages: a slab store retires nothing."""
        return {k: self.stats[k] for k in FAULT_COUNTERS[:-1]}

    def faults_pending(self) -> int:
        return len(self._pending)

    # -- speculative decode: slab snapshot / rollback --------------------------

    def speculative_snapshot(self) -> None:
        """Hold the pre-draft planes. The drafts advance the recurrent
        state through steps that return new trees (no in-place write runs
        between snapshot and restore), so a reference holds: the verify
        replays the window from this exact tree, and rejected draft steps
        never reach committed storage."""
        self._spec_snapshot = self._state
        self.stats["spec_snapshots"] += 1

    def speculative_restore(self) -> None:
        """Roll the planes back to the pre-draft snapshot (always before
        the verify, which re-runs the accepted steps itself)."""
        assert self._spec_snapshot is not None, "no speculative snapshot"
        self._state = self._spec_snapshot
        self._spec_snapshot = None
        self.stats["spec_rollbacks"] += 1

    def retract_token_writes(self, rows: np.ndarray,
                             new_lengths: np.ndarray) -> int:
        """Slab rollback is wholesale (snapshot / restore): there is no
        per-token storage to retract."""
        return 0

    # -- device views -----------------------------------------------------------

    @property
    def state(self) -> dict:
        return self._state

    @state.setter
    def state(self, new: dict) -> None:
        self._state = new

    def device_tables(self) -> dict:
        if not self.mixed:
            return {}
        if self._tables_cache is None:
            self._tables_cache = {self.table_key: torch.from_numpy(
                self.slot_mode.copy()).to(self.device)}
        return self._tables_cache

    # -- array event accounting ---------------------------------------------------

    def _value_counts(self, rows: np.ndarray) -> tuple[int, int]:
        if rows.size == 0:
            return 0, 0
        modes = self.slot_mode[rows]
        alive = self.slot_alloc[rows]
        v = self.values_per_slot
        return (int((alive & (modes == 0)).sum()) * v,
                int((alive & (modes == 1)).sum()) * v)

    def read_value_counts(self, rows: np.ndarray,
                          lengths: np.ndarray) -> tuple[int, int]:
        """Every dispatch senses each row's whole slab once..."""
        return self._value_counts(rows)

    def write_value_counts(self, rows: np.ndarray, n_new: int,
                           write_starts: np.ndarray) -> tuple[int, int]:
        """...and (but a static store) writes it back once."""
        if self.static:
            return 0, 0
        return self._value_counts(rows)

    def physical_bytes(self) -> int:
        """Staged plane capacity (both planes when mode-mixing is on)."""
        phys = self.max_batch * self.slab_bytes_normal
        if self.mixed:
            phys += self.max_batch * self.slab_bytes_aug
        return phys

    def describe(self) -> dict:
        live_n = int((self.slot_alloc & (self.slot_mode == 0)).sum())
        live_a = int((self.slot_alloc & (self.slot_mode == 1)).sum())
        return {
            "kind": self.kind,
            "pool_mode": self.pool_mode,
            "static": self.static,
            "state_bits": self.state_bits,
            "slab_bytes_normal": self.slab_bytes_normal,
            "slab_bytes_aug": self.slab_bytes_aug,
            "slab_capacity_factor": (self.slab_bytes_normal
                                     / self.slab_bytes_aug),
            "slabs_live_normal": live_n,
            "slabs_live_augmented": live_a,
            "budget_bytes": self.budget_bytes,
            "live_bytes": self.live_bytes,
            "retention_steps": self.retention_steps,
            **self.stats,
        }


# ---------------------------------------------------------------------------
# CompositeStore — one row spans several stores (vlm: paged KV + prefix)
# ---------------------------------------------------------------------------

class CompositeStore:
    """The store interface fanned out over named parts; a row is admitted
    into ALL parts or none. `state` is {part name: part state}; refresh
    and fault keys are (part name, part key)."""

    kind = "composite"

    def __init__(self, parts: dict):
        self.parts = parts

    def can_admit_tokens(self, n: int) -> bool:
        return all(p.can_admit_tokens(n) for p in self.parts.values())

    def admit_row(self, row: int, n_tokens: int, step: int, *,
                  shared=None) -> bool:
        done = []
        for p in self.parts.values():
            if not p.admit_row(row, n_tokens, step):
                for d in done:
                    d.release_row(row)
                return False
            done.append(p)
        return True

    def ensure_position(self, row: int, pos: int, step: int) -> bool:
        return all(p.ensure_position(row, pos, step)
                   for p in self.parts.values())

    def max_row_tokens(self) -> Optional[int]:
        caps = [c for c in (p.max_row_tokens()
                            for p in self.parts.values()) if c is not None]
        return min(caps) if caps else None

    def release_row(self, row: int) -> None:
        for p in self.parts.values():
            p.release_row(row)

    def note_token_writes(self, rows, positions, step) -> None:
        for p in self.parts.values():
            p.note_token_writes(rows, positions, step)

    def refresh_due(self, step: int) -> list:
        return [(name, key) for name, p in self.parts.items()
                for key in p.refresh_due(step)]

    def refresh(self, key, step: int) -> None:
        name, part_key = key
        self.parts[name].refresh(part_key, step)

    def max_augmented_age(self, step: int) -> int:
        return max(p.max_augmented_age(step) for p in self.parts.values())

    def attach_obs(self, obs) -> None:
        for p in self.parts.values():
            p.attach_obs(obs)

    def mode_mix(self) -> tuple[int, int]:
        return self._sum_counts(lambda p: p.mode_mix())

    # -- retention faults: fanned out, part-qualified keys -------------------

    def attach_fault_model(self, fm: F.FaultModel, *,
                           integrity: bool = True, tag: str = "") -> None:
        for name, p in self.parts.items():
            p.attach_fault_model(fm, integrity=integrity,
                                 tag=f"{tag}{name}:")

    def inject_faults(self, step: int) -> int:
        return sum(p.inject_faults(step) for p in self.parts.values())

    def scan_integrity(self, step: int) -> list:
        return [(name, key) for name, p in self.parts.items()
                for key in p.scan_integrity(step)]

    def scrub_from_master(self, key) -> bool:
        name, part_key = key
        return self.parts[name].scrub_from_master(part_key)

    def fault_row(self, key) -> Optional[int]:
        name, part_key = key
        return self.parts[name].fault_row(part_key)

    def fault_unit_bytes(self, key) -> int:
        name, part_key = key
        return self.parts[name].fault_unit_bytes(part_key)

    def fault_counters(self) -> dict:
        out: dict = {}
        for p in self.parts.values():
            for k, v in p.fault_counters().items():
                out[k] = out.get(k, 0) + v
        return out

    def faults_pending(self) -> int:
        return sum(p.faults_pending() for p in self.parts.values())

    # -- device views and accounting -----------------------------------------

    @property
    def state(self) -> dict:
        return {name: p.state for name, p in self.parts.items()}

    @state.setter
    def state(self, new: dict) -> None:
        for name, p in self.parts.items():
            p.state = new[name]

    def device_tables(self) -> dict:
        out = {}
        for p in self.parts.values():
            out.update(p.device_tables())
        return out

    @property
    def live_bytes(self) -> int:
        return sum(p.live_bytes for p in self.parts.values())

    @property
    def budget_bytes(self) -> int:
        return sum(p.budget_bytes for p in self.parts.values())

    @property
    def aug_bits(self) -> int:
        return next(iter(self.parts.values())).aug_bits

    def _sum_counts(self, fn) -> tuple[int, int]:
        n = a = 0
        for p in self.parts.values():
            pn, pa = fn(p)
            n, a = n + pn, a + pa
        return n, a

    def read_value_counts(self, rows, lengths):
        return self._sum_counts(
            lambda p: p.read_value_counts(rows, lengths))

    def write_value_counts(self, rows, n_new, starts):
        return self._sum_counts(
            lambda p: p.write_value_counts(rows, n_new, starts))

    def physical_bytes(self) -> int:
        return sum(p.physical_bytes() for p in self.parts.values())

    def describe(self) -> dict:
        parts = {name: p.describe() for name, p in self.parts.items()}
        agg = {"kind": self.kind, "parts": parts,
               "budget_bytes": self.budget_bytes,
               "live_bytes": self.live_bytes}
        for k in ("refreshes", "refresh_bytes", "augment_events",
                  "promote_events", "maintenance_dispatches",
                  "alloc_failures", "peak_live_bytes", "augment_bytes",
                  *FAULT_COUNTERS):
            agg[k] = sum(d.get(k, 0) for d in parts.values())
        return agg


# ---------------------------------------------------------------------------
# store registry + per-family step functions
# ---------------------------------------------------------------------------

def make_store(cfg: ModelConfig, *, max_batch: int, max_seq: int,
               device: torch.device, budget_bytes: Optional[int] = None,
               retention_steps: Optional[int] = None):
    """The family's decode-state store: paged KV pages (dense, moe), with
    the cross KV as a static prefix band (audio), fixed-size augmented
    slabs (ssm, hybrid), or pages and a static patch-KV slab store in one
    composite (vlm)."""
    kw = dict(max_batch=max_batch, device=device,
              retention_steps=retention_steps)
    if cfg.family in ("dense", "moe", "audio"):
        return PagedKVPool(cfg, max_seq=max_seq, budget_bytes=budget_bytes,
                           prefix_tokens=(cfg.encdec.n_frames
                                          if cfg.family == "audio" else 0),
                           **kw)
    if cfg.family == "vlm":
        from repro_torch.models import vision
        pool = PagedKVPool(cfg, max_seq=max_seq,
                           n_layers=(vision._n_blocks(cfg)
                                     * vision.N_SELF_PER_BLOCK), **kw)
        prefix = AugmentedStatePool(
            cfg, vision.prefix_state_specs(cfg, max_batch), static=True,
            table_key="prefix_modes", **kw)
        if budget_bytes is not None:
            # ONE operator budget spans both parts, split in proportion
            # to their full-capacity defaults: stats() reports exactly
            # the total asked for, and it bounds prefix admission too
            total = pool.budget_bytes + prefix.budget_bytes
            pool.budget_bytes = budget_bytes * pool.budget_bytes // total
            prefix.budget_bytes = budget_bytes - pool.budget_bytes
        return CompositeStore({"kv": pool, "prefix": prefix})
    if cfg.family in ("ssm", "hybrid"):
        return AugmentedStatePool(cfg, M.abstract_cache(cfg, max_batch,
                                                        max_seq),
                                  budget_bytes=budget_bytes, **kw)
    raise ValueError(f"no decode-state store for family {cfg.family!r}")


def _select_rows(pick: torch.Tensor, new: dict, old: dict) -> dict:
    """`new` at the rows where the (B,) mask `pick` is set, `old`
    elsewhere, leaf by leaf (batch at axis 1)."""
    return _map(new, lambda key, leaf: torch.where(
        _row_view(pick, leaf), leaf, _leaf_at(old, key)))


def make_step_fns(cfg: ModelConfig) -> dict[str, Optional[Callable]]:
    """(decode, prefill, verify) callables over (params, state, batch);
    ``prefill`` is None where the family has none (the engine then
    prefills token by token), ``verify`` None where it has no verify
    step (the engine then decodes stepwise whatever spec_k says)."""
    if cfg.family in ("dense", "moe"):
        return {
            "decode": lambda p, s, b: M.paged_decode_step(cfg, p, s, b),
            "prefill": lambda p, s, b: M.paged_prefill_step(cfg, p, s, b),
            "verify": lambda p, s, b: M.paged_verify_step(cfg, p, s, b),
        }
    bits = cfg.amc.state_bits
    if cfg.family == "audio":
        return {"decode": lambda p, s, b: M.paged_decode_step(cfg, p, s, b),
                "prefill": None, "verify": None}
    if cfg.family == "vlm":
        def vlm_decode(params, state, batch):
            """Reconstitute the static patch slab (the prefix store is
            never written back), then the paged step over the KV part."""
            prefix = slab_reconstitute(state["prefix"],
                                       batch.get("prefix_modes"), bits)
            logits, kv = M.paged_decode_step(cfg, params, state["kv"],
                                             {**batch, **prefix})
            return logits, {"kv": kv, "prefix": state["prefix"]}
        return {"decode": vlm_decode, "prefill": None, "verify": None}
    if cfg.family not in ("ssm", "hybrid"):
        raise ValueError(f"no step functions for family {cfg.family!r}")

    def slab_decode(params, state, batch):
        """Reconstitute the slabs, run the family step, store back the
        written rows."""
        modes = batch.get("slot_modes")
        cache = slab_reconstitute(state, modes, bits)
        logits, new_cache = M.decode_step(cfg, params, cache, batch)
        return logits, slab_store_back(state, new_cache, modes, bits,
                                       write=batch.get("write_mask"))

    def slab_verify(params, state, batch):
        """Speculative verify over slabs: replay the W-token window from
        the pre-draft state (the engine restored it) as W calls of the
        SAME single-token step, so each step has the shapes and bits of
        one stepwise dispatch, then commit each row's state after its
        accepted prefix. The greedy acceptance is the paged verify's,
        capped by the row's window mask; the committed step is picked
        row by row on the device as the steps run (no host sync, two
        trees live), and rejected steps are never stored back."""
        tokens = batch["tokens"]                        # (B, W)
        starts = batch["positions"]                     # (B,)
        wmask = batch["write_mask"]                     # (B, W) bool
        modes = batch.get("slot_modes")
        W = tokens.shape[1]
        cap = wmask.sum(dim=1).clamp_min(1)
        cache = slab_reconstitute(state, modes, bits)
        lgs, committed = [], None
        live = torch.ones_like(wmask[:, 0])   # accepted through step w
        for w in range(W):
            lg, cache = M.decode_step(cfg, params, cache, {
                "tokens": tokens[:, w:w + 1], "positions": starts + w})
            lgs.append(lg[:, -1])
            if w == 0:
                committed = cache
                continue
            # step w is kept while every draft so far matched the
            # verifier's previous argmax and w is inside the row's cap
            match = tokens[:, w] == lgs[w - 1].argmax(dim=-1).to(
                tokens.dtype)
            live = live & match & (w < cap)
            committed = _select_rows(live, cache, committed)
        return torch.stack(lgs, dim=1), slab_store_back(
            state, committed, modes, bits, write=wmask[:, 0])

    return {"decode": slab_decode, "prefill": None, "verify": slab_verify}
