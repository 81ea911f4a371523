"""Decode-state stores behind one interface, and the per-family step
functions over them.

Ports `repro.serve.state_store` for the families the port serves: dense
rows on a `PagedKVPool` (serve/cache_pool.py), hybrid rows on an
`AugmentedStatePool` of FIXED-SIZE per-row slabs (the LRU state, conv
tails and ring-window KV of a row). A slab lives in one of two modes
against one byte budget:

  Normal     native dtype (bf16 / f32) rows in the ``normal`` plane
  Augmented  int8 or nibble-packed int4 rows + per-vector bf16 scales
             (``packed`` + ``scale`` planes)

Under pressure the pool augments cold slabs in place so that more rows
can be admitted. An Augmented slab is dynamic storage: every decode step
reads it through the sense amplifier (dequantize), updates it, and writes
it back through the write driver (quantize), which restamps its
`RefreshPolicy`. Integer leaves (the already-packed ring KV) and their
trailing-dim-1 scale leaves pass through the normal plane unchanged.

The planes key their leaves by the JAX package's key strings
("['blocks']['conv_a']"), so a plane of either package is addressed by
the same name. Left out here: the fault machinery (injection, integrity
words, scrubbing), which the port's config does not carry yet, and the
speculative snapshot / rollback of slab state (the engine raises for
spec_k > 1 on this store).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import quant
from repro_torch.core.retention import RefreshPolicy
from repro_torch.models import model as M
from repro_torch.models.params import PSpec
from repro_torch.serve.cache_pool import PagedKVPool, resolve_pool_mode


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


# ---------------------------------------------------------------------------
# AugmentedStatePool — fixed-size per-row decode-state slabs
# ---------------------------------------------------------------------------

class AugmentedStatePool:
    """See the module docstring. `specs` is the family's decode-state tree
    (`PSpec` leaves, batch at axis 1)."""

    kind = "slab"

    def __init__(self, cfg: ModelConfig, specs: dict, *, max_batch: int,
                 device: torch.device, budget_bytes: Optional[int] = None,
                 retention_steps: Optional[int] = None):
        self.cfg = cfg
        self.device = device
        self.max_batch = max_batch
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
        self._live_by_mode = [0, 0]
        self.stats = {
            "augment_events": 0, "promote_events": 0, "refreshes": 0,
            "refresh_bytes": 0, "augment_bytes": 0,
            "maintenance_dispatches": 0, "alloc_failures": 0,
            "peak_live_bytes": 0,
        }

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
        cand = self.slot_alloc & (self.slot_mode == 0)
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
        self.stats["augment_events"] += 1
        self.stats["augment_bytes"] += self._cost(0) + self._cost(1)
        self._tables_cache = None

    def promote_slot(self, row: int, step: int) -> bool:
        """Augmented -> Normal (refresh-promote) when the budget has room."""
        assert self.slot_alloc[row] and self.slot_mode[row] == 1
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
        self.stats["promote_events"] += 1
        self._tables_cache = None
        return True

    # -- retention / refresh --------------------------------------------------

    def note_token_writes(self, rows: np.ndarray, positions: np.ndarray,
                          step: int) -> None:
        """Decode rewrote these rows' slabs through the write driver:
        restamp coldness and (Augmented rows) the retention clock."""
        for row in np.asarray(rows).ravel():
            row = int(row)
            if not self.slot_alloc[row]:
                continue
            self.last_write[row] = step
            pol = self.policies.get(row)
            if pol is not None:
                pol.stamp(step)

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
            self._tables_cache = {"slot_modes": torch.from_numpy(
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
        """...and writes it back once."""
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
# store registry + per-family step functions
# ---------------------------------------------------------------------------

def make_store(cfg: ModelConfig, *, max_batch: int, max_seq: int,
               device: torch.device, budget_bytes: Optional[int] = None,
               retention_steps: Optional[int] = None):
    """The family's decode-state store: paged KV pages (dense) or
    fixed-size augmented slabs (hybrid)."""
    if cfg.family == "dense":
        return PagedKVPool(cfg, max_batch=max_batch, max_seq=max_seq,
                           device=device, budget_bytes=budget_bytes,
                           retention_steps=retention_steps)
    if cfg.family == "hybrid":
        return AugmentedStatePool(cfg, M.abstract_cache(cfg, max_batch,
                                                        max_seq),
                                  max_batch=max_batch, device=device,
                                  budget_bytes=budget_bytes,
                                  retention_steps=retention_steps)
    raise NotImplementedError(f"no decode-state store for family "
                              f"{cfg.family!r} in repro_torch yet")


def make_step_fns(cfg: ModelConfig) -> dict[str, Optional[Callable]]:
    """(decode, prefill, verify) callables over (params, state, batch);
    ``prefill`` and ``verify`` are None where the family has none (the
    engine then prefills token by token)."""
    if cfg.family == "dense":
        return {
            "decode": lambda p, s, b: M.paged_decode_step(cfg, p, s, b),
            "prefill": lambda p, s, b: M.paged_prefill_step(cfg, p, s, b),
            "verify": lambda p, s, b: M.paged_verify_step(cfg, p, s, b),
        }
    if cfg.family != "hybrid":
        raise NotImplementedError(f"no step functions for family "
                                  f"{cfg.family!r} in repro_torch yet")
    bits = cfg.amc.state_bits

    def slab_decode(params, state, batch):
        """Reconstitute the slabs, run the family step, store back the
        written rows."""
        modes = batch.get("slot_modes")
        cache = slab_reconstitute(state, modes, bits)
        logits, new_cache = M.decode_step(cfg, params, cache, batch)
        return logits, slab_store_back(state, new_cache, modes, bits,
                                       write=batch.get("write_mask"))
    return {"decode": slab_decode, "prefill": None, "verify": None}
