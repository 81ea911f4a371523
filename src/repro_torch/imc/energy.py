"""Array-level event/energy accounting for augmented storage and IMC.

Every storage access and every in-array dot product is decomposed into
EVENT CLASSES with a nominal per-event energy (fJ). The absolute numbers
are placeholders for the paper's measured Tables III/IV values; what the
model keeps is their relative structure:

  * Normal-mode (6T) reads/writes are the cheapest per cell;
  * Augmented-mode accesses cost MORE per cell, but each cell carries
    more than one logical bit, so per VALUE the augmented modes win;
  * IMC dot products replace per-value fetches with wordline pulses,
    bitline discharges and ADC conversions whose count scales with the
    bit-serial cycle count `mag_bits(abits)`.

Counting conventions (per VALUE, by storage format):

  dense bf16      16 cells (6T, one bit each)
  ternary 2-bit   1 cell   (7T, one trit each)
  dual int4 pair  4 cells  (8T, static bit + dynamic bit each; a dual
                            read returns BOTH planes -> `read_8t_dual`)
  packed KV int4  4 cells  (8T dynamic bits)      int8: 8 cells

`ImcEventLedger` is the host-side accumulator `ServeEngine` folds into
`stats()["imc"]`. The per-dispatch counts are a function of shapes,
modes and the host's page tables: pure host arithmetic, nothing read
back from the device. Ported from `repro.imc.energy` number for number;
the per-model counts cover the families the port serves (dense, moe,
ssm, hybrid).
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Optional

from repro_torch.core.amc import dynamic_plane_access_events
from repro_torch.kernels.imc_dot import mag_bits

# Nominal per-event energies (fJ). Relative structure per Tables III/IV:
# augmented accesses > normal per CELL, < normal per VALUE.
EVENT_ENERGY_FJ = {
    # von-Neumann storage-array events (Table III reads / Table IV writes)
    "read_6t": 2.0,
    "write_6t": 2.2,
    "read_8t_static": 2.6,    # static bit sensed through the dynamic node
    "read_8t_dynamic": 3.4,   # boosted-WL dynamic bit read
    "read_8t_dual": 4.2,      # one access, both planes (the dual read)
    "write_8t_dual": 4.8,     # static + dynamic write pair
    "write_8t_dynamic": 2.9,  # dynamic-plane-only write (KV stream)
    "read_7t": 2.9,
    "write_7t": 3.5,
    # IMC array events (arXiv:1802.08601 / 2008.03378)
    "wordline": 1.2,          # one WL pulse (one activation bit, one row)
    "bitline": 0.45,          # one BL partial discharge (one column)
    "adc": 6.0,               # one sense/ADC conversion (one column)
    # maintenance
    "refresh_cell": 1.8,      # DRAM-style restore of one augmented cell
}

# Cells read per logical VALUE for a von-Neumann weight fetch, by storage.
_WEIGHT_FETCH = {
    "dense": ("read_6t", 16),
    "ternary": ("read_7t", 1),
    "dual": ("read_8t_dual", 4),   # one event per cell returns BOTH planes
    "int8": ("read_8t_dynamic", 8),
    "int4": ("read_8t_dynamic", 4),
}


def energy_fj(events: dict) -> float:
    return float(sum(EVENT_ENERGY_FJ[cls] * n for cls, n in events.items()))


def imc_dot_events(M: int, K: int, N: int, *, abits: int,
                   planes: int = 1) -> dict:
    """Events of one (M, K) x (K, N) bit-serial in-array dot product.

    Per bit-serial cycle: every K wordline pulses once per output row,
    every N bitline discharges and converts once per resident plane.
    `planes=2` is the dual-plane engine — ONE wordline stream, TWO
    bitline/ADC banks."""
    c = mag_bits(abits)
    return {"wordline": M * K * c,
            "bitline": M * N * c * planes,
            "adc": M * N * c * planes}


def weight_fetch_events(n_values: int, storage: str) -> dict:
    """Von-Neumann events for fetching `n_values` weights to the MXU."""
    cls, per = _WEIGHT_FETCH[storage]
    return {cls: n_values * per}


def matmul_events(M: int, K: int, N: int, *, storage: str, impl: str,
                  abits: int = 8) -> dict:
    """Events of one (M, K) x (K, N) matmul under a storage x impl cell.

    impl="imc" computes in-array when the storage is resident-packed
    (ternary/dual/int4/int8); dense storage has no array to compute in,
    so it takes the fetch model whatever the impl."""
    if M == 0:
        return {}
    if impl == "imc" and storage != "dense":
        return imc_dot_events(M, K, N, abits=abits,
                              planes=2 if storage == "dual" else 1)
    # von-Neumann: the weight matrix is fetched ONCE per batched dispatch
    # (not per token); dual fetches count value PAIRS (4 cells = 2 values)
    n = K * N
    if storage == "dual":
        n = n // 2
    return weight_fetch_events(n, storage)


def kv_read_events(n_values_normal: int, n_values_aug: int, *,
                   aug_bits: int) -> dict:
    """Decode-state reads: Normal pages are 6T static data (16 cells a
    value), Augmented pages dynamic-plane data (`aug_bits` 8T cells a
    value)."""
    ev: dict = {}
    if n_values_normal:
        ev["read_6t"] = 16 * n_values_normal
    ev.update(dynamic_plane_access_events(n_values_aug, aug_bits, "read"))
    return ev


def kv_write_events(n_values_normal: int, n_values_aug: int, *,
                    aug_bits: int) -> dict:
    ev: dict = {}
    if n_values_normal:
        ev["write_6t"] = 16 * n_values_normal
    ev.update(dynamic_plane_access_events(n_values_aug, aug_bits, "write"))
    return ev


def refresh_events(n_bytes: int) -> dict:
    """Refresh traffic (pool `refresh_bytes`) -> cell restore events:
    augmented bytes hold 2 bits a cell -> 4 cells a byte."""
    return {"refresh_cell": 4 * n_bytes}


# ---------------------------------------------------------------------------
# Per-model analytic step counts (what ServeEngine folds into stats())
# ---------------------------------------------------------------------------

def _layer_matmuls(cfg) -> list:
    """(K, N, storage) of every per-token matmul in one transformer
    decoder layer, given cfg.amc.weight_mode (mirrors `augment_params`'
    packing map): a MoE layer's router and its top-k active experts,
    whose banks are ternary in ternary mode and dense otherwise."""
    d, H, KV, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                       cfg.d_ff)
    wm = cfg.amc.weight_mode
    tern = "ternary" if wm == "ternary" else "dense"
    mm = [(d, H * hd, tern)]                               # wq
    if wm == "dual":
        mm += [(d, KV * hd, "dual")]                       # wk+wv, one pass
    else:
        mm += [(d, KV * hd, tern), (d, KV * hd, tern)]
    mm += [(H * hd, d, tern)]                              # wo
    n_ffn = 3 if cfg.act == "swiglu" else 2
    if cfg.moe is not None:
        mm += [(d, cfg.moe.n_experts, "dense")]            # router
        for _ in range(cfg.moe.top_k):
            mm += [(d, f, tern)] * (n_ffn - 1) + [(f, d, tern)]
    elif wm == "dual" and cfg.act == "swiglu":
        mm += [(d, f, "dual"), (f, d, "dense")]            # gate+up fused
    else:
        mm += [(d, f, tern)] * (n_ffn - 1) + [(f, d, tern)]
    return mm


def _mlp_matmuls(cfg) -> list:
    n_ffn = 3 if cfg.act == "swiglu" else 2
    return ([(cfg.d_model, cfg.d_ff, "dense")] * (n_ffn - 1)
            + [(cfg.d_ff, cfg.d_model, "dense")])


def _attn_matmuls(cfg) -> list:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return [(d, H * hd, "dense"), (d, KV * hd, "dense"),
            (d, KV * hd, "dense"), (H * hd, d, "dense")]


def model_decode_matmuls(cfg) -> list:
    """(K, N, storage, count) of every per-token weight matmul in one
    decode step. The ssm, hybrid, audio and vlm families keep dense
    weights (their params are not packed), so their matmuls are all
    "dense" (6T) storage."""
    if cfg.family in ("dense", "moe"):
        return [(K, N, s, cfg.n_layers) for K, N, s in _layer_matmuls(cfg)]
    if cfg.family == "ssm":
        d, s = cfg.d_model, cfg.ssm
        din = s.expand * d
        H = din // s.head_dim
        GN = s.n_groups * s.state_dim
        per = [(d, din, "dense"), (d, din, "dense"),        # z, x
               (d, GN, "dense"), (d, GN, "dense"),          # b, c
               (d, H, "dense"), (din, d, "dense")]          # dt, out
        return [(K, N, st, cfg.n_layers) for K, N, st in per]
    if cfg.family == "hybrid":
        d, h = cfg.d_model, cfg.hybrid
        n_att = cfg.n_layers // len(h.pattern)
        n_rec = cfg.n_layers - n_att
        rec = [(d, h.lru_width, "dense"), (d, h.lru_width, "dense"),
               (h.lru_width, d, "dense")] + _mlp_matmuls(cfg)
        att = _attn_matmuls(cfg) + _mlp_matmuls(cfg)
        return ([(K, N, st, n_rec) for K, N, st in rec]
                + [(K, N, st, n_att) for K, N, st in att])
    if cfg.family == "audio":
        # self attention, the cross q / o (the cross K / V are the static
        # plane, computed once per utterance) and the MLP, every layer
        d, H, hd = cfg.d_model, cfg.n_heads, cfg.hd
        per = (_attn_matmuls(cfg)
               + [(d, H * hd, "dense"), (H * hd, d, "dense")]
               + _mlp_matmuls(cfg))
        return [(K, N, st, cfg.n_layers) for K, N, st in per]
    if cfg.family == "vlm":
        from repro_torch.models.vision import N_SELF_PER_BLOCK, _n_blocks
        nb = _n_blocks(cfg)
        d, H, hd = cfg.d_model, cfg.n_heads, cfg.hd
        self_l = _attn_matmuls(cfg) + _mlp_matmuls(cfg)
        cross = ([(d, H * hd, "dense"), (H * hd, d, "dense")]
                 + _mlp_matmuls(cfg))
        return ([(K, N, st, nb * N_SELF_PER_BLOCK) for K, N, st in self_l]
                + [(K, N, st, nb) for K, N, st in cross])
    raise ValueError(f"no decode matmul model for family {cfg.family!r}")


def decode_matmul_events(cfg, n_tokens: int) -> dict:
    """Weight-side events of one decode dispatch over `n_tokens` useful
    tokens (padding rows are not counted — this is the per-token model)."""
    a = cfg.amc
    ev: Counter = Counter()
    for K, N, storage, count in model_decode_matmuls(cfg):
        for cls, n in matmul_events(n_tokens, K, N, storage=storage,
                                    impl=a.matmul_impl,
                                    abits=a.imc_abits).items():
            ev[cls] += n * count
    return dict(ev)


# ---------------------------------------------------------------------------
# Ledger
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ImcEventLedger:
    """Host-side event accumulator, grouped by traffic source ("weights",
    "draft", "kv_read", "kv_write", "refresh", "imc_dot"). Energies use
    EVENT_ENERGY_FJ."""
    counts: dict = dataclasses.field(default_factory=Counter)
    tokens: int = 0

    def add(self, events: dict, group: str) -> None:
        for cls, n in events.items():
            if n:
                self.counts[(group, cls)] += int(n)

    def note_tokens(self, n: int) -> None:
        self.tokens += int(n)

    def energy_fj(self, group: Optional[str] = None) -> float:
        return float(sum(EVENT_ENERGY_FJ[cls] * n
                         for (g, cls), n in self.counts.items()
                         if group is None or g == group))

    def describe(self) -> dict:
        groups: dict = {}
        for (g, cls), n in sorted(self.counts.items()):
            gd = groups.setdefault(g, {"events": {}, "energy_fj": 0.0})
            gd["events"][cls] = n
            gd["energy_fj"] += EVENT_ENERGY_FJ[cls] * n
        total = self.energy_fj()
        return {
            "event_energy_fj": dict(EVENT_ENERGY_FJ),
            "groups": groups,
            "energy_fj_total": total,
            "tokens": self.tokens,
            "energy_pj_per_token": (total / self.tokens / 1e3
                                    if self.tokens else 0.0),
        }
