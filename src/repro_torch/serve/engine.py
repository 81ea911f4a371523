"""Serving engine: continuous batching over the family's decode-state
store.

`ServeEngine` drives a `Scheduler` (FIFO admission, slot-free join and
leave, preemption with greedy recompute, refresh pass) over a store:

  dense,  `PagedKVPool` — Normal/Augmented KV pages; a P-token prompt
  moe     costs ceil((P - 1) / prefill_chunk) prefill dispatches (the
          last prompt token is fed by the first decode step)
  audio   `PagedKVPool` with a static prefix band: the decoder self KV
          pages plus the cross KV as fixed-length pages, read at
          n_frames tokens every step
  vlm     `CompositeStore`: a `PagedKVPool` (self KV) and a static
          `AugmentedStatePool` (the patch KV), admitted together
  ssm,    `AugmentedStatePool` — fixed-size recurrent-state slabs
  hybrid
The families other than dense and moe have no chunked prefill, so every
prompt token but the last is one decode dispatch.

One batched decode dispatch serves every running row. Requests are
never dropped: `add_request` queues what does not fit, `generate` drains
the queue. An empty prompt needs an explicit `bos_id`. With
`spec_k` > 1, on a family with a verify step (not audio, not vlm), each
decode round is self-speculative: spec_k - 1 cheap
draft dispatches propose a window, one full-path verify dispatch scores
and commits it, and the longest greedily matching prefix is emitted (a
slab store snapshots its planes before the drafts and restores them
before the verify, which replays the window step by step).
Every dispatch is folded into the array event/energy ledger
(`imc.energy`, reported as `stats()["imc"]`) from host-side shapes and
page tables only.

With `prefix_cache` > 0 (paged pool) a `PrefixIndex` caches prompt
prefixes page by page: a hit maps the cached pages into the new row and
prefills only the tail. With `fault_rate` or `array_loss_rate` > 0 a
seeded `FaultModel` corrupts Augmented pages or slabs, each step's fault
pass (ahead of refresh and dispatch) detects them by their integrity
words, and recovery scrubs units that have a host master (share-band
pages) or recomputes the owning request (requeued with backoff, failed
past `max_retries`, never served corrupt; a slab row's recompute is a
stepwise re-prefill); an array loss drains and requeues every running
row. Recovery traffic is billed to the ledger's "recovery" group.

With `trace` or `metrics` on, one observability facade (`obs.hooks`)
takes the lifecycle hooks of the engine, the scheduler and the store:
Chrome-trace spans and instants (`export_trace`), latency histograms
and sampled series (`export_metrics`, `stats()["obs"]`). Its clock is
the host's; no hook reads the device. Off, the facade is a null object
whose hooks do nothing.

An `ArrayFleet` (serve/fleet.py) runs one engine per logical array and
moves requests between them through `adopt_request` and
`drain_requests`. Ported from `repro.serve.engine`.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import amc
from repro_torch.core import faults as faults_mod
from repro_torch.device import resolve_device
from repro_torch.distributed.fault import (SimulatedFailure,
                                           StragglerMonitor, Supervisor)
from repro_torch.imc import energy as imc_energy
from repro_torch.models import augment
from repro_torch.models import model as M
from repro_torch.models.params import (abstract_params, init_params,
                                       tree_nbytes)
from repro_torch.obs import hooks as obs_hooks
from repro_torch.serve import state_store
from repro_torch.serve.prefix import PrefixIndex
from repro_torch.serve.scheduler import QueueEntry, Scheduler


@dataclasses.dataclass(eq=False)
class Request:
    prompt: np.ndarray            # (plen,) int32
    max_new_tokens: int = 16
    id: int = 0


def _to_device(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def _resolve_draft_cfg(cfg: ModelConfig) -> ModelConfig:
    """Config the speculative draft pass decodes with: the cheap read of
    the same stored bits. "dequant" reads the pool through the gather +
    dense attention path, "dense" also takes the plain matmuls, "packed"
    forces the packed matmul kernels, "imcN" drafts through the bit-serial
    IMC dot at N-bit activations (the pool read is the full config's),
    "same" drafts at full quality (every draft accepted: a latency-hiding
    baseline)."""
    impl = cfg.amc.spec_draft_impl
    a = cfg.amc
    if impl == "same":
        return cfg
    if impl == "dequant":
        amc_cfg = dataclasses.replace(a, kv_impl="dequant")
    elif impl == "dense":
        amc_cfg = dataclasses.replace(a, matmul_impl="dense",
                                      kv_impl="dequant")
    elif impl == "packed":
        amc_cfg = dataclasses.replace(a, matmul_impl="packed")
    elif impl.startswith("imc") and impl[3:] in ("1", "4", "8"):
        amc_cfg = dataclasses.replace(a, matmul_impl="imc",
                                      imc_abits=int(impl[3:]))
    else:
        raise ValueError(
            f"unknown spec_draft_impl {impl!r} (expected dequant | dense "
            f"| packed | imc1/imc4/imc8 | same)")
    return dataclasses.replace(cfg, amc=amc_cfg)


class ServeEngine:
    def __init__(self, cfg: ModelConfig, *, device=None, max_batch: int = 8,
                 max_seq: int = 256, prefill_chunk: int = 32, params=None,
                 weight_mode: Optional[str] = None,
                 kv_mode: Optional[str] = None,
                 pool_mode: Optional[str] = None,
                 pool_budget_bytes: Optional[int] = None,
                 retention_steps: Optional[int] = None, seed: int = 0,
                 bos_id: Optional[int] = None,
                 matmul_impl: Optional[str] = None,
                 imc_abits: Optional[int] = None,
                 spec_k: Optional[int] = None,
                 spec_draft_impl: Optional[str] = None,
                 prefix_cache: Optional[int] = None,
                 fault_rate: Optional[float] = None,
                 fault_seed: Optional[int] = None,
                 array_loss_rate: Optional[float] = None,
                 fault_temp_c: Optional[float] = None,
                 integrity_check: Optional[bool] = None,
                 max_retries: Optional[int] = None,
                 fault_pin_threshold: Optional[int] = None,
                 trace: Optional[bool] = None,
                 metrics: Optional[bool] = None,
                 obs_sample_every: Optional[int] = None,
                 obs=None):
        self.device = resolve_device(device)
        # engine-level AMC knobs override the config; the numeric and bool
        # ones by an explicit None check (0, 0.0 and False are values)
        a = cfg.amc

        def pick(value, default):
            return default if value is None else value

        cfg = dataclasses.replace(cfg, amc=dataclasses.replace(
            a,
            weight_mode=weight_mode or a.weight_mode,
            kv_mode=kv_mode or a.kv_mode,
            pool_mode=pool_mode or a.pool_mode,
            matmul_impl=matmul_impl or a.matmul_impl,
            imc_abits=imc_abits or a.imc_abits,
            spec_k=pick(spec_k, a.spec_k),
            spec_draft_impl=spec_draft_impl or a.spec_draft_impl,
            prefix_cache=pick(prefix_cache, a.prefix_cache),
            fault_rate=pick(fault_rate, a.fault_rate),
            fault_seed=pick(fault_seed, a.fault_seed),
            array_loss_rate=pick(array_loss_rate, a.array_loss_rate),
            fault_temp_c=pick(fault_temp_c, a.fault_temp_c),
            integrity_check=pick(integrity_check, a.integrity_check),
            max_retries=pick(max_retries, a.max_retries),
            fault_pin_threshold=pick(fault_pin_threshold,
                                     a.fault_pin_threshold),
            trace=pick(trace, a.trace),
            metrics=pick(metrics, a.metrics),
            obs_sample_every=pick(obs_sample_every, a.obs_sample_every)))
        self.cfg = cfg
        self.max_batch, self.max_seq = max_batch, max_seq
        self.prefill_chunk = min(prefill_chunk, max_seq)
        self.bos_id = bos_id
        dense_cfg = dataclasses.replace(
            cfg, amc=dataclasses.replace(cfg.amc, weight_mode="normal"))
        if params is None:
            params = init_params(dense_cfg, seed=seed, device=self.device)
        # pack the matmul weights into augmented storage (no-op for
        # weight_mode="normal" and for already-packed trees)
        self.params = augment.augment_params(
            cfg, _to_device(params, self.device))
        self.store = state_store.make_store(
            cfg, max_batch=max_batch, max_seq=max_seq, device=self.device,
            budget_bytes=pool_budget_bytes, retention_steps=retention_steps)
        # observability facade: the null one unless a plane is switched
        # on; a pre-built facade may be passed in (`obs=`, e.g. with an
        # injected clock)
        self.obs = obs if obs is not None else obs_hooks.make_engine_obs(
            cfg.amc)
        if self.obs.enabled:
            self.store.attach_obs(self.obs)
        self.scheduler = Scheduler(self.store, max_batch=max_batch,
                                   obs=self.obs)
        # shared-prefix page reuse: a token-hash index over cached prefix
        # page runs in the pool's share band (paged pools only)
        self._prefix_index: Optional[PrefixIndex] = None
        if self.store.kind == "paged" and self.store.share_entries > 0:
            self._prefix_index = PrefixIndex(self.store.share_entries,
                                             cfg.amc.page_size)
            self.store.attach_prefix_index(self._prefix_index)
        self._prefix_saved = 0            # prefill dispatches hits skipped
        # retention faults and self-healing: inert (no model attached) at
        # fault_rate == array_loss_rate == 0
        a = cfg.amc
        self._fault_model: Optional[faults_mod.FaultModel] = None
        if a.fault_rate > 0.0 or a.array_loss_rate > 0.0:
            self._fault_model = faults_mod.FaultModel(
                rate=a.fault_rate, seed=a.fault_seed, temp_c=a.fault_temp_c,
                array_loss_rate=a.array_loss_rate,
                pin_threshold=a.fault_pin_threshold)
            self.store.attach_fault_model(self._fault_model,
                                          integrity=a.integrity_check)
        # an array loss drains and requeues every running row through the
        # supervisor; slow steps feed the straggler monitor (mitigations
        # are counted, not acted on)
        self.supervisor = Supervisor(self._recover_array_loss,
                                     max_restarts=64)
        self.straggler = StragglerMonitor()
        self._forced_array_loss = False
        self.failed: dict[int, list[int]] = {}
        self._fault_stats = {
            "recovered_scrub": 0, "recovered_recompute": 0, "retried": 0,
            "uncorrectable": 0, "array_losses": 0, "array_loss_requeues": 0,
            "straggler_mitigations": 0,
        }
        fns = state_store.make_step_fns(cfg)
        self._decode, self._prefill = fns["decode"], fns["prefill"]
        # self-speculative decoding: draft spec_k - 1 tokens per round out
        # of the cheap representation, verify the whole window through the
        # full path in ONE dispatch, accept the longest matching prefix
        self.spec_k = cfg.amc.spec_k
        self._verify = fns["verify"]
        # a family without a verify step decodes stepwise at any spec_k
        self._spec = self.spec_k > 1 and self._verify is not None
        self._spec_stats = {"spec_rounds": 0, "draft_dispatches": 0,
                            "verify_dispatches": 0, "accepted_tokens": 0}
        if self._spec:
            self._draft_cfg = _resolve_draft_cfg(cfg)
            self._draft_decode = state_store.make_step_fns(
                self._draft_cfg)["decode"]
        self._logical_weight_bytes = tree_nbytes(abstract_params(dense_cfg))
        # the decode state of every row at max_seq in bf16 (kv_mode normal)
        self._logical_cache_bytes = tree_nbytes(M.abstract_cache(
            dataclasses.replace(cfg, amc=dataclasses.replace(
                cfg.amc, kv_mode="normal")), max_batch, max_seq))
        # slot bookkeeping (host side)
        self.positions = np.zeros(max_batch, np.int32)
        self.remaining = np.zeros(max_batch, np.int32)
        self.active = np.zeros(max_batch, bool)
        self.last_token = np.zeros(max_batch, np.int32)
        self.slot_req: list[Optional[Request]] = [None] * max_batch
        self._slot_entry: list[Optional[QueueEntry]] = [None] * max_batch
        self.outputs: dict[int, list[int]] = {}
        self.dispatch_count = 0          # prefill + decode dispatches
        self.prefill_dispatch_count = 0
        self.step_idx = 0                # decode-step clock (retention)
        # array-level event/energy ledger: weight-side events follow
        # cfg.amc.matmul_impl, KV events the mode of the page each value
        # is read from or written to; host-side, per real dispatch
        self.energy_ledger = imc_energy.ImcEventLedger()
        self._refresh_bytes_seen = 0

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # -- array event accounting ------------------------------------------------

    def _store_parts(self) -> list:
        """The store's billable units (a composite store bills each part
        at its own augmented width)."""
        if self.store.kind == "composite":
            return list(self.store.parts.values())
        return [self.store]

    def _sync_refresh_events(self) -> None:
        """Fold store refresh traffic accrued since the last sync into the
        ledger's "refresh" group, so energy totals include maintenance."""
        rb = sum(p.stats["refresh_bytes"] for p in self._store_parts())
        if rb > self._refresh_bytes_seen:
            self.energy_ledger.add(
                imc_energy.refresh_events(rb - self._refresh_bytes_seen),
                "refresh")
            self._refresh_bytes_seen = rb

    def _account_dispatch(self, rows: np.ndarray, n_new: int,
                          read_lengths: np.ndarray,
                          write_starts: np.ndarray) -> None:
        """Fold one dispatch into the ledger: weight-side matmul events for
        `n_new` useful tokens a row, KV reads over `read_lengths` and the
        write of the `n_new` tokens, each costed by the mode of the page
        or slab it lands in, and each store part at its own augmented
        width (a vlm engine's int4 KV pages and its prefix slabs)."""
        if rows.size == 0:
            return
        self.energy_ledger.add(imc_energy.decode_matmul_events(
            self.cfg, int(rows.size) * n_new), "weights")
        for part in self._store_parts():
            nn, na = part.read_value_counts(rows, read_lengths)
            self.energy_ledger.add(imc_energy.kv_read_events(
                nn, na, aug_bits=part.aug_bits), "kv_read")
            wn, wa = part.write_value_counts(rows, n_new, write_starts)
            self.energy_ledger.add(imc_energy.kv_write_events(
                wn, wa, aug_bits=part.aug_bits), "kv_write")

    # -- continuous batching ---------------------------------------------------

    def add_request(self, req: Request) -> Optional[int]:
        """Enqueue a request and admit as many queued requests as fit.
        Returns the row if THIS request was admitted at once, else None
        (queued, never dropped)."""
        if req.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {req.max_new_tokens}")
        if req.id in self.outputs or any(
                e.req.id == req.id for e in self.scheduler.queue):
            raise ValueError(
                f"request id {req.id} is already queued, running or "
                f"completed on this engine")
        prompt = np.asarray(req.prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            if self.bos_id is None:
                raise ValueError(
                    "empty prompt with no bos_id: pass bos_id=<token> to "
                    "ServeEngine to define what an empty prompt decodes "
                    "from (there is no implicit token 0)")
            prompt = np.array([self.bos_id], np.int32)
        if int(prompt.min()) < 0 or int(prompt.max()) >= self.cfg.vocab:
            bad = prompt[(prompt < 0) | (prompt >= self.cfg.vocab)]
            raise ValueError(f"prompt contains token id(s) outside the "
                             f"vocab [0, {self.cfg.vocab}): "
                             f"{bad[:8].tolist()}")
        if prompt.size > self.max_seq:
            raise ValueError(f"prompt of {prompt.size} tokens exceeds "
                             f"max_seq={self.max_seq} cache slots")
        need = min(prompt.size + req.max_new_tokens - 1, self.max_seq - 1)
        cap = self.store.max_row_tokens()
        if cap is not None and need > cap:
            raise ValueError(
                f"request needs {need} cache tokens at peak but the store "
                f"holds at most {cap} tokens per row")
        self.obs.on_enqueue(req.id, int(prompt.size), req.max_new_tokens,
                            self.step_idx)
        self.scheduler.enqueue(QueueEntry(req=req, prompt=prompt,
                                          remaining=req.max_new_tokens,
                                          enqueue_step=self.step_idx))
        return self._admit().get(req.id)

    def _admit(self) -> dict[int, int]:
        """Move queued requests into free rows while a row and store
        capacity exist. FIFO, head-of-line."""
        admitted: dict[int, int] = {}
        while True:
            free = np.flatnonzero(~self.active)
            if free.size == 0:
                break
            row = int(free[0])
            entry = self.scheduler.pop_admittable(self.step_idx)
            if entry is None:
                break
            shared = self._prefix_match(entry)
            if not self.scheduler.admit(
                    row, len(entry.prompt), self.step_idx,
                    shared=None if shared is None
                    else (shared[0].row, shared[1])):
                self.scheduler.enqueue(entry, front=True)
                break
            self._start_row(row, entry, shared=shared)
            admitted[entry.req.id] = row
        return admitted

    def _prefix_match(self, entry: QueueEntry):
        """Deepest cached prefix of the tokens this admission will FEED
        (prompt[:-1]), as (PrefixEntry, matched_tokens), or None."""
        if self._prefix_index is None:
            return None
        fed = entry.prompt[:-1]
        if fed.size < self.cfg.amc.page_size:
            return None
        e, m = self._prefix_index.match(fed)
        if e is None:
            self._prefix_index.note_miss()
            self.obs.on_prefix("miss", entry.req.id, 0, self.step_idx)
            return None
        return e, m

    def _start_row(self, row: int, entry: QueueEntry, shared=None) -> None:
        self.active[row] = True
        self.slot_req[row] = entry.req
        self._slot_entry[row] = entry
        self.positions[row] = 0
        self.remaining[row] = entry.remaining
        self.outputs.setdefault(entry.req.id, [])
        self.obs.on_admit(entry.req.id, row, self.step_idx)
        # prompt[:-1] goes into the cache; the last prompt token is fed by
        # the first batched decode step, whose argmax is the first output
        fed = entry.prompt[:-1]
        m = 0
        if shared is not None:
            # prefix hit: admit_row mapped the cached pages into the row;
            # their prefill is skipped and the position clock starts past
            # the shared tokens
            e, m = shared
            self.positions[row] = m
            self._prefix_index.note_hit(e, m, self.step_idx)
            self.store.note_entry_use(e.row, m, self.step_idx)
            self._prefix_saved += -(-m // self.prefill_chunk)
            self.obs.on_prefix("hit", entry.req.id, m, self.step_idx)
        if fed.size > m:
            with self.obs.prefill_span(entry.req.id, int(fed.size) - m):
                self.prefill(row, fed[m:])
        if shared is None:
            self._register_prefix(row, fed)
        self.last_token[row] = int(entry.prompt[-1])

    def _register_prefix(self, row: int, fed: np.ndarray) -> None:
        """Cache the freshly prefilled prompt's full pages as a prefix
        entry: alias them into a share-band row and index the tokens.
        Skipped when the run is shorter than a page or no slot can be
        freed (every cached entry still has live sharers)."""
        idx = self._prefix_index
        if idx is None:
            return
        page = self.cfg.amc.page_size
        full = fed.size // page
        if full == 0:
            return
        slot = idx.acquire_slot(self.store, self.step_idx)
        if slot is None:
            return
        erow = self.store.entry_row(slot)
        self.store.register_entry_pages(erow, row, full, self.step_idx)
        idx.add_entry(slot, erow, fed[:full * page], self.step_idx)

    def prefix_probe(self, prompt: np.ndarray) -> int:
        """Tokens of `prompt` this engine's prefix cache already holds (0
        without one); pure."""
        if self._prefix_index is None:
            return 0
        fed = np.asarray(prompt, np.int32).reshape(-1)[:-1]
        if fed.size < self.cfg.amc.page_size:
            return 0
        return self._prefix_index.probe(fed)

    def _preempt(self, victim: int) -> None:
        """Release the victim's storage and requeue it with prompt :=
        original prompt + every token generated so far."""
        entry = self._slot_entry[victim]
        gen = np.asarray(self.outputs[entry.req.id], np.int32)
        resumed = QueueEntry(
            req=entry.req, prompt=np.concatenate([entry.base_prompt, gen]),
            base_prompt=entry.base_prompt,
            remaining=int(self.remaining[victim]),
            resumed=True, enqueue_step=self.step_idx)
        self.scheduler.release_row(victim)
        self.active[victim] = False
        self.slot_req[victim] = None
        self._slot_entry[victim] = None
        self.obs.on_preempt(entry.req.id, self.step_idx, "capacity")
        self.scheduler.enqueue(resumed, front=True)
        self.scheduler.stats["preemptions"] += 1

    # -- fleet hand-off (serve/fleet.py drives these) ---------------------------

    def adopt_request(self, entry: QueueEntry, generated: list[int], *,
                      front: bool = False) -> None:
        """Take over a request mid-flight from another array: seed the
        output list with the tokens it already generated (the resume
        prompt in `entry.prompt` holds them, so `_start_row`'s setdefault
        keeps the seed and a later preemption rebuilds from base_prompt +
        outputs without duplicating them), then enqueue. The fleet keeps
        each request id on at most one engine's books at a time."""
        rid = entry.req.id
        if rid in self.outputs or any(
                e.req.id == rid for e in self.scheduler.queue):
            raise ValueError(
                f"request id {rid} already lives on this array — the "
                f"fleet must pop it from the source array first")
        self.outputs[rid] = list(generated)
        self.obs.on_enqueue(rid, int(len(entry.prompt)), entry.remaining,
                            self.step_idx)
        self.scheduler.enqueue(entry, front=front)

    def drain_requests(self) -> list[tuple[QueueEntry, list[int]]]:
        """Array-loss drain for the fleet: release every running row and
        empty the queue, handing back [(entry, generated so far)] ready
        for `adopt_request` on a surviving array. `fault_retries` budgets
        are kept, never charged: losing the array is not the request's
        fault."""
        drained: list[tuple[QueueEntry, list[int]]] = []
        for row in np.flatnonzero(self.active):
            entry = self._slot_entry[int(row)]
            gen = self.outputs.pop(entry.req.id, [])
            resumed = QueueEntry(
                req=entry.req,
                prompt=np.concatenate([entry.base_prompt,
                                       np.asarray(gen, np.int32)]),
                base_prompt=entry.base_prompt,
                remaining=int(self.remaining[row]),
                resumed=True, enqueue_step=self.step_idx,
                fault_retries=entry.fault_retries,
                not_before=entry.not_before)
            self.scheduler.release_row(int(row))
            self.active[row] = False
            self.slot_req[row] = None
            self._slot_entry[row] = None
            self.obs.on_handoff(entry.req.id, self.step_idx, "drained")
            drained.append((resumed, gen))
        while self.scheduler.queue:
            e = self.scheduler.queue.popleft()
            self.obs.on_handoff(e.req.id, self.step_idx, "drained")
            drained.append((e, self.outputs.pop(e.req.id, [])))
        self.obs.on_queue_depth(0)
        return drained

    # -- dispatch ----------------------------------------------------------------

    def _dispatch(self, fn, batch: dict) -> torch.Tensor:
        """One device dispatch against the store's device state (paged
        arenas, updated in place, or slab planes, replaced), with the
        store's device tables merged in."""
        batch = {**self.store.device_tables(), **batch}
        with torch.no_grad():
            logits, self.store.state = fn(self.params, self.store.state,
                                          batch)
        self.dispatch_count += 1
        return logits

    def _ensure_prefill_pages(self, slot: int, first: int, last: int) -> None:
        page = self.cfg.amc.page_size
        for lp in range(first // page, last // page + 1):
            if not self.scheduler.ensure_position(slot, max(first, lp * page),
                                                  self.step_idx):
                raise RuntimeError(f"store exhausted allocating prefill "
                                   f"page {lp} of row {slot}")

    def prefill(self, slot: int, tokens: np.ndarray,
                return_next: bool = False) -> Optional[int]:
        """Feed `tokens` into the slot's cache, one dispatch per
        `prefill_chunk` tokens. With `return_next` also returns the greedy
        continuation of the last token."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        if tokens.size == 0:
            return None
        if self._prefill is None:          # family without chunked prefill
            return self._prefill_stepwise(slot, tokens)
        C = self.prefill_chunk
        write_mask = np.zeros(self.max_batch, bool)
        write_mask[slot] = True
        req = self.slot_req[slot]
        rid = req.id if req is not None else None
        last_logits, last_n = None, 0
        for start in range(0, tokens.size, C):
            chunk = tokens[start:start + C]
            n = chunk.size
            p = int(self.positions[slot])
            if p + n > self.max_seq:
                return self._prefill_stepwise(slot, tokens[start:])
            # near the cache end the write window is shifted left to
            # [max_seq - C, max_seq) and the left pad replays the last
            # `shift` prefilled tokens (bit-identical KV rewrite), so a
            # short final chunk still costs one dispatch
            shift = max(0, p + C - self.max_seq)
            if shift > start:
                return self._prefill_stepwise(slot, tokens[start:])
            tok = np.zeros((self.max_batch, C), np.int32)
            tok[slot, :shift + n] = tokens[start - shift:start + n]
            positions = self.positions.copy()
            positions[slot] = p - shift
            self._ensure_prefill_pages(slot, p - shift, p + n - 1)
            with self.obs.chunk_span(rid, n):
                logits = self._dispatch(self._prefill, {
                    "tokens": self._tensor(tok),
                    "positions": self._tensor(positions),
                    "write_mask": self._tensor(write_mask)})
            self.prefill_dispatch_count += 1
            self._account_dispatch(np.array([slot]), n, np.array([p + n]),
                                   np.array([p]))
            self.energy_ledger.note_tokens(n)
            self.positions[slot] += n
            self.store.note_token_writes(
                np.full(n + shift, slot), np.arange(p - shift, p + n),
                self.step_idx)
            last_logits, last_n = logits, shift + n
        if not return_next:
            return None
        return int(last_logits[slot, last_n - 1].argmax())

    def _prefill_stepwise(self, slot: int, tokens: np.ndarray):
        last = None
        for t in tokens:
            last = self._step_slot(slot, int(t))
            self.prefill_dispatch_count += 1
        return last

    def _step_slot(self, slot: int, token: int) -> int:
        if not self.scheduler.ensure_position(
                slot, int(self.positions[slot]), self.step_idx):
            raise RuntimeError("store exhausted during stepwise prefill")
        tokens = np.zeros((self.max_batch, 1), np.int32)
        tokens[slot, 0] = token
        mask = np.zeros(self.max_batch, bool)
        mask[slot] = True
        logits = self._dispatch(self._decode, {
            "tokens": self._tensor(tokens),
            "positions": self._tensor(self.positions),
            "write_mask": self._tensor(mask)})
        self.store.note_token_writes(np.array([slot]),
                                     np.array([self.positions[slot]]),
                                     self.step_idx)
        self._account_dispatch(np.array([slot]), 1,
                               np.array([self.positions[slot] + 1]),
                               np.array([self.positions[slot]]))
        self.energy_ledger.note_tokens(1)
        self.positions[slot] += 1
        return int(logits[slot, -1].argmax())

    # -- decode ----------------------------------------------------------------

    def _ensure_decode_capacity(self) -> None:
        """Every active row must own the page its next token lands in;
        when even augmentation cannot free room the youngest-admitted row
        is preempted (requeued, not dropped)."""
        for row in np.flatnonzero(self.active):
            if not self.active[row]:
                continue    # preempted by an earlier row's allocation
            pos = int(self.positions[row])
            while not self.scheduler.ensure_position(row, pos,
                                                     self.step_idx):
                victim = self.scheduler.preemption_victim(row, self.active)
                if victim is None:
                    raise RuntimeError(
                        "state store cannot hold one growing sequence — "
                        "budget_bytes too small for max_seq")
                self._preempt(victim)

    def step_all(self) -> dict:
        """One scheduler pass + one decode round for every active row:
        the array-health check, admit, the fault pass (inject, detect,
        heal), refresh expired Augmented pages, then a batched decode
        step or, with spec_k > 1, a speculative round (each grows /
        augments / preempts for capacity before it dispatches). Returns
        {row: next_token} for the rows still running."""
        if self._fault_model is not None or self._forced_array_loss:
            if not self.supervisor.run_step(self._array_health_check):
                # array loss: every running row was drained and requeued;
                # the clock still ticks (retry backoff counts steps)
                self.step_idx += 1
                return {}
        t0 = time.perf_counter()
        with self.obs.step_span(self.step_idx,
                                "spec" if self._spec else "decode"):
            with self.obs.phase_span("admit"):
                self._admit()
            if self._fault_model is not None:
                # before refresh and dispatch, so corrupted storage is
                # never read, refreshed or promoted
                with self.obs.fault_span(self.step_idx):
                    self._fault_pass()
            n_refreshed = self.scheduler.refresh_pass(self.step_idx)
            self.obs.on_refresh_pass(n_refreshed, self.step_idx)
            self._sync_refresh_events()
            if self._spec and self.active.any():
                out = self._step_all_spec()
            else:
                out = self._step_all_decode()
        dt = time.perf_counter() - t0
        self._note_step_time(dt)
        self.obs.on_step_done(self.step_idx, dt)
        if self.obs.wants_sample(self.step_idx):
            self.obs.sample(self.step_idx, self._obs_sample_payload())
        return out

    def _step_all_decode(self) -> dict:
        """The non-speculative round: one batched dispatch serves every
        active row."""
        self._ensure_decode_capacity()
        tokens = np.where(self.active, self.last_token, 0
                          ).astype(np.int32)[:, None]
        logits = self._dispatch(self._decode, {
            "tokens": self._tensor(tokens),
            "positions": self._tensor(self.positions),
            "write_mask": self._tensor(self.active)})
        rows = np.flatnonzero(self.active)
        self._account_dispatch(rows, 1, self.positions[rows] + 1,
                               self.positions[rows])
        self.energy_ledger.note_tokens(rows.size)
        arg = logits[:, -1].argmax(dim=-1).cpu().numpy().astype(np.int32)
        act = self.active.copy()
        if act.any():
            rows = np.flatnonzero(act)
            self.store.note_token_writes(rows, self.positions[rows],
                                         self.step_idx)
        self.positions[act] += 1
        self.remaining[act] -= 1
        self.last_token = np.where(act, arg, self.last_token)
        done = act & ((self.remaining <= 0)
                      | (self.positions >= self.max_seq - 1))
        self.active &= ~done
        for s in np.flatnonzero(act):
            rid = self.slot_req[s].id
            self.outputs[rid].append(int(arg[s]))
            self.obs.on_tokens(rid, 1, self.step_idx)
        self._end_round(done)
        return {int(s): int(arg[s]) for s in np.flatnonzero(act & ~done)}

    def _end_round(self, done: np.ndarray) -> None:
        """Release the rows that finished this round; tick the clock."""
        for s in np.flatnonzero(done):
            rid = self.slot_req[s].id
            self.slot_req[s] = None
            self._slot_entry[s] = None
            self.scheduler.release_row(int(s))
            self.obs.on_complete(rid, self.step_idx)
        self.step_idx += 1

    def _step_all_spec(self) -> dict:
        """One self-speculative round for every active row: spec_k - 1
        draft dispatches propose a spec_k-token window, ONE verify
        dispatch scores it and commits its accepted prefix, and that
        prefix is emitted. Greedy acceptance keeps the stream
        token-identical to stepwise decode; pages that held only rejected
        draft tokens are retracted, slabs rolled back to their snapshot."""
        W, B = self.spec_k, self.max_batch
        # per-row window cap >= 1: stepwise decode retires a row once its
        # position reaches max_seq - 1, so no slot may write past
        # max_seq - 2
        cap = np.ones(B, np.int32)
        rows = np.flatnonzero(self.active)
        cap[rows] = np.clip(self.max_seq - 1 - self.positions[rows], 1, W)
        # every window slot needs storage BEFORE the draft writes it: the
        # augment-then-preempt ladder of _ensure_decode_capacity
        for row in rows:
            if not self.active[row]:
                continue    # preempted by an earlier row's allocation
            while not self.scheduler.ensure_window(
                    int(row), int(self.positions[row]), int(cap[row]),
                    self.step_idx):
                victim = self.scheduler.preemption_victim(int(row),
                                                          self.active)
                if victim is None:
                    raise RuntimeError(
                        "state store cannot hold one growing sequence — "
                        "budget_bytes too small for max_seq")
                self._preempt(victim)
        rows = np.flatnonzero(self.active)
        wmask = self.active[:, None] & (np.arange(W)[None, :] < cap[:, None])
        # draft: W - 1 cheap single-token steps propose the window tail
        toks = np.zeros((B, W), np.int32)
        toks[:, 0] = np.where(self.active, self.last_token, 0)
        slab = self.store.kind == "slab"
        if slab:
            # the drafts advance the recurrent state itself
            self.store.speculative_snapshot()
        with self.obs.phase_span("spec_draft", k=W - 1):
            for i in range(W - 1):
                # the clamp keeps INACTIVE rows' stale positions inside
                # the table; active rows stay below max_seq - 1 by the cap
                pos_i = np.minimum(self.positions + i, self.max_seq - 1)
                lg = self._dispatch(self._draft_decode, {
                    "tokens": self._tensor(toks[:, i:i + 1]),
                    "positions": self._tensor(pos_i.astype(np.int32)),
                    "write_mask": self._tensor(wmask[:, i])})
                self.energy_ledger.add(imc_energy.decode_matmul_events(
                    self._draft_cfg, int(rows.size)), "draft")
                self._spec_stats["draft_dispatches"] += 1
                toks[:, i + 1] = lg[:, -1].argmax(dim=-1).cpu().numpy()
        if slab:
            # the verify replays the window from the pre-draft state
            self.store.speculative_restore()
        # verify: ONE full-quality dispatch over the whole window
        with self.obs.phase_span("spec_verify", k=W):
            logits = self._dispatch(self._verify, {
                "tokens": self._tensor(toks),
                "positions": self._tensor(self.positions),
                "write_mask": self._tensor(wmask)})
        self._spec_stats["verify_dispatches"] += 1
        self._spec_stats["spec_rounds"] += 1
        self._account_dispatch(rows, W, self.positions[rows] + cap[rows],
                               self.positions[rows])
        # host accept: the formula the verify step committed KV with
        v = logits.argmax(dim=-1).cpu().numpy().astype(np.int32)
        mism = np.concatenate([toks[:, 1:] != v[:, :-1],
                               np.ones((B, 1), bool)], axis=1)
        n_acc = np.minimum(mism.argmax(axis=1).astype(np.int32) + 1, cap)
        act = self.active.copy()
        n_emit = np.where(act, np.minimum(n_acc, self.remaining),
                          0).astype(np.int32)
        rw, ps = [], []
        for s in rows:
            rid = self.slot_req[s].id
            self.outputs[rid].extend(int(t) for t in v[s, :n_emit[s]])
            self.obs.on_tokens(rid, int(n_emit[s]), self.step_idx)
            nc = int(n_acc[s])     # committed (may exceed the emit budget)
            rw.extend([int(s)] * nc)
            ps.extend(range(int(self.positions[s]),
                            int(self.positions[s]) + nc))
        if rw:
            self.store.note_token_writes(np.array(rw), np.array(ps),
                                         self.step_idx)
        total = int(n_emit.sum())
        self.energy_ledger.note_tokens(total)
        self._spec_stats["accepted_tokens"] += total
        self.obs.on_spec_round(total, int(rows.size), self.step_idx)
        if rows.size:
            self.store.retract_token_writes(
                rows, self.positions[rows] + n_acc[rows])
        self.positions[act] += n_emit[act]
        self.remaining[act] -= n_emit[act]
        last = v[np.arange(B), np.maximum(n_emit - 1, 0)]
        self.last_token = np.where(act, last, self.last_token)
        done = act & ((self.remaining <= 0)
                      | (self.positions >= self.max_seq - 1))
        self.active &= ~done
        self._end_round(done)
        return {int(s): int(v[s, n_emit[s] - 1])
                for s in np.flatnonzero(act & ~done)}

    # -- retention faults: inject / detect / heal ------------------------------

    def _note_step_time(self, dt: float) -> None:
        """Feed the step's wall time to the straggler monitor (recorded on
        every run; mitigations are only counted)."""
        if self.straggler.record(self.step_idx, dt):
            self._fault_stats["straggler_mitigations"] += 1

    def inject_array_loss(self) -> None:
        """Force a whole-array failure at the next `step_all`: every
        running row is drained back to the queue and resumes by
        recompute (work lost, tokens never)."""
        self._forced_array_loss = True

    def _array_health_check(self) -> None:
        if self._forced_array_loss:
            self._forced_array_loss = False
            raise SimulatedFailure(
                f"injected array loss at step {self.step_idx}")
        if self._fault_model is not None \
                and self._fault_model.array_loss(self.step_idx):
            raise SimulatedFailure(
                f"sampled array loss at step {self.step_idx}")

    def _recover_array_loss(self) -> int:
        """Supervisor restore hook: the array's contents are gone, so every
        running row is preempted (released and requeued with prompt :=
        prompt + generated). Retry budgets are NOT charged: the loss is
        not the request's fault."""
        rows = np.flatnonzero(self.active)
        self.obs.on_fault("array_loss", f"rows={rows.size}", self.step_idx)
        for row in rows:
            self._preempt(int(row))
            self._fault_stats["array_loss_requeues"] += 1
        if self._prefix_index is not None:
            # the pages behind every cached prefix went with the array
            self._prefix_index.invalidate(self.store)
        self._fault_stats["array_losses"] += 1
        return int(rows.size)

    def _fault_pass(self) -> None:
        """One inject -> detect -> heal cycle. A corrupt page or slab heals
        by a scrub from its master where one exists (share-band pages),
        else its request is recomputed with bounded, backed-off retries;
        the recovery traffic goes to the ledger's "recovery" group."""
        for key in self.scheduler.fault_pass(self.step_idx):
            self.obs.on_fault("detect", str(key), self.step_idx)
            self.energy_ledger.add(
                imc_energy.refresh_events(self.store.fault_unit_bytes(key)),
                "recovery")
            if self.store.scrub_from_master(key):
                self._fault_stats["recovered_scrub"] += 1
                self.obs.on_fault("heal_scrub", str(key), self.step_idx)
                continue
            row = self.store.fault_row(key)
            if row is None or not self.active[row]:
                continue    # second corrupt page of an already-healed row
            self._heal_row_recompute(int(row))

    def _heal_row_recompute(self, row: int) -> None:
        """Recompute via preemption: a decode row's pages have no master,
        so its state is rebuilt from its token history. Each retry backs
        off exponentially; past cfg.amc.max_retries the request fails."""
        entry = self._slot_entry[row]
        retries = entry.fault_retries + 1
        if retries > self.cfg.amc.max_retries:
            self._fail_row(row)
            return
        gen = np.asarray(self.outputs[entry.req.id], np.int32)
        resumed = QueueEntry(
            req=entry.req, prompt=np.concatenate([entry.base_prompt, gen]),
            base_prompt=entry.base_prompt,
            remaining=int(self.remaining[row]),
            resumed=True, enqueue_step=self.step_idx,
            fault_retries=retries,
            not_before=self.step_idx + 2 ** (retries - 1))
        self.scheduler.release_row(row)
        self.active[row] = False
        self.slot_req[row] = None
        self._slot_entry[row] = None
        self.obs.on_fault("heal_recompute", f"row{row}", self.step_idx)
        self.obs.on_preempt(entry.req.id, self.step_idx, "fault_recompute")
        self.scheduler.enqueue(resumed, front=True)
        self._fault_stats["recovered_recompute"] += 1
        self._fault_stats["retried"] += 1

    def _fail_row(self, row: int) -> None:
        """Retry budget used up: the request goes to `failed` with what it
        generated, an explicit outcome, never a corrupt completion."""
        entry = self._slot_entry[row]
        self.failed[entry.req.id] = self.outputs.pop(entry.req.id, [])
        self.scheduler.release_row(row)
        self.active[row] = False
        self.slot_req[row] = None
        self._slot_entry[row] = None
        self.obs.on_fault("uncorrectable", f"req{entry.req.id}",
                          self.step_idx)
        self.obs.on_failed(entry.req.id, self.step_idx)
        self._fault_stats["uncorrectable"] += 1

    def generate(self, requests: list[Request]) -> dict[int, list[int]]:
        """Run all requests to completion (queue and running batch drain).
        While every queued entry backs off after a fault retry, the step
        clock ticks until one is eligible."""
        for req in requests:
            self.add_request(req)
        while self.active.any() or self.scheduler.queue:
            if not self.active.any():
                self._admit()
                if not self.active.any():
                    if self.scheduler.backlog_ready(self.step_idx):
                        raise RuntimeError("queued requests but nothing "
                                           "admittable — store "
                                           "misconfigured")
                    self.step_idx += 1
                    continue
            self.step_all()
        return self.outputs

    # -- stats -----------------------------------------------------------------

    def stats(self) -> dict:
        """Logical (dense bf16) vs physical bytes of weights and cache,
        the pool's and the scheduler's counters, the speculative
        counters and the array event/energy ledger ("imc")."""
        a = self.cfg.amc
        weight_phys = tree_nbytes(self.params)
        cache_phys = self.store.physical_bytes()
        weight_mode = a.weight_mode if augment.is_augmented(self.params) \
            else "normal"
        logical = self._logical_weight_bytes + self._logical_cache_bytes
        pool = self.store.describe()
        out = {
            "kv_mode": a.kv_mode,
            "weight_mode": weight_mode,
            "weight_bits_per_value": amc.mode_bits_per_value(
                amc.WEIGHT_MODES[weight_mode], a.ternary_fmt),
            "kv_bits_per_value": amc.KV_BITS_PER_VALUE[a.kv_mode],
            "weight_bytes_logical": self._logical_weight_bytes,
            "weight_bytes_physical": weight_phys,
            "weight_capacity_factor": self._logical_weight_bytes
                                      / weight_phys,
            "cache_bytes_logical": self._logical_cache_bytes,
            "cache_bytes_physical": cache_phys,
            "cache_capacity_factor": self._logical_cache_bytes / cache_phys,
            "total_bytes_logical": logical,
            "total_bytes_physical": weight_phys + cache_phys,
            "capacity_factor": logical / (weight_phys + cache_phys),
            "dispatches": self.dispatch_count,
            "prefill_dispatches": self.prefill_dispatch_count,
            "pool": pool,
            "scheduler": self.scheduler.describe(),
            "preemptions": self.scheduler.stats["preemptions"],
        }
        for k in ("refreshes", "refresh_bytes", "augment_events",
                  "promote_events", "maintenance_dispatches"):
            out[k] = pool[k]
        sp = dict(self._spec_stats)
        nd = sp["draft_dispatches"] + sp["verify_dispatches"]
        sp.update({
            "enabled": self._spec,
            "spec_k": self.spec_k,
            "spec_draft_impl": a.spec_draft_impl,
            # useful tokens per device dispatch across the draft + verify
            # round (stepwise decode is 1.0 by construction)
            "accepted_tokens_per_dispatch":
                sp["accepted_tokens"] / nd if nd else 0.0,
            "accepted_tokens_per_round":
                sp["accepted_tokens"] / sp["spec_rounds"]
                if sp["spec_rounds"] else 0.0,
        })
        out["spec"] = sp
        # array-level event/energy accounting: weight-side events follow
        # matmul_impl (IMC wordline/bitline/ADC vs fetch), KV reads are
        # split by page mode (Normal pages cost 6T read events, Augmented
        # pages the 8T dynamic-read events)
        E = imc_energy.EVENT_ENERGY_FJ
        self._sync_refresh_events()
        imc = self.energy_ledger.describe()
        imc["matmul_impl"] = a.matmul_impl
        imc["imc_abits"] = a.imc_abits
        imc["kv_read_fj_per_value_normal_mode"] = 16 * E["read_6t"]
        imc["kv_read_fj_per_value_augmented_mode"] = (
            self.store.aug_bits * E["read_8t_dynamic"])
        imc["refresh_energy_fj"] = imc["groups"].get(
            "refresh", {}).get("energy_fj", 0.0)
        out["imc"] = imc
        # retention faults: injection/detection counters of the pool,
        # recovery outcomes of the engine, and zero silent corruption —
        # with integrity on, every injected fault was detected or masked
        # (its storage released before any read)
        fc = self.store.fault_counters()
        pending = self.store.faults_pending()
        injected = fc["faults_injected"]
        served_clean = injected == (fc["faults_detected"]
                                    + fc["faults_masked"])
        out["faults"] = {
            "enabled": self._fault_model is not None,
            "fault_rate": a.fault_rate,
            "fault_seed": a.fault_seed,
            "array_loss_rate": a.array_loss_rate,
            "fault_temp_c": a.fault_temp_c,
            "integrity_check": a.integrity_check,
            "max_retries": a.max_retries,
            "fault_pin_threshold": a.fault_pin_threshold,
            **fc,
            **self._fault_stats,
            "faults_pending": pending,
            "recovered": (self._fault_stats["recovered_scrub"]
                          + self._fault_stats["recovered_recompute"]),
            "failed_requests": len(self.failed),
            "supervisor_restarts": self.supervisor.restarts,
            "recovery_energy_fj": imc["groups"].get(
                "recovery", {}).get("energy_fj", 0.0),
            "zero_silent_corruption": bool(
                injected == 0 or (a.integrity_check and served_clean
                                  and pending == 0)),
        }
        out["prefix"] = {
            "enabled": self._prefix_index is not None,
            "prefill_dispatches": self.prefill_dispatch_count,
            "dispatches_saved": self._prefix_saved,
            "cow_events": pool.get("cow_events", 0),
            "cow_bytes": pool.get("cow_bytes", 0),
            "demotions": pool.get("prefix_demotions", 0),
            "evictions": pool.get("prefix_evictions", 0),
            "pages_shared": pool.get("pages_shared", 0),
            "bytes_shared": pool.get("bytes_shared", 0),
        }
        if self._prefix_index is not None:
            out["prefix"].update(self._prefix_index.describe())
        # per-step wall times and the observability planes; both describes
        # are pure snapshots, so stats() stays idempotent
        out["step_times"] = self.straggler.describe()
        out["obs"] = self.obs.describe()
        return out

    # -- observability ----------------------------------------------------------

    def _obs_sample_payload(self) -> dict:
        """One time-series tick of the store, scheduler and energy state
        (mode mix, occupancy, refresh debt, energy-group totals), from
        host bookkeeping only."""
        mode_n, mode_a = self.store.mode_mix()
        payload = {
            "pool_occupancy": self.store.live_bytes
                              / max(self.store.budget_bytes, 1),
            "mode_normal": mode_n,
            "mode_augmented": mode_a,
            "queue_depth": len(self.scheduler.queue),
            "running": int(self.active.sum()),
            "refresh_debt": self.store.max_augmented_age(self.step_idx),
        }
        E = imc_energy.EVENT_ENERGY_FJ
        for (group, cls), n in self.energy_ledger.counts.items():
            k = "energy_" + group + "_fj"
            payload[k] = payload.get(k, 0.0) + E[cls] * n
        return payload

    def export_trace(self, path: str) -> dict:
        """Write the Chrome trace-event JSON (perfetto-loadable)."""
        return self.obs.export_trace(path)

    def export_metrics(self, path: str) -> str:
        """Write the Prometheus text exposition of the metrics plane."""
        return self.obs.export_metrics(path)
