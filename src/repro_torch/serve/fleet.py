"""ArrayFleet: serving across several logical SRAM arrays.

The paper's capacity unit is one SRAM array; everything below
`ArrayFleet` serves exactly one. The fleet instantiates `num_arrays`
logical arrays, one full `ServeEngine` each, so every array owns its own
byte budget, store (paged KV pool and/or slab pool), refresh clock
(`step_idx`), fault domain (FaultModel + Supervisor) and energy ledger.
The arrays sit on a partition of the CUDA devices (serve/placement.py):
contiguous groups when devices >= arrays, round-robin sharing otherwise
(one H100 carries every array on cuda:0). An array runs on the first
device of its group; there is no tensor-parallel sharding inside an
array.

Placement: a fleet-level `PlacementPolicy` (least-loaded /
budget-headroom / affinity) admits each request onto one array. After
each decode round the fleet migrates queued work off arrays that cannot
admit it onto arrays that can (`ServeEngine.adopt_request` seeds the
target's output map, so a later preemption's recompute keeps the
tokens), and a fleet-level Supervisor drains a LOST array onto the
survivors, keeping each request's `fault_retries` budget: losing an array
is never the request's fault.

Token identity: every array decodes the same weights (one dense tree,
packed identically per array) through the same kernels, and a row's
decode does not depend on the batch around it, so the fleet's tokens
equal one array's.

Observability: per-array `EngineObs` facades share ONE trace epoch and
ONE metrics registry; each array records on its own trace pid ("array
N" process lanes), placement / migration / drain decisions land as
instants on the target array's lane, and `export_trace` merges them
into one Chrome trace.

Ported from `repro.serve.fleet`.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Optional

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.fault import SimulatedFailure, Supervisor
from repro_torch.models.params import init_params
from repro_torch.obs import hooks as obs_hooks
from repro_torch.obs.export import merge_chrome_traces
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.placement import (ArrayView, make_array_meshes,
                                         make_policy)


class ArrayFleet:
    def __init__(self, cfg: ModelConfig, *, device=None,
                 num_arrays: Optional[int] = None,
                 placement: Optional[str] = None,
                 params=None, seed: int = 0,
                 trace: Optional[bool] = None,
                 metrics: Optional[bool] = None,
                 obs_sample_every: Optional[int] = None,
                 fault_seed: Optional[int] = None,
                 **engine_kwargs):
        n = num_arrays if num_arrays is not None else cfg.amc.num_arrays
        if n < 1:
            raise ValueError(f"num_arrays must be >= 1, got {n}")
        self.cfg = cfg
        self.num_arrays = n
        self.policy = make_policy(placement if placement is not None
                                  else cfg.amc.placement)
        self.device_groups = make_array_meshes(n, device)
        # one dense weight tree, drawn once on the first array's device:
        # every array packs the SAME weights (augment_params is
        # deterministic), which makes fleet decode equal single-array
        # decode; leaves that stay dense are shared, not copied
        if params is None:
            dense_cfg = dataclasses.replace(
                cfg, amc=dataclasses.replace(cfg.amc, weight_mode="normal"))
            params = init_params(dense_cfg, seed=seed,
                                 device=self.device_groups[0][0])
        # obs: per-array facades on one shared clock epoch + one shared
        # metrics registry, each tracing on its own pid ("array N" lane)
        trace_on = cfg.amc.trace if trace is None else trace
        metrics_on = cfg.amc.metrics if metrics is None else metrics
        sample_every = (cfg.amc.obs_sample_every if obs_sample_every is None
                        else obs_sample_every)
        self._obs_on = bool(trace_on or metrics_on)
        epoch = time.perf_counter()
        registry = MetricsRegistry() if self._obs_on else None
        base_fault_seed = (cfg.amc.fault_seed if fault_seed is None
                           else fault_seed)
        self.engines: list[ServeEngine] = []
        for aid in range(n):
            obs = None
            if self._obs_on:
                obs = obs_hooks.EngineObs(
                    trace=trace_on, metrics=metrics_on,
                    sample_every=sample_every, pid=aid,
                    process=f"array {aid}", epoch=epoch, registry=registry)
            self.engines.append(ServeEngine(
                cfg, device=self.device_groups[aid][0], params=params,
                seed=seed, trace=trace, metrics=metrics,
                obs_sample_every=obs_sample_every,
                # each array is its own fault domain, not a mirror of
                # array 0
                fault_seed=base_fault_seed + aid,
                obs=obs, **engine_kwargs))
        self.placements: dict[int, int] = {}     # request id -> array id
        self._dead: set[int] = set()
        self._pending_loss: set[int] = set()
        # lost arrays drain through the same Supervisor machinery the
        # single-array engine uses for its own array loss
        self.supervisor = Supervisor(self._drain_lost_arrays,
                                     max_restarts=max(64, 4 * n))
        self.step_count = 0
        self._fleet_stats = {
            "placements": 0, "migrations": 0, "array_losses": 0,
            "drain_requeues": 0, "peak_concurrency": 0,
        }
        # decision-reason histogram (affinity: prefix / hash / fallback;
        # the other policies count their name)
        self._placement_decisions: dict[str, int] = {}

    # -- request intake ---------------------------------------------------------

    def _alive_ids(self) -> list[int]:
        return [i for i in range(self.num_arrays) if i not in self._dead]

    def _views(self) -> list[ArrayView]:
        return [ArrayView(aid=i, alive=i not in self._dead,
                          running=int(e.active.sum()),
                          queued=len(e.scheduler.queue),
                          free_rows=int((~e.active).sum()),
                          live_bytes=int(e.store.live_bytes),
                          budget_bytes=int(e.store.budget_bytes),
                          admit_probe=e.store.can_admit_tokens,
                          prefix_probe=e.prefix_probe)
                for i, e in enumerate(self.engines)]

    def add_request(self, req: Request) -> int:
        """Place `req` on one array and enqueue it there; returns the
        array id. As on one engine, the request is admitted at once when
        a row and capacity exist and queues otherwise, never dropped."""
        if req.id in self.placements:
            raise ValueError(
                f"request id {req.id} already placed on array "
                f"{self.placements[req.id]} — ids are fleet-unique")
        aid = self.policy.place(np.asarray(req.prompt), self._views())
        eng = self.engines[aid]
        eng.add_request(req)          # validates; may admit immediately
        self.placements[req.id] = aid
        self._fleet_stats["placements"] += 1
        reason = getattr(self.policy, "last_reason", self.policy.name)
        self._placement_decisions[reason] = \
            self._placement_decisions.get(reason, 0) + 1
        eng.obs.on_placement(req.id, aid, self.policy.name, "admit",
                             eng.step_idx)
        self._note_concurrency()
        return aid

    # -- fleet stepping ---------------------------------------------------------

    def _note_concurrency(self) -> None:
        running = sum(int(self.engines[i].active.sum())
                      for i in self._alive_ids())
        if running > self._fleet_stats["peak_concurrency"]:
            self._fleet_stats["peak_concurrency"] = running

    def step_all(self) -> dict:
        """One fleet round: drain any lost array onto the survivors, admit
        and decode one step on every array with work, then rebalance
        queued work. Returns {(array_id, row): next_token}."""
        if self._pending_loss:
            self.supervisor.run_step(self._fleet_health_check)
        out: dict = {}
        running = 0
        for aid in self._alive_ids():
            eng = self.engines[aid]
            if eng.scheduler.queue and not eng.active.all():
                eng._admit()
            n_act = int(eng.active.sum())
            running += n_act
            if n_act:
                for row, tok in eng.step_all().items():
                    out[(aid, row)] = tok
            elif eng.scheduler.queue:
                # nothing admittable (capacity or retry backoff): the
                # array's step clock still ticks so backoff expires
                eng.step_idx += 1
        if running > self._fleet_stats["peak_concurrency"]:
            self._fleet_stats["peak_concurrency"] = running
        self._rebalance()
        self.step_count += 1
        return out

    def _rebalance(self) -> int:
        """Migrate queued entries an array cannot admit right now onto an
        array that can (a free row AND store capacity, augmentation
        headroom counted). A retry's backoff is respected and translated
        between the two arrays' step clocks. The request lands at the
        target's queue tail; targets must admit it now, so work never
        ping-pongs."""
        moved = 0
        for src_id in self._alive_ids():
            src = self.engines[src_id]
            q = src.scheduler.queue
            i = 0
            while i < len(q):
                entry = q[i]
                if entry.not_before > src.step_idx:
                    i += 1              # backing off: not migratable yet
                    continue
                need = max(len(entry.prompt), 1)
                if (not src.active.all()
                        and src.store.can_admit_tokens(need)):
                    i += 1              # the source admits it itself
                    continue
                dst_id = self._migration_target(need, src_id)
                if dst_id is None:
                    i += 1
                    continue
                del q[i]
                gen = src.outputs.pop(entry.req.id, [])
                src.obs.on_handoff(entry.req.id, src.step_idx, "migrated")
                dst = self.engines[dst_id]
                entry.not_before = dst.step_idx + max(
                    0, entry.not_before - src.step_idx)
                entry.enqueue_step = dst.step_idx
                dst.adopt_request(entry, gen)
                self.placements[entry.req.id] = dst_id
                self._fleet_stats["migrations"] += 1
                dst.obs.on_placement(entry.req.id, dst_id, self.policy.name,
                                     "migrate", dst.step_idx)
                moved += 1
        return moved

    def _migration_target(self, need_tokens: int,
                          exclude: int) -> Optional[int]:
        best, best_key = None, None
        for v in self._views():
            if not v.alive or v.aid == exclude:
                continue
            if not v.can_admit_now(need_tokens):
                continue
            key = (v.load, -v.headroom_bytes, v.aid)
            if best_key is None or key < best_key:
                best, best_key = v.aid, key
        return best

    # -- array loss -------------------------------------------------------------

    def inject_array_loss(self, array_id: Optional[int] = None) -> int:
        """Force a whole-array loss at the next fleet step. Default
        target: the busiest alive array. The fleet Supervisor drains its
        running rows AND queue onto the survivors."""
        alive = self._alive_ids()
        if not alive:
            raise RuntimeError("no alive arrays left to lose")
        if array_id is None:
            array_id = max(alive,
                           key=lambda i: int(self.engines[i].active.sum()))
        if array_id in self._dead:
            raise ValueError(f"array {array_id} is already lost")
        self._pending_loss.add(array_id)
        return array_id

    def _fleet_health_check(self) -> None:
        if self._pending_loss:
            raise SimulatedFailure(
                f"array loss: {sorted(self._pending_loss)} at fleet step "
                f"{self.step_count}")

    def _drain_lost_arrays(self) -> int:
        """Supervisor restore hook: every pending lost array is drained
        (running rows released, queue emptied) and each request re-placed
        on a survivor at the FRONT of its queue, in order, with its
        `fault_retries` budget as it was: an array loss never charges the
        retry bound."""
        moved = 0
        for aid in sorted(self._pending_loss):
            if aid in self._dead:
                continue
            eng = self.engines[aid]
            drained = eng.drain_requests()
            self._dead.add(aid)
            self._fleet_stats["array_losses"] += 1
            eng.obs.on_fault("array_loss", f"array{aid}", eng.step_idx)
            if drained and not self._alive_ids():
                raise RuntimeError(
                    "array loss drained the last alive array — no "
                    "survivors to re-place its requests on")
            # reversed + front=True keeps the drained order at the head
            # of each destination queue
            for entry, gen in reversed(drained):
                dst_id = self.policy.place(entry.prompt, self._views())
                dst = self.engines[dst_id]
                entry.not_before = dst.step_idx + max(
                    0, entry.not_before - eng.step_idx)
                entry.enqueue_step = dst.step_idx
                dst.adopt_request(entry, gen, front=True)
                self.placements[entry.req.id] = dst_id
                dst.obs.on_placement(entry.req.id, dst_id, self.policy.name,
                                     "drain", dst.step_idx)
                moved += 1
            self._fleet_stats["drain_requeues"] += len(drained)
        self._pending_loss.clear()
        return moved

    # -- drive / results --------------------------------------------------------

    @property
    def has_work(self) -> bool:
        return any(self.engines[i].active.any()
                   or self.engines[i].scheduler.queue
                   for i in self._alive_ids())

    @property
    def outputs(self) -> dict[int, list[int]]:
        """Fleet-wide output map. A request id lives on exactly one array
        at a time (migration and drain pop it from the source first), so
        the merge has no collisions."""
        out: dict[int, list[int]] = {}
        for eng in self.engines:
            out.update(eng.outputs)
        return out

    @property
    def failed(self) -> dict[int, list[int]]:
        out: dict[int, list[int]] = {}
        for eng in self.engines:
            out.update(eng.failed)
        return out

    def generate(self, requests: list[Request]) -> dict[int, list[int]]:
        """Run all requests to completion across the fleet: place them
        all, then step rounds until every array drains."""
        for req in requests:
            self.add_request(req)
        while self.has_work:
            if not any(self.engines[i].active.any()
                       for i in self._alive_ids()):
                # nothing running anywhere: rebalance and admit once
                # more; a ready backlog that still cannot land means the
                # fleet is misconfigured (a budget below one sequence)
                self._rebalance()
                for aid in self._alive_ids():
                    self.engines[aid]._admit()
                if not any(self.engines[i].active.any()
                           for i in self._alive_ids()):
                    if any(self.engines[i].scheduler.backlog_ready(
                            self.engines[i].step_idx)
                           for i in self._alive_ids()):
                        raise RuntimeError(
                            "queued requests but nothing admittable on "
                            "any array — per-array budget below one "
                            "sequence?")
                    for aid in self._alive_ids():
                        self.engines[aid].step_idx += 1
                    continue
            self.step_all()
        return self.outputs

    # -- stats / observability --------------------------------------------------

    def stats(self) -> dict:
        """Fleet summary and every array's engine stats. "fleet" holds the
        aggregate counters, byte totals and a per-array table
        (occupancy, mode mix, refresh debt, devices)."""
        per_array = []
        for i, eng in enumerate(self.engines):
            mode_n, mode_a = eng.store.mode_mix()
            per_array.append({
                "array": i,
                "alive": i not in self._dead,
                "running": int(eng.active.sum()),
                "queued": len(eng.scheduler.queue),
                "live_bytes": int(eng.store.live_bytes),
                "budget_bytes": int(eng.store.budget_bytes),
                "occupancy": eng.store.live_bytes
                             / max(eng.store.budget_bytes, 1),
                "mode_normal": mode_n,
                "mode_augmented": mode_a,
                "refresh_debt": eng.store.max_augmented_age(eng.step_idx),
                "peak_concurrency":
                    eng.scheduler.stats["peak_concurrency"],
                "preemptions": eng.scheduler.stats["preemptions"],
                "step_idx": eng.step_idx,
                "dispatches": eng.dispatch_count,
                "energy_fj": eng.energy_ledger.describe()
                             ["energy_fj_total"],
                "mesh_devices": len(self.device_groups[i]),
                # no tensor parallelism inside an array (yet): one device
                # computes, the model axis is 1
                "model_axis": 1,
                "heads_axes": None,
                "tensor_parallel": False,
            })
        placements_per_array = [0] * self.num_arrays
        for aid in self.placements.values():
            placements_per_array[aid] += 1
        fleet = {
            "num_arrays": self.num_arrays,
            "placement": self.policy.name,
            "alive": self._alive_ids(),
            "dead": sorted(self._dead),
            **self._fleet_stats,
            "steps": self.step_count,
            "running": sum(a["running"] for a in per_array),
            "queued": sum(a["queued"] for a in per_array),
            "aggregate_budget_bytes": sum(a["budget_bytes"]
                                          for a in per_array),
            "aggregate_live_bytes": sum(a["live_bytes"]
                                        for a in per_array),
            "placements_per_array": placements_per_array,
            "per_array": per_array,
        }
        return {"fleet": fleet,
                "placement": {
                    "policy": self.policy.name,
                    "decisions": dict(self._placement_decisions),
                },
                "arrays": [eng.stats() for eng in self.engines]}

    def export_trace(self, path: str) -> dict:
        """Merge every array's trace (distinct pids, one shared epoch)
        into one perfetto-loadable Chrome trace and write it."""
        if not self._obs_on:
            return self.engines[0].export_trace(path)  # raises with help
        obj = merge_chrome_traces(
            [eng.obs.tracer.chrome_trace() for eng in self.engines])
        with open(path, "w") as f:
            json.dump(obj, f)
        return obj

    def export_metrics(self, path: str) -> str:
        """One fleet-wide Prometheus dump: the arrays share a registry."""
        return self.engines[0].export_metrics(path)


def make_serving(cfg: ModelConfig, *, device=None,
                 num_arrays: Optional[int] = None,
                 placement: Optional[str] = None, **kwargs):
    """Engine factory: a single-array `ServeEngine` when `num_arrays`
    (the argument or cfg.amc.num_arrays) is 1, an `ArrayFleet` above
    that. The CLI goes through here, so `--num-arrays` is the only switch
    between the two."""
    n = num_arrays if num_arrays is not None else cfg.amc.num_arrays
    if n <= 1:
        return ServeEngine(cfg, device=device, **kwargs)
    return ArrayFleet(cfg, device=device, num_arrays=n, placement=placement,
                      **kwargs)
