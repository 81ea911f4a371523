"""EngineObs — the one observability facade the serving stack talks to.

`ServeEngine`, `Scheduler` and the state stores never touch the tracer or
the metrics registry directly: they call the lifecycle hooks below, and
the facade fans each hook out to spans/instants (Chrome trace) and
counters/histograms/time series (metrics). `NullEngineObs` implements the
same surface as constant no-ops — the engine holds exactly one `self.obs`
and never branches on "is tracing on?" at a call site.

Span taxonomy (one request = one perfetto lane, fixed lanes for the
engine/scheduler/refresh/fault machinery — DESIGN.md SS12):

  request lane   enqueue(i) -> [queue] -> [active [prefill [chunk]*]]
                 -> first_token(i)/token instants -> complete(i)
                 with preempt/heal hops re-opening [queue] on the SAME
                 lane (request-id continuity across requeues)
  engine lane    [step [admit] [spec_draft] [spec_verify]] per decode
                 round, plus counter tracks (mode mix, occupancy, queue)
  refresh lane   refresh_pass / augment / promote / restamp instants
  fault lane     [fault_pass] spans, inject/detect/heal/fail instants

Latency metrics (log-bucketed histograms, seconds): ttft_s (enqueue ->
first emitted token), queue_wait_s (enqueue/requeue -> admit),
inter_token_s (per-token gap between emissions), step_wall_s (host wall
per engine step), prefill_chunk_s, request_latency_s.
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable, Optional

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import (ENGINE_TRACK, FAULT_TRACK, REFRESH_TRACK,
                             SCHED_TRACK, NullTracer, Tracer, _NULL_CTX)


class _Req:
    """Host-side lifecycle record of one request (both planes read it)."""
    __slots__ = ("tid", "enqueue_s", "queue_since_s", "queue_span",
                 "active_span", "first_s", "last_s", "tokens", "done")

    def __init__(self, tid: int, now: float):
        self.tid = tid
        self.enqueue_s = now
        self.queue_since_s = now
        self.queue_span = 0
        self.active_span = 0
        self.first_s: Optional[float] = None
        self.last_s: Optional[float] = None
        self.tokens = 0
        self.done = False


class EngineObs:
    enabled = True

    def __init__(self, *, trace: bool = True, metrics: bool = True,
                 sample_every: int = 1, clock: Optional[Callable] = None,
                 pid: int = 0, process: str = "amc-serve",
                 epoch: Optional[float] = None, registry=None):
        self._clock = clock if clock is not None else time.perf_counter
        self.trace_on = trace
        self.metrics_on = metrics
        self.sample_every = max(int(sample_every), 1)
        # pid/process/epoch: an ArrayFleet gives each array its own trace
        # pid ("array N" process lane) on ONE shared time base; `registry`
        # shares a single metrics plane across arrays (fleet-wide
        # histograms) while traces stay per-array
        self.tracer = (Tracer(clock=clock, pid=pid, process=process,
                              epoch=epoch) if trace else NullTracer())
        self.metrics = registry if registry is not None else MetricsRegistry()
        self._reqs: dict[int, _Req] = {}
        # pre-bound hot-path histograms: the decode loop observes these
        # every step/token, so skip the registry name lookup there
        self._h_ttft = self.metrics.histogram("ttft_s")
        self._h_itl = self.metrics.histogram("inter_token_s")
        self._h_step = self.metrics.histogram("step_wall_s")
        # last-emitted counter-track / time-series values: both are step
        # functions (a reader holds the previous value until the next
        # sample), so re-recording an unchanged value adds bytes and
        # allocations but no information — emit deltas only
        self._last_counters: dict[str, tuple] = {}
        self._last_series: dict = {}

    def _now(self) -> float:
        return self._clock()

    # -- request lifecycle ------------------------------------------------------

    def on_enqueue(self, rid: int, prompt_len: int, max_new: int,
                   step: int) -> None:
        tid = self.tracer.request_track(rid)
        rec = _Req(tid, self._now())
        self._reqs[rid] = rec
        self.tracer.instant(tid, "enqueue", step=step,
                            prompt_len=prompt_len, max_new=max_new)
        rec.queue_span = self.tracer.begin(tid, "queue", step=step)
        self.metrics.inc("requests_enqueued")

    def _reopen_queue(self, rec: _Req, step: int, reason: str) -> None:
        rec.queue_since_s = self._now()
        rec.queue_span = self.tracer.begin(rec.tid, "queue", step=step,
                                           reason=reason)

    def on_admit(self, rid: int, row: int, step: int) -> None:
        rec = self._reqs.get(rid)
        if rec is None:
            return
        if rec.queue_span:
            self.tracer.end(rec.queue_span, row=row, step=step)
            rec.queue_span = 0
        self.metrics.observe("queue_wait_s", self._now() - rec.queue_since_s)
        rec.active_span = self.tracer.begin(rec.tid, "active", row=row,
                                            step=step)
        self.metrics.inc("admissions")

    def prefill_span(self, rid: Optional[int], n_tokens: int):
        tid = (self._reqs[rid].tid if rid in self._reqs else ENGINE_TRACK)
        return self.tracer.span(tid, "prefill", tokens=n_tokens)

    @contextlib.contextmanager
    def chunk_span(self, rid: Optional[int], n_tokens: int):
        """One chunked-prefill dispatch (async: host dispatch time) —
        traced as a span AND observed into the prefill_chunk_s histogram."""
        tid = (self._reqs[rid].tid if rid in self._reqs else ENGINE_TRACK)
        t0 = self._now()
        with self.tracer.span(tid, "prefill_chunk", tokens=n_tokens):
            yield
        self.metrics.observe("prefill_chunk_s", self._now() - t0)

    def on_tokens(self, rid: int, n: int, step: int) -> None:
        """`n` tokens of request `rid` were emitted at this instant
        (n > 1 for an accepted speculative window)."""
        rec = self._reqs.get(rid)
        if rec is None or n <= 0:
            return
        now = self._clock()
        if rec.first_s is None:
            rec.first_s = now
            self._h_ttft.observe(now - rec.enqueue_s)
            self.tracer.instant(rec.tid, "first_token", step=step)
        elif rec.last_s is not None:
            # n tokens arrived in one dispatch (accepted spec window):
            # each is credited the mean gap
            self._h_itl.observe_n((now - rec.last_s) / n, n)
        rec.last_s = now
        rec.tokens += n
        c = self.metrics.counters
        c["tokens_emitted"] = c.get("tokens_emitted", 0) + n

    def on_preempt(self, rid: int, step: int, reason: str) -> None:
        """Preemption/heal requeue: the active span ends, a NEW queue
        span opens on the same lane (request-id continuity)."""
        rec = self._reqs.get(rid)
        if rec is None:
            return
        if rec.active_span:
            self.tracer.end(rec.active_span, outcome="preempted",
                            reason=reason)
            rec.active_span = 0
        self.tracer.instant(rec.tid, "preempt", step=step, reason=reason)
        self.tracer.instant(SCHED_TRACK, "preempt", req=rid, step=step,
                            reason=reason)
        self.metrics.inc(f"preempt_{reason}")
        self._reopen_queue(rec, step, reason)

    def _finish(self, rid: int, step: int, outcome: str) -> None:
        rec = self._reqs.get(rid)
        if rec is None or rec.done:
            return
        if rec.queue_span:                  # failed while queued
            self.tracer.end(rec.queue_span, outcome=outcome)
            rec.queue_span = 0
        if rec.active_span:
            self.tracer.end(rec.active_span, outcome=outcome, step=step)
            rec.active_span = 0
        self.tracer.instant(rec.tid, outcome, step=step, tokens=rec.tokens)
        self.metrics.inc(f"requests_{outcome}")
        self.metrics.observe("request_latency_s",
                             self._now() - rec.enqueue_s)
        rec.done = True

    def on_complete(self, rid: int, step: int) -> None:
        self._finish(rid, step, "completed")

    def on_failed(self, rid: int, step: int) -> None:
        self._finish(rid, step, "failed")

    def on_handoff(self, rid: int, step: int, kind: str) -> None:
        """Request leaves THIS array (fleet migration / array-loss
        drain): close its open spans on this pid — the lifecycle
        continues on the destination array's lane. No latency is
        observed here (the request is not finished, just elsewhere)."""
        rec = self._reqs.get(rid)
        if rec is None or rec.done:
            return
        if rec.queue_span:
            self.tracer.end(rec.queue_span, outcome=kind)
            rec.queue_span = 0
        if rec.active_span:
            self.tracer.end(rec.active_span, outcome=kind, step=step)
            rec.active_span = 0
        self.tracer.instant(rec.tid, kind, step=step, tokens=rec.tokens)
        self.metrics.inc(f"requests_{kind}")
        rec.done = True

    # -- engine phases ----------------------------------------------------------

    def step_span(self, step: int, kind: str):
        return self.tracer.span(ENGINE_TRACK, "step", step=step, kind=kind)

    def phase_span(self, name: str, **args):
        return self.tracer.span(ENGINE_TRACK, name, **args)

    def on_step_done(self, step: int, dt_s: float) -> None:
        self._h_step.observe(dt_s)
        self.metrics.inc("steps")

    def on_spec_round(self, accepted: int, rows: int, step: int) -> None:
        self.metrics.observe("accepted_per_round", accepted)
        self.metrics.inc("spec_rounds")

    def on_queue_depth(self, depth: int) -> None:
        self.metrics.gauge("queue_depth", depth)

    def on_placement(self, rid: int, array_id: int, policy: str, kind: str,
                     step: int) -> None:
        """Fleet placement decision landing a request on THIS array's
        scheduler lane: kind = admit | migrate | drain."""
        self.tracer.instant(SCHED_TRACK, "placement", req=rid,
                            array=array_id, policy=policy, kind=kind,
                            step=step)
        self.metrics.inc(f"placement_{kind}")

    # -- refresh / store maintenance -------------------------------------------

    def on_refresh_pass(self, n_units: int, step: int) -> None:
        if n_units:
            self.tracer.instant(REFRESH_TRACK, "refresh_pass", step=step,
                                units=n_units)
            self.metrics.inc("refresh_units", n_units)

    def store_event(self, kind: str, unit: str, step: int) -> None:
        """Mode transitions / refresh outcomes from the state stores:
        augment | promote | restamp | decommission | demote | cow
        (demote = shared-prefix page pressed Normal -> Augmented instead
        of evicted; cow = copy-on-write divergence page copy)."""
        self.tracer.instant(REFRESH_TRACK, kind, unit=unit, step=step)
        self.metrics.inc(f"store_{kind}")

    def on_prefix(self, kind: str, rid: int, tokens: int, step: int) -> None:
        """Prefix-cache outcome for a request admission: kind =
        hit | miss, with the matched token count on hits."""
        self.tracer.instant(SCHED_TRACK, f"prefix_{kind}", req=rid,
                            tokens=tokens, step=step)
        self.metrics.inc(f"prefix_{kind}")
        if tokens:
            self.metrics.inc("prefix_tokens_shared", tokens)

    # -- faults / healing --------------------------------------------------------

    def fault_span(self, step: int):
        return self.tracer.span(FAULT_TRACK, "fault_pass", step=step)

    def on_fault(self, kind: str, detail: str, step: int) -> None:
        """inject | detect | heal_scrub | heal_recompute | uncorrectable
        | array_loss instants on the fault lane."""
        self.tracer.instant(FAULT_TRACK, kind, unit=detail, step=step)
        self.metrics.inc(f"fault_{kind}")

    # -- sampling ---------------------------------------------------------------

    def wants_sample(self, step: int) -> bool:
        return self.metrics_on and step % self.sample_every == 0

    def sample(self, step: int, payload: dict) -> None:
        """Time-series tick: pool occupancy, Normal-vs-Augmented mode
        mix, queue depth, refresh debt, energy-ledger group totals —
        sampled into bounded series AND perfetto counter tracks (both
        delta-compressed: unchanged values re-record nothing)."""
        prev = self._last_series
        metrics_sample = self.metrics.sample
        for k, v in payload.items():
            if prev.get(k) != v:
                prev[k] = v
                metrics_sample(k, step, v)
        last = self._last_counters
        mix = (payload.get("mode_normal", 0),
               payload.get("mode_augmented", 0))
        if last.get("mode_mix") != mix:
            last["mode_mix"] = mix
            self.tracer.counter("mode_mix", normal=mix[0],
                                augmented=mix[1])
        occ = round(payload.get("pool_occupancy", 0.0), 4)
        if last.get("pool_occupancy") != occ:
            last["pool_occupancy"] = occ
            self.tracer.counter("pool_occupancy", frac=occ)
        depth = payload.get("queue_depth", 0)
        if last.get("queue_depth") != depth:
            last["queue_depth"] = depth
            self.tracer.counter("queue_depth", depth=depth)

    # -- export / summary --------------------------------------------------------

    def describe(self) -> dict:
        """Pure snapshot for stats()["obs"] — calling it never mutates
        the planes (stats() idempotence)."""
        m = self.metrics.describe()
        return {
            "enabled": True,
            "trace": self.trace_on,
            "metrics": self.metrics_on,
            "sample_every": self.sample_every,
            "trace_events": len(self.tracer.events),
            "open_spans": self.tracer.open_spans(),
            "requests_tracked": len(self._reqs),
            **m,
        }

    def export_trace(self, path: str) -> dict:
        from repro_torch.obs.export import write_chrome_trace
        return write_chrome_trace(self.tracer, path)

    def export_metrics(self, path: str) -> str:
        from repro_torch.obs.export import write_prometheus
        return write_prometheus(self.metrics, path)


class NullEngineObs:
    """Disabled observability: every hook is a constant no-op (shared
    nullcontext for the span sites), so the instrumented engine pays one
    attribute lookup + empty call per hook — unmeasurable against a
    device dispatch. `make_engine_obs` returns this unless a plane is
    switched on."""

    enabled = False
    trace_on = False
    metrics_on = False

    def on_enqueue(self, rid, prompt_len, max_new, step):
        pass

    def on_admit(self, rid, row, step):
        pass

    def prefill_span(self, rid, n_tokens):
        return _NULL_CTX

    def chunk_span(self, rid, n_tokens):
        return _NULL_CTX

    def on_tokens(self, rid, n, step):
        pass

    def on_preempt(self, rid, step, reason):
        pass

    def on_complete(self, rid, step):
        pass

    def on_failed(self, rid, step):
        pass

    def on_handoff(self, rid, step, kind):
        pass

    def step_span(self, step, kind):
        return _NULL_CTX

    def phase_span(self, name, **args):
        return _NULL_CTX

    def on_step_done(self, step, dt_s):
        pass

    def on_spec_round(self, accepted, rows, step):
        pass

    def on_queue_depth(self, depth):
        pass

    def on_placement(self, rid, array_id, policy, kind, step):
        pass

    def on_refresh_pass(self, n_units, step):
        pass

    def store_event(self, kind, unit, step):
        pass

    def on_prefix(self, kind, rid, tokens, step):
        pass

    def fault_span(self, step):
        return _NULL_CTX

    def on_fault(self, kind, detail, step):
        pass

    def wants_sample(self, step):
        return False

    def sample(self, step, payload):
        pass

    def describe(self):
        return {"enabled": False, "trace": False, "metrics": False}

    def export_trace(self, path):
        raise ValueError(
            "tracing is disabled on this engine — construct it with "
            "trace=True (or cfg.amc.trace=True / --trace-out) first")

    def export_metrics(self, path):
        raise ValueError(
            "metrics are disabled on this engine — construct it with "
            "metrics=True (or cfg.amc.metrics=True / --metrics-out) first")


NULL_OBS = NullEngineObs()


def make_engine_obs(amc_cfg, *, clock=None, pid=0, process="amc-serve",
                    epoch=None, registry=None):
    """AMCConfig -> the engine's obs facade (Null unless a plane is on).
    `pid`/`process`/`epoch`/`registry` are the fleet hooks: per-array
    trace lanes on one time base, one shared metrics registry."""
    if not (amc_cfg.trace or amc_cfg.metrics):
        return NULL_OBS
    return EngineObs(trace=amc_cfg.trace, metrics=amc_cfg.metrics,
                     sample_every=amc_cfg.obs_sample_every, clock=clock,
                     pid=pid, process=process, epoch=epoch,
                     registry=registry)
