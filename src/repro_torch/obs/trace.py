"""Structured span/event tracer for the serving stack.

One `Tracer` per engine records the full request lifecycle (enqueue ->
admit -> prefill chunks -> decode / spec-verify rounds -> preempt /
recompute -> refresh -> fault inject / detect / heal -> complete or
failed) as Chrome-trace-event-compatible records:

  * spans        complete "X" events with a start timestamp and duration
                 (begin()/end() across function boundaries, or the
                 `span()` context manager for lexically scoped phases)
  * instants     "i" events (token emission, fault detection, refresh)
  * counters     "C" events (mode-mix / occupancy timelines perfetto
                 renders as graph tracks)

Tracks are integer `tid`s inside one `pid`: fixed tracks for the engine
step loop, the scheduler, the refresh clock and the fault/heal machinery,
plus one track per request (`REQ_TRACK_BASE + id`) so a request's whole
life — including preempt/requeue hops between rows — reads as one
horizontal lane in perfetto. `NullTracer` is the zero-overhead disabled
mode: every method is a constant-return no-op and the engine shares one
`nullcontext` for its span sites.

Timestamps are host-side `perf_counter` microseconds from the tracer's
construction. Dispatches are asynchronous, so a dispatch span measures
host-side dispatch+bookkeeping time; device compute is only observed
where the engine genuinely blocks (argmax readback) — documented, not
hidden.
"""
from __future__ import annotations

import contextlib
import time
from typing import Optional

# fixed tracks (tid); request tracks live at REQ_TRACK_BASE + request id
ENGINE_TRACK = 0
SCHED_TRACK = 1
REFRESH_TRACK = 2
FAULT_TRACK = 3
REQ_TRACK_BASE = 10

TRACK_NAMES = {
    ENGINE_TRACK: "engine/steps",
    SCHED_TRACK: "scheduler",
    REFRESH_TRACK: "refresh",
    FAULT_TRACK: "faults/heal",
}

_NULL_CTX = contextlib.nullcontext()


class _LexSpan:
    """Lexically-scoped span: a slotted context manager that records one
    complete "X" event on exit. Cheaper than a generator-based
    contextmanager on the per-step hot path, and it cannot leak an open
    span — only begin()/end() pairs participate in open_spans()."""

    __slots__ = ("_tr", "_tid", "_name", "_args", "_ts")

    def __init__(self, tr, tid, name, args):
        self._tr, self._tid = tr, tid
        self._name, self._args = name, args

    def __enter__(self):
        self._ts = self._tr.now_us()
        return self

    def __exit__(self, *exc):
        tr = self._tr
        tr.events.append({"name": self._name, "ph": "X", "ts": self._ts,
                          "dur": max(tr.now_us() - self._ts, 0.0),
                          "pid": tr.pid, "tid": self._tid,
                          "args": self._args})
        return False


class Tracer:
    """Recording tracer (enabled mode)."""

    enabled = True

    def __init__(self, *, clock=None, pid: int = 0,
                 epoch: Optional[float] = None,
                 process: str = "amc-serve"):
        self._clock = clock if clock is not None else time.perf_counter
        # `epoch` (clock units) lets several tracers share one time base:
        # an ArrayFleet passes the same epoch to every array's tracer so
        # the merged multi-pid trace has comparable timestamps
        self._t0 = self._clock() if epoch is None else epoch
        self.pid = pid
        self.process = process
        self.events: list[dict] = []
        self._open: dict[int, tuple] = {}   # span id -> (tid, name, ts, args)
        self._next_id = 0
        self._track_names: dict[int, str] = dict(TRACK_NAMES)

    # -- clock ---------------------------------------------------------------

    def now_us(self) -> float:
        return (self._clock() - self._t0) * 1e6

    # -- tracks --------------------------------------------------------------

    def name_track(self, tid: int, name: str) -> None:
        self._track_names[tid] = name

    def request_track(self, rid: int) -> int:
        tid = REQ_TRACK_BASE + rid
        if tid not in self._track_names:
            self._track_names[tid] = f"req {rid}"
        return tid

    # -- spans ---------------------------------------------------------------

    def begin(self, tid: int, name: str, **args) -> int:
        """Open a span; returns the id `end()` closes it with."""
        self._next_id += 1
        self._open[self._next_id] = (tid, name, self.now_us(), args)
        return self._next_id

    def end(self, span_id: int, **args) -> None:
        tid, name, ts, a0 = self._open.pop(span_id)
        if args:
            a0 = {**a0, **args}
        self.events.append({"name": name, "ph": "X", "ts": ts,
                            "dur": max(self.now_us() - ts, 0.0),
                            "pid": self.pid, "tid": tid, "args": a0})

    def span(self, tid: int, name: str, **args) -> _LexSpan:
        return _LexSpan(self, tid, name, args)

    def open_spans(self) -> int:
        return len(self._open)

    # -- instants / counters ---------------------------------------------------

    def instant(self, tid: int, name: str, **args) -> None:
        self.events.append({"name": name, "ph": "i", "ts": self.now_us(),
                            "s": "t", "pid": self.pid, "tid": tid,
                            "args": args})

    def counter(self, name: str, **values) -> None:
        """Perfetto counter track sample (mode mix / occupancy timeline)."""
        self.events.append({"name": name, "ph": "C", "ts": self.now_us(),
                            "pid": self.pid, "tid": ENGINE_TRACK,
                            "args": values})

    # -- export ----------------------------------------------------------------

    def chrome_trace(self) -> dict:
        """Perfetto-loadable Chrome trace JSON object. Spans still open at
        export are closed AT the export timestamp and flagged
        (`open_at_export`) so the artifact stays schema-valid mid-run;
        a clean end-of-run export has none (tests pin open_spans()==0)."""
        now = self.now_us()
        events = list(self.events)
        for tid, name, ts, args in self._open.values():
            events.append({"name": name, "ph": "X", "ts": ts,
                           "dur": max(now - ts, 0.0), "pid": self.pid,
                           "tid": tid,
                           "args": {**args, "open_at_export": True}})
        events.sort(key=lambda e: e["ts"])
        meta = [{"name": "process_name", "ph": "M", "pid": self.pid,
                 "tid": 0, "args": {"name": self.process}}]
        meta += [{"name": "thread_name", "ph": "M", "pid": self.pid,
                  "tid": tid, "args": {"name": name}}
                 for tid, name in sorted(self._track_names.items())]
        # thread_sort_index keeps the fixed tracks above the request lanes
        meta += [{"name": "thread_sort_index", "ph": "M", "pid": self.pid,
                  "tid": tid, "args": {"sort_index": tid}}
                 for tid in sorted(self._track_names)]
        return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


class NullTracer:
    """Disabled mode: every method is a no-op (shared nullcontext for
    span sites), so tracing costs one attribute lookup + call when off."""

    enabled = False
    events = ()        # len()-able like the recording tracer's list

    def now_us(self) -> float:
        return 0.0

    def name_track(self, tid: int, name: str) -> None:
        pass

    def request_track(self, rid: int) -> int:
        return 0

    def begin(self, tid: int, name: str, **args) -> int:
        return 0

    def end(self, span_id: int, **args) -> None:
        pass

    def span(self, tid: int, name: str, **args):
        return _NULL_CTX

    def open_spans(self) -> int:
        return 0

    def instant(self, tid: int, name: str, **args) -> None:
        pass

    def counter(self, name: str, **values) -> None:
        pass

    def chrome_trace(self) -> dict:
        return {"traceEvents": [], "displayTimeUnit": "ms"}
