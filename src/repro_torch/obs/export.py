"""Trace / metrics file exporters + Chrome-trace schema validation.

`write_chrome_trace` dumps a `Tracer` as perfetto-loadable Chrome trace
JSON; `write_prometheus` dumps a `MetricsRegistry` as text exposition.
`validate_chrome_trace` is the schema check the tests and the CI trace
artifact step run: it returns a list of problems (empty == valid) instead
of raising, so callers can report everything wrong at once.
"""
from __future__ import annotations

import json

_PHASES = {"X", "i", "C", "M"}
_REQUIRED = ("name", "ph", "pid", "tid")


def write_chrome_trace(tracer, path: str) -> dict:
    obj = tracer.chrome_trace()
    with open(path, "w") as f:
        json.dump(obj, f)
    return obj


def merge_chrome_traces(objs: list) -> dict:
    """Merge several Chrome trace objects (one per array pid) into one:
    metadata events first, timed events re-sorted into one global
    monotonic timeline. Only meaningful when the tracers shared an epoch
    (ArrayFleet passes one), so their timestamps are comparable."""
    meta, timed = [], []
    for obj in objs:
        for e in obj.get("traceEvents", ()):
            (meta if e.get("ph") == "M" else timed).append(e)
    timed.sort(key=lambda e: e.get("ts", 0.0))
    return {"traceEvents": meta + timed, "displayTimeUnit": "ms"}


def write_prometheus(registry, path: str) -> str:
    text = registry.prometheus_text()
    with open(path, "w") as f:
        f.write(text)
    return text


def validate_chrome_trace(obj) -> list[str]:
    """Schema-validate a Chrome trace JSON object (or a parsed file).

    Checks: top-level shape, per-event required keys, known phase types,
    timestamp presence + global monotonic order of timed events, span
    durations >= 0, no span left open at export, and that every
    non-metadata track is named by a thread_name metadata event."""
    problems: list[str] = []
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        return ["top level must be an object with a traceEvents array"]
    events = obj["traceEvents"]
    if not isinstance(events, list):
        return ["traceEvents must be an array"]
    named_tracks = set()
    used_tracks = set()
    last_ts = None
    for i, e in enumerate(events):
        if not isinstance(e, dict):
            problems.append(f"event {i}: not an object")
            continue
        for k in _REQUIRED:
            if k not in e:
                problems.append(f"event {i}: missing key {k!r}")
        ph = e.get("ph")
        if ph not in _PHASES:
            problems.append(f"event {i}: unknown phase {ph!r}")
            continue
        if ph == "M":
            if e.get("name") == "thread_name":
                named_tracks.add((e.get("pid"), e.get("tid")))
            continue
        used_tracks.add((e.get("pid"), e.get("tid")))
        ts = e.get("ts")
        if not isinstance(ts, (int, float)):
            problems.append(f"event {i}: ts missing or non-numeric")
            continue
        if last_ts is not None and ts < last_ts:
            problems.append(
                f"event {i}: timestamps not monotonic ({ts} < {last_ts})")
        last_ts = ts
        if ph == "X":
            dur = e.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"event {i}: span with bad dur {dur!r}")
            if e.get("args", {}).get("open_at_export"):
                problems.append(
                    f"event {i}: span {e.get('name')!r} left open at export")
        if ph == "i" and e.get("s") not in ("t", "p", "g"):
            problems.append(f"event {i}: instant with bad scope "
                            f"{e.get('s')!r}")
    for track in sorted(used_tracks - named_tracks):
        problems.append(f"track pid/tid {track} has events but no "
                        f"thread_name metadata")
    return problems


def validate_chrome_trace_file(path: str) -> list[str]:
    try:
        with open(path) as f:
            obj = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        return [f"unreadable trace file: {e}"]
    return validate_chrome_trace(obj)
