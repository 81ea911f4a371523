"""Counters, gauges, log-bucketed histograms and bounded time series.

`MetricsRegistry` is the host-side metrics plane `ServeEngine` folds into
`stats()["obs"]` and dumps as Prometheus text exposition:

  * `Counter` / gauge values: plain monotonic / last-value numbers.
  * `LogHistogram`: geometric (log-spaced) buckets — the natural shape
    for latencies spanning microseconds to seconds. Percentiles are
    reported as the upper edge of the containing bucket, so two
    estimates of the same distribution agree "within one bucket" by
    construction (the acceptance check the trace/metrics cross-
    validation tests use).
  * `TimeSeries`: (step, value) samples under a hard memory bound —
    when full, every other sample is dropped and the keep-stride
    doubles, so a series keeps uniform coverage of the whole run at
    bounded cost (mode-mix timelines, pool occupancy, refresh debt,
    energy-ledger group rates).

Everything here is plain Python/host-side: nothing is traced, nothing
touches the jitted hot path.
"""
from __future__ import annotations

import math
from typing import Optional

# default latency bucketing: 1us .. ~87s at 5 buckets per decade
_LAT_LO = 1e-6
_LAT_GROWTH = 10.0 ** 0.2
_LAT_N = 40


class LogHistogram:
    """Geometric-bucket histogram: bucket i covers
    [lo * growth**(i-1), lo * growth**i); values below `lo` land in
    bucket 0, values past the top land in the overflow bucket."""

    def __init__(self, lo: float = _LAT_LO, growth: float = _LAT_GROWTH,
                 n_buckets: int = _LAT_N):
        assert lo > 0 and growth > 1 and n_buckets >= 1
        self.lo, self.growth, self.n_buckets = lo, growth, n_buckets
        self._log_g = math.log(growth)
        self.counts = [0] * (n_buckets + 1)     # +1 overflow
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def bucket_index(self, value: float) -> int:
        if value < self.lo:
            return 0
        i = int(math.log(value / self.lo) / self._log_g) + 1
        return min(i, self.n_buckets)

    def bucket_edge(self, i: int) -> float:
        """Upper edge of bucket i (inf for the overflow bucket)."""
        if i >= self.n_buckets:
            return math.inf
        return self.lo * self.growth ** i

    def observe(self, value: float) -> None:
        self.counts[self.bucket_index(value)] += 1
        self.count += 1
        self.sum += value
        self.min = value if self.min is None else min(self.min, value)
        self.max = value if self.max is None else max(self.max, value)

    def observe_n(self, value: float, n: int) -> None:
        """`n` observations of the same value in one bucket update (e.g.
        the per-token gap of an accepted speculative window)."""
        if n <= 0:
            return
        self.counts[self.bucket_index(value)] += n
        self.count += n
        self.sum += value * n
        self.min = value if self.min is None else min(self.min, value)
        self.max = value if self.max is None else max(self.max, value)

    def percentile(self, p: float) -> float:
        """Upper edge of the bucket holding the p-th percentile (0 with
        no observations) — a one-bucket-granular estimate."""
        if self.count == 0:
            return 0.0
        target = p / 100.0 * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= target and c:
                edge = self.bucket_edge(i)
                return self.max if math.isinf(edge) else edge
        return self.max

    def within_one_bucket(self, a: float, b: float) -> bool:
        """Whether two values land in the same or adjacent buckets —
        the agreement criterion for trace-derived vs metrics-derived
        latency estimates."""
        return abs(self.bucket_index(a) - self.bucket_index(b)) <= 1

    def summary(self) -> dict:
        return {
            "count": self.count,
            "sum": self.sum,
            "mean": self.sum / self.count if self.count else 0.0,
            "min": self.min if self.min is not None else 0.0,
            "max": self.max if self.max is not None else 0.0,
            "p50": self.percentile(50),
            "p90": self.percentile(90),
            "p99": self.percentile(99),
        }


class TimeSeries:
    """Bounded (t, value) sampler: at `max_samples` the series drops
    every other retained sample and doubles its keep-stride, preserving
    uniform coverage of an arbitrarily long run in fixed memory."""

    def __init__(self, max_samples: int = 512):
        assert max_samples >= 4
        self.max_samples = max_samples
        self.samples: list[tuple] = []
        self._stride = 1
        self._seen = 0

    def sample(self, t, value) -> None:
        if self._seen % self._stride == 0:
            if len(self.samples) >= self.max_samples:
                self.samples = self.samples[::2]
                self._stride *= 2
                if self._seen % self._stride != 0:
                    self._seen += 1
                    return
            self.samples.append((t, value))
        self._seen += 1

    def last(self):
        return self.samples[-1][1] if self.samples else None

    def describe(self) -> dict:
        return {"n_samples": len(self.samples), "stride": self._stride,
                "last": self.last()}


class MetricsRegistry:
    """Name -> counter/gauge/histogram/series maps with auto-creation.
    `describe()` is a pure snapshot (no mutation — `stats()` must be
    idempotent); `prometheus_text()` is the text exposition dump."""

    def __init__(self, *, series_max_samples: int = 512):
        self.counters: dict[str, float] = {}
        self.gauges: dict[str, float] = {}
        self.histograms: dict[str, LogHistogram] = {}
        self.series: dict[str, TimeSeries] = {}
        self._series_max = series_max_samples

    def inc(self, name: str, n: float = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def gauge(self, name: str, value: float) -> None:
        self.gauges[name] = value

    def histogram(self, name: str) -> LogHistogram:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = LogHistogram()
        return h

    def observe(self, name: str, value: float) -> None:
        self.histogram(name).observe(value)

    def sample(self, name: str, t, value) -> None:
        s = self.series.get(name)
        if s is None:
            s = self.series[name] = TimeSeries(self._series_max)
        s.sample(t, value)

    def describe(self) -> dict:
        return {
            "counters": dict(self.counters),
            "gauges": dict(self.gauges),
            "histograms": {k: h.summary()
                           for k, h in sorted(self.histograms.items())},
            "timeseries": {k: s.describe()
                           for k, s in sorted(self.series.items())},
        }

    def dump_timeseries(self) -> dict:
        """Full sampled timelines (BENCH_obs / offline analysis)."""
        return {k: list(s.samples) for k, s in sorted(self.series.items())}

    # -- Prometheus text exposition -------------------------------------------

    def prometheus_text(self) -> str:
        out: list[str] = []
        for name, v in sorted(self.counters.items()):
            m = _prom_name(name)
            out += [f"# TYPE {m} counter", f"{m} {_prom_num(v)}"]
        for name, v in sorted(self.gauges.items()):
            m = _prom_name(name)
            out += [f"# TYPE {m} gauge", f"{m} {_prom_num(v)}"]
        for name, h in sorted(self.histograms.items()):
            m = _prom_name(name)
            out.append(f"# TYPE {m} histogram")
            cum = 0
            for i, c in enumerate(h.counts[:-1]):
                cum += c
                if not c:
                    continue            # sparse dump: skip empty buckets
                edge = _prom_num(h.bucket_edge(i))
                out.append(f'{m}_bucket{{le="{edge}"}} {cum}')
            out.append(f'{m}_bucket{{le="+Inf"}} {h.count}')
            out.append(f"{m}_sum {_prom_num(h.sum)}")
            out.append(f"{m}_count {h.count}")
        return "\n".join(out) + "\n"


def _prom_name(name: str) -> str:
    return "amc_" + "".join(c if c.isalnum() or c == "_" else "_"
                            for c in name)


def _prom_num(v: float) -> str:
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))
