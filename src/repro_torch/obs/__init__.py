"""Observability plane: tracing, metrics, exporters (DESIGN.md SS12)."""
from repro_torch.obs.export import (validate_chrome_trace,
                              validate_chrome_trace_file,
                              write_chrome_trace, write_prometheus)
from repro_torch.obs.hooks import NULL_OBS, EngineObs, NullEngineObs, \
    make_engine_obs
from repro_torch.obs.metrics import LogHistogram, MetricsRegistry, TimeSeries
from repro_torch.obs.trace import (ENGINE_TRACK, FAULT_TRACK, REFRESH_TRACK,
                             REQ_TRACK_BASE, SCHED_TRACK, NullTracer,
                             Tracer)

__all__ = [
    "EngineObs", "NullEngineObs", "NULL_OBS", "make_engine_obs",
    "Tracer", "NullTracer", "MetricsRegistry", "LogHistogram",
    "TimeSeries", "write_chrome_trace", "write_prometheus",
    "validate_chrome_trace", "validate_chrome_trace_file",
    "ENGINE_TRACK", "SCHED_TRACK", "REFRESH_TRACK", "FAULT_TRACK",
    "REQ_TRACK_BASE",
]
