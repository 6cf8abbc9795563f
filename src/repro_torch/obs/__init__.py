"""Observability layer (PyTorch port of `repro.obs`).

  trace      `Tracer` — spans and instants in *simulated* time on
             per-device, server and controller tracks (`--trace-out`).
  perfetto   `PerfettoExporter` — Chrome-trace/Perfetto JSON, plus the
             `validate_chrome_trace` / `validate_metrics_json` schema gates.
  metrics    `MetricsRegistry` — counters, gauges and fixed-bucket
             histograms, host-side only (no wall clock or RNG).
  profiling  `annotate()`, the port's one span on the host's clock:
             `PhaseTimers` totals (`--metrics-out`'s `time.*`) and, with
             `set_profiling(True)` or REPRO_PROFILE=1, torch.profiler and
             NVTX ranges (the span tree is listed there).
  log        stderr status lines, so JSON on stdout stays clean.

The simulator emits at the same seams as `repro`'s, so on identical
inputs the two packages record identical event lists.
"""
from repro_torch.obs import log
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, STALENESS_BUCKETS)
from repro_torch.obs.perfetto import (PerfettoExporter, validate_chrome_trace,
                                      validate_metrics_json)
from repro_torch.obs.profiling import (PhaseTimers, annotate,
                                       profiling_enabled, set_profiling)
from repro_torch.obs.trace import (TraceEvent, Tracer, CONTROLLER_TRACK,
                                   SERVER_TRACK, device_track)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "STALENESS_BUCKETS",
    "PerfettoExporter", "validate_chrome_trace", "validate_metrics_json",
    "PhaseTimers", "annotate", "profiling_enabled", "set_profiling",
    "TraceEvent", "Tracer",
    "CONTROLLER_TRACK", "SERVER_TRACK", "device_track", "log",
]
