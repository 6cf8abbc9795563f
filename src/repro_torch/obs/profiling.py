"""Profiling hooks: wall-clock phase timers and torch.profiler annotations.

`PhaseTimers` accumulates `time.perf_counter` wall-clock totals per named
phase (local-round dispatch, host aggregation, eval). perf_counter is
monotonic — immune to clock adjustments — and the timers live entirely
host-side. On a CUDA device a phase measures host time: kernels are
enqueued asynchronously, so a phase ends before its device work unless
something in it synchronises (the sequential engine's payload pull does).

`annotate(name)` wraps a host-side dispatch in
`torch.profiler.record_function` when profiling is switched on
(`set_profiling(True)` or REPRO_PROFILE=1 in the environment), so a
`torch.profiler.profile()` capture shows the local-round and compressor
dispatches as named regions; with CUDA available it also opens an NVTX
range of the same name (`torch.cuda.nvtx`), so Nsight Systems shows the
same regions (the counterpart of the reference's
`jax.profiler.TraceAnnotation`). When profiling is off it returns a
shared null context — one module-level predicate per call, no
allocation.

`device_profile()` and `device_breakdown(prof, wall_s)` are the launch
profilers' shared capture and summary: device-busy seconds, the idle
share of a wall time, and the top device entries. `time_ms(fn)` is the
per-launch device time of one kernel call (`chip_smoke.py`,
`launch/profile_kernels.py`).
"""
from __future__ import annotations

import contextlib
import os
import statistics
import time

_PROFILE = os.environ.get("REPRO_PROFILE", "") not in ("", "0", "false")
_NULL_CTX = contextlib.nullcontext()


def set_profiling(on: bool) -> None:
    """Globally enable/disable torch.profiler annotations."""
    global _PROFILE
    _PROFILE = bool(on)


def profiling_enabled() -> bool:
    return _PROFILE


def annotate(name: str):
    """Context manager: a `torch.profiler.record_function(name)` region,
    and an NVTX range of that name when CUDA is available, when profiling
    is enabled; else a shared no-op context."""
    if not _PROFILE:
        return _NULL_CTX
    import torch
    if not torch.cuda.is_available():
        return torch.profiler.record_function(name)
    return _nvtx_region(name)


@contextlib.contextmanager
def _nvtx_region(name: str):
    import torch
    with torch.cuda.nvtx.range(name), torch.profiler.record_function(name):
        yield


def device_profile():
    """A `torch.profiler.profile` context that records host and CUDA
    activity."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts)


def time_ms(fn, *, iters: int = 30, warmup: int = 5) -> float:
    """Median per-launch device time of `fn` in ms (CUDA events around
    each call, on the current CUDA device), with a 96 MB buffer zeroed
    before every timed call to flush the 50 MB L2. A sleep kernel first
    holds the stream so the host enqueues every launch ahead of the
    device: the events then time the device, not Python."""
    import torch
    flush = torch.empty(96 * 2 ** 20 // 4, dtype=torch.float32,
                        device="cuda")
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)       # ~25 ms at the SM clock
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def device_breakdown(prof, wall_s: float, top: int = 15) -> dict:
    """Summary of a finished `device_profile()` capture: `device_busy_s`
    (sum of the self times of its CUDA entries — kernels and copies, one
    stream), `idle_share` of `wall_s`, and the `top` device entries by time
    with their call counts. Busy time and idle share are None when the
    capture holds no device entry."""
    import torch
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        rows.append((e.key, e.count, us / 1e3))
    rows.sort(key=lambda r: -r[2])
    busy = sum(r[2] for r in rows) / 1e3
    return {"device_busy_s": busy if rows else None,
            "idle_share": (1.0 - busy / wall_s) if rows else None,
            "top": [{"name": n[:120], "calls": c, "ms": ms}
                    for n, c, ms in rows[:top]]}


class PhaseTimers:
    """Named wall-clock accumulators: `with timers.phase("drain"): ...`."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.calls: dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.calls[name] = self.calls.get(name, 0) + 1

    def add(self, name: str, seconds: float) -> None:
        """Manual accumulation for phases that cannot use a with-block."""
        self.totals[name] = self.totals.get(name, 0.0) + float(seconds)
        self.calls[name] = self.calls.get(name, 0) + 1

    def snapshot(self) -> dict:
        return {name: {"seconds": round(self.totals[name], 6),
                       "calls": self.calls[name]}
                for name in sorted(self.totals)}

    def export_to(self, metrics) -> None:
        """Mirror totals into a MetricsRegistry under the time.* namespace
        (wall-clock: never compared across runs)."""
        for name, total in self.totals.items():
            metrics.counter(f"time.{name}_s").value = total
            metrics.counter(f"time.{name}_calls").value = \
                float(self.calls[name])
