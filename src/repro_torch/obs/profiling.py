"""Profiling hooks: the port's one span primitive, and the launch
profilers' capture and summary.

`annotate(name, timers=None, key=None)` opens one span. With profiling
off (the default) and no timers it returns a shared null context: one
module-level predicate per call site, no allocation. With `timers` (a
`PhaseTimers`) it adds the span's host seconds and one call to
`timers` under `key` (default: `name`). With profiling on
(`set_profiling(True)`, or REPRO_PROFILE=1 in the environment) it opens
a `torch.profiler.record_function(name)` range and, with CUDA available,
an NVTX range of the same name (`torch.cuda.nvtx`), the counterpart of
the reference's `jax.profiler.TraceAnnotation`. A `torch.profiler`
capture then holds each span as a host row on kineto's clock, the clock
of its device rows, and Nsight Systems shows the NVTX ranges.

Operators: run any entry point with REPRO_PROFILE=1 under Nsight
Systems, or inside `torch.profiler.profile()` (`device_profile()`), to
see the span tree. The spans and their nesting:

  AFLSimulator.run (core/simulator.py)
    sim.schedule        the event loop's own work on each popped event:
                        heap pops, down checks, re-plans, upload
                        outcomes, pushes; it never holds a phase
    sim.heap_drain      a drained batch of starts (batched engine)
      sim.draw          each start's batches and seed, the buckets, the
                        global model's upload
      sim.dispatch      every chunk of the drain, enqueued
        sim.stage       a chunk's batches stacked and copied to the card
        local_round     a chunk's (or one device's) local round; on a
                        CUDA device, from a chunk shape's second use
                        on, the replay of its CUDA graph, which holds
                        all k steps and so has no step spans
          local_round.step   one optimizer step of an eager round
        sim.compress    the chunk's rows compressed
      sim.collect       the payload pulls and their unpacking
      sim.schedule      the drain's arrival pushes
    sim.dispatch        one device's cycle (sequential engine): sim.stage,
                        local_round, sim.compress
    sim.aggregate       the server: sanitizer and Eq. 6 on the host
    sim.eval            the global model's accuracy and loss
  make_pod_round_step (dist/steps.py)
    pod.round           one datacenter round
      local_round       one pod's local round (local_round.step each step)
        local_round.step
          lm.layer.ssm, lm.layer.attention, lm.layer.parallel
                        one LM layer's forward (`models/transformer.py`,
                        LM._stack; not its backward, nor a remat'd
                        recompute), named by its mixer: Mamba-2
                        (mamba2-780m, granite-4.0-h's Mamba-2 layers),
                        attention (the attention families, granite's
                        attention layers) or both in parallel (hymba);
                        the same spans in any LM call
      pod.sync          the call of the cross-pod sync, whatever wraps it
        pod_sync.compact_pack, pod_sync.all_gather, pod_sync.scatter_apply
                        (compact wire) or pod_sync.dense (dense wire),
                        in `dist/collectives.py`

The simulator's phases `heap_drain`, `dispatch`, `collect`, `aggregate`
and `eval` are also `PhaseTimers` keys (`--metrics-out`'s `time.*`).
`PhaseTimers` totals are host time: kernels are enqueued
asynchronously, so a span ends before its device work unless something
in it synchronises.

`device_profile()` and `device_breakdown(prof, wall_s)` are the launch
profilers' shared capture and summary: device-busy seconds, the idle
share of a wall time, and the top device entries. `time_ms(fn)` is the
per-launch device time of one kernel call (`chip_smoke.py`).
"""
from __future__ import annotations

import contextlib
import os
import statistics
import time

_PROFILE = os.environ.get("REPRO_PROFILE", "") not in ("", "0", "false")
_NULL_CTX = contextlib.nullcontext()


def set_profiling(on: bool) -> None:
    """Globally enable/disable the spans' profiler and NVTX ranges."""
    global _PROFILE
    _PROFILE = bool(on)


def profiling_enabled() -> bool:
    return _PROFILE


def annotate(name: str, timers: PhaseTimers | None = None,
             key: str | None = None):
    """The span `name` as a context manager: host seconds and a call
    added to `timers[key or name]` when `timers` is given, and a
    `torch.profiler.record_function(name)` range (with an NVTX range of
    that name when CUDA is available) when profiling is enabled; a
    shared no-op context when neither is."""
    if timers is not None:
        return _timed(name, timers, name if key is None else key)
    if not _PROFILE:
        return _NULL_CTX
    return _range(name)


def _range(name: str):
    import torch
    if not torch.cuda.is_available():
        return torch.profiler.record_function(name)
    return _nvtx_region(name)


@contextlib.contextmanager
def _nvtx_region(name: str):
    import torch
    with torch.cuda.nvtx.range(name), torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def _timed(name: str, timers: PhaseTimers, key: str):
    t0 = time.perf_counter()
    try:
        with _range(name) if _PROFILE else _NULL_CTX:
            yield
    finally:
        timers.add(key, time.perf_counter() - t0)


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
    """Named wall-clock accumulators: `with timers.phase("drain"): ...`
    is `annotate("drain", timers)`."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.calls: dict[str, int] = {}

    def phase(self, name: str):
        return annotate(name, self)

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
