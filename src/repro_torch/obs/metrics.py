"""Streaming metrics: counters, gauges, fixed-bucket histograms.

Pure host-side Python with no wall clock and no RNG in the hot path —
observing a value is a dict lookup plus a bisect into *fixed* bucket
bounds, so metric updates can never perturb a simulation and both engines
produce identical registries on identical runs.

Naming convention used by the simulator:

  sim.*      engine-agnostic simulation metrics (cycles, staleness,
             wire-bit breakdown) — identical across engines
  faults.*   fault-counter totals mirrored from
             `AFLSimulator.fault_counters()` at run end, so exported JSON
             totals match `History.counters` exactly
  engine.*   execution-engine internals (bucket occupancy, chunk shapes,
             recompiles) — legitimately engine-specific
  time.*     wall-clock phase timers (profiling.PhaseTimers) — host noise,
             never compared across runs

`snapshot()` returns a plain JSON-ready dict; the cross-engine equality
test compares snapshots with the engine./time. sections stripped
(`snapshot(engine_agnostic=True)`).
"""
from __future__ import annotations

import bisect
import json


# staleness τ is a small integer; pow2-ish edges keep tails visible
STALENESS_BUCKETS = (0, 1, 2, 4, 8, 16, 32, 64)


class Counter:
    """Monotonic float total."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        self.value += v


class Gauge:
    """Last-write-wins scalar."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Fixed-bucket histogram. Bucket i counts values v with
    bounds[i-1] < v <= bounds[i]; the final bucket is the +inf overflow,
    so `counts` has len(bounds) + 1 entries and `sum(counts) == count`."""

    __slots__ = ("bounds", "counts", "count", "total")

    def __init__(self, bounds):
        b = tuple(float(x) for x in bounds)
        if not b or any(b[i] >= b[i + 1] for i in range(len(b) - 1)):
            raise ValueError(f"bucket bounds must be strictly increasing, "
                             f"got {bounds}")
        self.bounds = b
        self.counts = [0] * (len(b) + 1)
        self.count = 0
        self.total = 0.0

    def observe(self, v: float) -> None:
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.count += 1
        self.total += v

    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0


class MetricsRegistry:
    def __init__(self):
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    # ------------------------------------------------------------ get-or-make
    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter()
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge()
        return g

    def histogram(self, name: str, bounds=None) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            if bounds is None:
                raise ValueError(f"histogram {name!r} needs bucket bounds on "
                                 f"first use")
            h = self._histograms[name] = Histogram(bounds)
        return h

    # ---------------------------------------------------------------- totals
    def merge_totals(self, prefix: str, totals: dict) -> None:
        """Overwrite `<prefix><key>` counters with absolute totals — used to
        mirror `fault_counters()` so exported totals match History.counters
        exactly instead of re-deriving them incrementally."""
        for k, v in totals.items():
            self.counter(prefix + k).value = float(v)

    # -------------------------------------------------------------- snapshot
    def snapshot(self, *, engine_agnostic: bool = False) -> dict:
        def keep(name: str) -> bool:
            return not engine_agnostic or not (
                name.startswith("engine.") or name.startswith("time."))

        return {
            "counters": {k: c.value for k, c in sorted(self._counters.items())
                         if keep(k)},
            "gauges": {k: g.value for k, g in sorted(self._gauges.items())
                       if keep(k)},
            "histograms": {
                k: {"bounds": list(h.bounds), "counts": list(h.counts),
                    "count": h.count, "sum": h.total}
                for k, h in sorted(self._histograms.items()) if keep(k)},
        }

    def to_json(self, path: str, *, extra: dict | None = None) -> dict:
        doc = {"schema": "repro.obs.metrics/v1", **(extra or {}),
               **self.snapshot()}
        with open(path, "w") as f:
            json.dump(doc, f, indent=1)
            f.write("\n")
        return doc
