"""Failure / straggler models for fault-tolerance testing.

The AFL design is inherently failure-tolerant: a dead device's update is
simply absent from S^t and aggregation proceeds (Eq. 6 averages over
whatever arrived). These helpers let tests and benchmarks inject failures
and verify that property end-to-end, and model stragglers whose compute
slows mid-run (triggering controller re-plans).

`FailureSchedule` indexes its windows per device at construction: windows
are validated (`end > start`), overlap-merged, and stored as sorted
(starts, ends) arrays so `is_down` / `recovery_time` / `lost_in_flight`
are O(log W) binary searches instead of an O(W) scan per simulator event.
Merging makes chained downtime first-class: back-to-back windows
[2, 5) + [5, 7) are one outage [2, 7) — no *new* failure begins at t=5,
so an upload that started while the device was already down is not
double-counted as "lost in flight".
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class FailureWindow:
    device_id: int
    start: float
    end: float          # device is down for t in [start, end)


def merge_overlaps(windows: list[FailureWindow]) -> list[FailureWindow]:
    """Normalize a window list: per device, sort by start and coalesce
    overlapping or touching windows ([2,5)+[5,7) -> [2,7)). Raises
    ValueError on any window with `end <= start`."""
    for w in windows:
        if not w.end > w.start:
            raise ValueError(f"FailureWindow end <= start: {w}")
    by_dev: dict[int, list[FailureWindow]] = {}
    for w in windows:
        by_dev.setdefault(w.device_id, []).append(w)
    out: list[FailureWindow] = []
    for did in sorted(by_dev):
        merged: list[list[float]] = []
        for w in sorted(by_dev[did], key=lambda w: (w.start, w.end)):
            if merged and w.start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], w.end)
            else:
                merged.append([w.start, w.end])
        out.extend(FailureWindow(did, s, e) for s, e in merged)
    return out


@dataclasses.dataclass
class FailureSchedule:
    windows: list[FailureWindow]

    def __post_init__(self):
        self._index: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        for w in merge_overlaps(self.windows):
            self._index.setdefault(w.device_id, ([], []))
            self._index[w.device_id][0].append(w.start)
            self._index[w.device_id][1].append(w.end)
        self._index = {d: (np.asarray(s, np.float64), np.asarray(e, np.float64))
                       for d, (s, e) in self._index.items()}

    def merge_overlaps(self) -> "FailureSchedule":
        """A normalized copy whose `windows` are the merged outages."""
        return FailureSchedule(merge_overlaps(self.windows))

    def is_down(self, device_id: int, t: float) -> bool:
        idx = self._index.get(device_id)
        if idx is None:
            return False
        starts, ends = idx
        i = int(np.searchsorted(starts, t, side="right")) - 1
        return i >= 0 and t < ends[i]

    def lost_in_flight(self, device_id: int, start: float, finish: float) -> bool:
        """True if an outage begins inside (start, finish): the local
        round / upload is lost (node crash mid-round)."""
        idx = self._index.get(device_id)
        if idx is None:
            return False
        starts, _ = idx
        i = int(np.searchsorted(starts, start, side="right"))
        return i < len(starts) and starts[i] < finish

    def crash_recovery(self, device_id: int, start: float,
                       finish: float) -> float | None:
        """End of the outage that begins inside (start, finish), or None
        when no such outage exists. This is where a device whose in-flight
        upload was killed comes back up — `recovery_time(start)` would be
        wrong here, since the crash window opens *after* the cycle began."""
        idx = self._index.get(device_id)
        if idx is None:
            return None
        starts, ends = idx
        i = int(np.searchsorted(starts, start, side="right"))
        if i < len(starts) and starts[i] < finish:
            return float(ends[i])
        return None

    def recovery_time(self, device_id: int, t: float) -> float:
        """Earliest time >= t at which the device is back up. Chained
        windows are pre-merged, so this is one lookup."""
        t_rec = t
        idx = self._index.get(device_id)
        if idx is not None:
            starts, ends = idx
            i = int(np.searchsorted(starts, t, side="right")) - 1
            if i >= 0 and t < ends[i]:
                t_rec = float(ends[i])
        return max(t_rec, t + 1e-9)

    @staticmethod
    def random(num_devices: int, horizon: float, rate_per_device: float = 0.2,
               mean_downtime: float = 2.0, seed: int = 0) -> "FailureSchedule":
        rng = np.random.RandomState(seed)
        windows = []
        for d in range(num_devices):
            n = rng.poisson(rate_per_device)
            for _ in range(n):
                s = rng.uniform(0, horizon)
                windows.append(FailureWindow(d, s, s + rng.exponential(
                    mean_downtime)))
        return FailureSchedule(windows)


@dataclasses.dataclass
class StragglerDrift:
    """α multiplier applied to a device from `start` on (compute slowdown)."""
    device_id: int
    start: float
    alpha_multiplier: float = 3.0
