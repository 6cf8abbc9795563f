"""Structured event tracer over the simulator's *simulated* clock.

Events are plain records (span / instant) on named tracks — one track per
device plus dedicated server and controller tracks — appended to a host
list in emission order. The simulator emits only at the seams `repro`'s
does (heap-pop sites, `_schedule_upload`, `_maybe_replan`, aggregation,
eval), so the port and the reference produce the *same* event list on the
same run; that list equality is a correctness gate
(tests/test_torch_slice.py).

Timestamps are simulated seconds (floats from the event heap). No wall
clock, no RNG: tracing can never perturb a run's results.

The simulator guards every call site with `tracer is not None`, so the
default (`tracer=None`) pays one predicate per site.
"""
from __future__ import annotations

import dataclasses


SERVER_TRACK = "server"
CONTROLLER_TRACK = "controller"


def device_track(device_id: int) -> str:
    return f"device/{device_id}"


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One trace record. `ph` follows the Chrome trace phase convention:
    "X" = complete span (ts + dur), "i" = instant. `ts`/`dur` are simulated
    seconds; the Perfetto exporter converts to microseconds."""
    track: str
    name: str
    ph: str                   # "X" | "i"
    ts: float                 # simulated seconds
    dur: float = 0.0          # span length (ph == "X")
    args: tuple = ()          # sorted (key, value) pairs — hashable, ordered

    def arg(self, key: str, default=None):
        for k, v in self.args:
            if k == key:
                return v
        return default


def _args(kw: dict) -> tuple:
    return tuple(sorted(kw.items()))


class Tracer:
    """Recording tracer: appends TraceEvents to `self.events`."""

    def __init__(self):
        self.events: list[TraceEvent] = []

    # ------------------------------------------------------------------ emit
    def span(self, track: str, name: str, t0: float, t1: float, **kw) -> None:
        """Complete span [t0, t1] on `track` (simulated seconds)."""
        self.events.append(TraceEvent(track, name, "X", float(t0),
                                      float(t1) - float(t0), _args(kw)))

    def instant(self, track: str, name: str, t: float, **kw) -> None:
        self.events.append(TraceEvent(track, name, "i", float(t),
                                      0.0, _args(kw)))

    # ----------------------------------------------------------------- query
    def __len__(self) -> int:
        return len(self.events)

    def by_name(self, name: str) -> list[TraceEvent]:
        return [e for e in self.events if e.name == name]

    def tracks(self) -> list[str]:
        seen: dict[str, None] = {}
        for e in self.events:
            seen.setdefault(e.track)
        return list(seen)

    def clear(self) -> None:
        self.events.clear()
