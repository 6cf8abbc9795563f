"""The program's spans in a traced segment: the host rows that
`repro_torch.obs.profiling.annotate` records under the profiler (its
module docstring lists the spans and their nesting), read by the
per-layer metrics that name a span.

Each function takes a trace (`device.Trace`, or anything with `host` and
`device` rows (name, start_us, dur_us)) and returns None where it finds
nothing to read: a program without the span, or a run without a card.
Rows are matched by time, not by thread, so the launches of autograd's
backward thread count inside the span that waits for them.
"""
from __future__ import annotations

import bisect

from portbench.harness.device import busy_s, merged

# host rows of a kernel launch: the CUDA runtime's `cudaLaunch*` and
# the low-level `cuLaunch*` that Triton's launches take
LAUNCH = ("cudaLaunch", "cuLaunch")


def intervals(host, name: str) -> list:
    """Merged [start, end) intervals of the host rows named `name`."""
    return merged([r for r in host if r[0] == name])


def within(ivs: list):
    """The test of whether a time lies in one of the sorted, merged
    intervals `ivs`."""
    starts = [s for s, _ in ivs]

    def test(t: float) -> bool:
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t < ivs[i][1]
    return test


def seconds_per_round(trace, name: str, rounds: int):
    """Σ duration of the rows named `name`, in seconds, per traced round."""
    durs = [r[2] for r in trace.host if r[0] == name]
    if not durs or not rounds:
        return None
    return sum(durs) / 1e6 / rounds


def launches_per_step(trace, span: str = "local_round",
                      step: str = "local_round.step"):
    """Kernel-launch rows that start inside `span` rows, over the `step`
    rows that start there."""
    ivs = intervals(trace.host, span)
    if not ivs:
        return None
    inside = within(ivs)
    steps = launches = 0
    for name, start, _ in trace.host:
        if name == step:
            steps += inside(start)
        elif name.startswith(LAUNCH):
            launches += inside(start)
    if not steps or not launches:
        return None
    return launches / steps


def device_ms_inside(trace, span: str, inner: str, rounds: int):
    """Device-busy ms per traced round inside the `span` rows, each from
    the first row whose name starts with `inner` that starts in it (the
    span's start where none does) to its end. The span's caller may wait at its start
    for work enqueued before it (the benchmark's `SplitSync` drains the
    card there), and that work is not the span's."""
    host = trace.host
    firsts = sorted(r[1] for r in host if r[0].startswith(inner))
    total, seen = 0.0, False
    for name, start, dur in host:
        if name != span:
            continue
        end = start + dur
        i = bisect.bisect_left(firsts, start)
        lo = firsts[i] if i < len(firsts) and firsts[i] <= end else start
        total += busy_s(trace.device, (lo, end))
        seen = True
    if not seen or not rounds or not total:
        return None
    return 1e3 * total / rounds
