"""The card: the check that it is there, what it is, and the reduction of a
`torch.profiler` trace to device busy time, the top device operations and
the idle gaps labelled by what the host was doing.

The reduction functions take plain event lists, (name, start_us, dur_us),
so the tests can hold them against hand-made traces.
"""
from __future__ import annotations

import bisect
import subprocess

MARKER = "portbench.traced"


def require_cuda(chips: int):
    """The torch module, once a card count of at least `chips` is seen;
    else the run ends with exit code 1 and no result."""
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("portbench: torch.cuda.is_available() is false; "
                         "the benchmark runs on an NVIDIA GPU only")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"portbench: the cell needs {chips} GPUs, "
                         f"{torch.cuda.device_count()} found")
    return torch


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else "unknown"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def device_info(torch, chips: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i)
                                     for i in range(chips))}


# ------------------------------------------------------------ trace capture
class Trace:
    """`with Trace(torch) as tr:` profiles host and CUDA activity over the
    block, which it ends with a device synchronisation. Afterwards
    `tr.device` holds the device operations (kernels, copies, sets) and
    `tr.host` the host operations as (name, start_us, dur_us), and
    `tr.window` the traced window (start_us, end_us) on the same clock."""

    def __init__(self, torch):
        self.torch = torch
        self.device, self.host, self.window = [], [], (0.0, 0.0)

    def _sync(self):
        if self.torch.cuda.is_available():
            self.torch.cuda.synchronize()

    def __enter__(self):
        torch = self.torch
        self._sync()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self._mark = torch.profiler.record_function(MARKER)
        self._mark.__enter__()
        return self

    def __exit__(self, *exc):
        self._sync()
        self._mark.__exit__(*exc)
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self._reduce()
        return False

    def _reduce(self) -> None:
        cuda = self.torch.autograd.DeviceType.CUDA
        for e in self._prof.profiler.kineto_results.events():
            row = (e.name(), e.start_ns() / 1e3, e.duration_ns() / 1e3)
            if e.device_type() == cuda:
                self.device.append(row)
            elif row[0] == MARKER:
                self.window = (row[1], row[1] + row[2])
            else:
                self.host.append(row)
        if self.window == (0.0, 0.0):
            raise RuntimeError("the trace holds no window marker")
        # host annotations (record_function ranges) are mirrored on the
        # device's timeline under the same names: they are no device work
        names = {r[0] for r in self.host} | {MARKER}
        self.device = [r for r in self.device if r[0] not in names]
        del self._prof


# --------------------------------------------------------------- reduction
def merged(intervals):
    """Sorted, merged [start, end) intervals of (name, start, dur) rows."""
    out = []
    for s, e in sorted((r[1], r[1] + r[2]) for r in intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_s(device, window) -> float:
    """Seconds of `window` in which some device operation ran."""
    lo, hi = window
    return sum(max(0.0, min(e, hi) - max(s, lo))
               for s, e in merged(device)) / 1e6


def top_ops(device, n: int = 10) -> list:
    """[[name, seconds]] of the n device operations that took most time."""
    tot: dict[str, float] = {}
    for name, _, dur in device:
        tot[name] = tot.get(name, 0.0) + dur / 1e6
    return [[k[:120], v] for k, v in
            sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(device, host, window, n: int = 10, scan: int = 4000) -> list:
    """[[label, seconds]]: the device's idle time in `window`, summed by
    what the host was doing at the middle of each gap (the innermost host
    operation running then, "host" when none was), the n largest."""
    lo, hi = window
    gaps, t = [], lo
    for s, e in merged(device):
        if s > t:
            gaps.append((t, min(s, hi)))
        t = max(t, e)
    if t < hi:
        gaps.append((t, hi))
    rows = sorted(host, key=lambda r: r[1])
    starts = [r[1] for r in rows]
    tot: dict[str, float] = {}
    for a, b in gaps:
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        label = "host"
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(-1, i - scan), -1):
            name, s, d = rows[j]
            if s + d >= mid:
                label = name
                break
        tot[label] = tot.get(label, 0.0) + (b - a) / 1e6
    return [[k[:120], v] for k, v in
            sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def idle_share(ctx):
    """100 · (1 − busy per round / wall per round): the device's busy
    seconds per round in the traced segment (the union of its
    operations' intervals), over the untraced window's wall seconds per
    round. The profiler stretches the host's time (the traced window) but
    not the device's, so the traced window's own idle share would be
    the profiler's as much as the program's. Every round of a cell does
    the same device work (FL segments run one schedule; pod rounds one
    shape). None where the trace holds no device operation."""
    tr, w = ctx["trace"], ctx["window"]
    if not tr.device or not ctx["trace_rounds"] or not w.get("rounds"):
        return None
    busy = busy_s(tr.device, tr.window) / ctx["trace_rounds"]
    return 100.0 * (1.0 - busy / (w["wall_s"] / w["rounds"]))


def kernel_times(device, patterns) -> dict:
    """{pattern: [seconds per launch]} of the device kernels whose name
    holds the pattern."""
    out = {p: [] for p in patterns}
    for name, _, dur in device:
        for p in patterns:
            if p in name:
                out[p].append(dur / 1e6)
    return out


def breakdown(trace: Trace) -> dict:
    return {"device_ops": top_ops(trace.device),
            "idle_gaps": idle_gaps(trace.device, trace.host, trace.window)}
