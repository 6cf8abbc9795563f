"""Chrome-trace / Perfetto JSON export and schema validation.

`PerfettoExporter` turns a `Tracer`'s event list into the Chrome trace
event format (the JSON flavour ui.perfetto.dev and chrome://tracing both
load): one process ("afl-sim"), one thread track per simulator track —
server, controller, then each device — with thread_name metadata so the
UI shows readable labels. Simulated seconds become microseconds.

`validate_chrome_trace` is the schema gate the unit tests and the CI
obs-smoke job share: every event must carry the required keys
(ph, ts, pid, tid, name), spans need a non-negative dur, and track
metadata must resolve every tid.
"""
from __future__ import annotations

import json

from repro_torch.obs.trace import (CONTROLLER_TRACK, SERVER_TRACK, Tracer,
                             device_track)

PID = 1
_US = 1e6                       # simulated seconds -> trace microseconds
REQUIRED_KEYS = ("ph", "ts", "pid", "tid", "name")
# fixed tids so traces from different runs line up: server, controller,
# then devices at a stable offset
_SERVER_TID = 1
_CONTROLLER_TID = 2
_DEVICE_TID0 = 10


class PerfettoExporter:
    """Stateless exporter: `export(tracer, path)` or `to_chrome(tracer)`."""

    def __init__(self, *, process_name: str = "afl-sim"):
        self.process_name = process_name

    # ------------------------------------------------------------- track ids
    @staticmethod
    def _tid(track: str) -> int:
        if track == SERVER_TRACK:
            return _SERVER_TID
        if track == CONTROLLER_TRACK:
            return _CONTROLLER_TID
        if track.startswith("device/"):
            return _DEVICE_TID0 + int(track.split("/", 1)[1])
        # unknown tracks get a stable hash-free fallback lane
        return _DEVICE_TID0 - 1

    @staticmethod
    def _label(track: str) -> str:
        if track.startswith("device/"):
            return f"device {track.split('/', 1)[1]}"
        return track

    # ----------------------------------------------------------------- build
    def to_chrome(self, tracer: Tracer) -> dict:
        events: list[dict] = [{
            "ph": "M", "ts": 0, "pid": PID, "tid": 0,
            "name": "process_name", "args": {"name": self.process_name},
        }]
        tracks: dict[str, int] = {}
        for e in tracer.events:
            tracks.setdefault(e.track, self._tid(e.track))
        # stable presentation order: server, controller, devices ascending
        for track, tid in sorted(tracks.items(), key=lambda kv: kv[1]):
            events.append({"ph": "M", "ts": 0, "pid": PID, "tid": tid,
                           "name": "thread_name",
                           "args": {"name": self._label(track)}})
            events.append({"ph": "M", "ts": 0, "pid": PID, "tid": tid,
                           "name": "thread_sort_index",
                           "args": {"sort_index": tid}})
        for e in tracer.events:
            rec = {"ph": e.ph, "ts": e.ts * _US, "pid": PID,
                   "tid": tracks[e.track], "name": e.name, "cat": "sim"}
            if e.ph == "X":
                rec["dur"] = e.dur * _US
            else:
                rec["s"] = "t"          # thread-scoped instant
            if e.args:
                rec["args"] = dict(e.args)
            events.append(rec)
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"producer": "repro_torch.obs",
                              "clock": "simulated seconds x 1e6"}}

    def export(self, tracer: Tracer, path: str) -> dict:
        doc = self.to_chrome(tracer)
        with open(path, "w") as f:
            json.dump(doc, f, indent=None, separators=(",", ":"))
            f.write("\n")
        return doc


# ------------------------------------------------------------------ validate
def validate_chrome_trace(doc: dict | str) -> dict:
    """Validate a Chrome-trace JSON document (or a path to one).

    Returns {"events": n, "tracks": {tid: label}, "device_tracks": [...]}.
    Raises ValueError on any schema violation — the unit tests and the CI
    obs-smoke job both call this.
    """
    if isinstance(doc, str):
        with open(doc) as f:
            doc = json.load(f)
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        raise ValueError("not a Chrome trace: missing traceEvents")
    events = doc["traceEvents"]
    if not isinstance(events, list) or not events:
        raise ValueError("traceEvents must be a non-empty list")
    labels: dict[int, str] = {}
    n_real = 0
    for i, e in enumerate(events):
        for key in REQUIRED_KEYS:
            if key not in e:
                raise ValueError(f"event {i} missing required key {key!r}: "
                                 f"{e}")
        if e["ph"] == "M":
            if e["name"] == "thread_name":
                labels[e["tid"]] = e["args"]["name"]
            continue
        n_real += 1
        if e["ph"] not in ("X", "i", "C", "B", "E"):
            raise ValueError(f"event {i} has unknown phase {e['ph']!r}")
        if not isinstance(e["ts"], (int, float)) or e["ts"] < 0:
            raise ValueError(f"event {i} has bad ts {e['ts']!r}")
        if e["ph"] == "X" and e.get("dur", 0) < 0:
            raise ValueError(f"event {i} has negative dur")
        if e["tid"] not in labels:
            raise ValueError(f"event {i} tid {e['tid']} has no thread_name "
                             f"metadata")
    if n_real == 0:
        raise ValueError("trace has only metadata events")
    return {"events": n_real, "tracks": labels,
            "device_tracks": sorted(v for v in labels.values()
                                    if v.startswith("device "))}


def validate_metrics_json(doc: dict | str) -> dict:
    """Validate a MetricsRegistry JSON export (or a path to one).
    Returns the parsed document; raises ValueError on schema violations."""
    if isinstance(doc, str):
        with open(doc) as f:
            doc = json.load(f)
    if not isinstance(doc, dict):
        raise ValueError("metrics JSON must be an object")

    def check_section(sec: dict) -> None:
        for key in ("counters", "gauges", "histograms"):
            if key not in sec or not isinstance(sec[key], dict):
                raise ValueError(f"metrics section missing {key!r}")
        for name, h in sec["histograms"].items():
            if sum(h["counts"]) != h["count"]:
                raise ValueError(f"histogram {name!r}: counts do not sum to "
                                 f"count")
            if len(h["counts"]) != len(h["bounds"]) + 1:
                raise ValueError(f"histogram {name!r}: needs len(bounds)+1 "
                                 f"buckets")

    if "counters" in doc:
        check_section(doc)
    else:                       # multi-engine export: one section per engine
        subs = [v for v in doc.values()
                if isinstance(v, dict) and "counters" in v]
        if not subs:
            raise ValueError("no metrics sections found")
        for sub in subs:
            check_section(sub)
    return doc
