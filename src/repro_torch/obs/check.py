"""CLI schema validator for exported observability artifacts (PyTorch port
of `repro.obs.check`).

  PYTHONPATH=src python -m repro_torch.obs.check /tmp/trace.json /tmp/metrics.json

Validates the Perfetto/Chrome trace (required keys ph/ts/pid/tid/name,
labelled tracks) and the metrics JSON (section shape, histogram count
invariants) with the same functions the unit tests use, and prints a
one-line summary per file. Exits non-zero on the first violation; run it
over the `--trace-out` / `--metrics-out` artifacts of
`python -m repro_torch.launch.train`.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.obs.perfetto import validate_chrome_trace, validate_metrics_json


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("trace", help="Chrome-trace/Perfetto JSON path")
    ap.add_argument("metrics", nargs="?", default="",
                    help="metrics JSON path (optional)")
    ap.add_argument("--min-device-tracks", type=int, default=1,
                    help="require at least this many per-device tracks")
    args = ap.parse_args(argv)

    try:
        info = validate_chrome_trace(args.trace)
    except (ValueError, KeyError, OSError) as e:
        print(f"[obs.check] FAIL {args.trace}: {e}", file=sys.stderr)
        return 1
    n_dev = len(info["device_tracks"])
    if n_dev < args.min_device_tracks:
        print(f"[obs.check] FAIL {args.trace}: only {n_dev} device tracks "
              f"(need >= {args.min_device_tracks})", file=sys.stderr)
        return 1
    print(f"[obs.check] OK {args.trace}: {info['events']} events, "
          f"{len(info['tracks'])} tracks ({n_dev} devices)")

    if args.metrics:
        try:
            validate_metrics_json(args.metrics)
        except (ValueError, KeyError, OSError) as e:
            print(f"[obs.check] FAIL {args.metrics}: {e}", file=sys.stderr)
            return 1
        print(f"[obs.check] OK {args.metrics}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
