"""Device-time breakdown of the FL training path on one GPU.

    PYTHONPATH=src python -m repro_torch.launch.profile_fl \
        --task cnn_fmnist --method fedluck --error-feedback --rounds 3

Takes the flags of `repro_torch.launch.train` (`--device` must be a CUDA
device). Runs `run_fl` three times on the same seed — a warm-up, a timed
run, and a run under `torch.profiler` — and prints one JSON object: the
timed run's wall seconds, the profiled run's device-busy seconds (sum of
CUDA kernel and copy times, one stream) and idle share, and the top
device entries by time with their call counts. Profiling adds host
overhead, so the idle share of the profiled run is an upper bound.
"""
from __future__ import annotations

import copy
import json
import time

import torch

from repro_torch import resolve_device
from repro_torch.launch import train
from repro_torch.obs import log


def main(argv=None):
    ap = train.build_parser()
    ap.add_argument("--top", type=int, default=15,
                    help="device entries to list")
    args = ap.parse_args(argv)
    log.set_quiet(args.quiet)
    if resolve_device(args.device).type != "cuda":
        raise SystemExit("profile_fl measures a CUDA device")

    train.run_fl(copy.deepcopy(args))                       # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train.run_fl(copy.deepcopy(args))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        res = train.run_fl(copy.deepcopy(args))
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t0

    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        rows.append((e.key, e.count, us / 1e3))
    rows.sort(key=lambda r: -r[2])
    busy = sum(r[2] for r in rows) / 1e3
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "task": args.task, "method": args.method, "rounds": args.rounds,
        "result": res, "wall_s": wall, "profiled_wall_s": wall_prof,
        "device_busy_s": busy if rows else None,
        "idle_share": (1.0 - busy / wall_prof) if rows else None,
        "top": [{"name": n[:120], "calls": c, "ms": ms}
                for n, c, ms in rows[:args.top]],
    }, indent=1))


if __name__ == "__main__":
    main()
