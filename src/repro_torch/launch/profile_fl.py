"""Device-time breakdown of the FL training path on one GPU.

    PYTHONPATH=src python -m repro_torch.launch.profile_fl \
        --task cnn_fmnist --method fedluck --error-feedback --rounds 3 \
        [--engine sequential]

Takes the flags of `repro_torch.launch.train` (`--device` must be a CUDA
device) and `--engine` (the engine `run_fl` builds the simulator with:
`batched`, the CLI's default, or `sequential`). Runs `run_fl` three
times on the same seed — a warm-up, a timed run, and a run under
`torch.profiler` — and prints one JSON object: the
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
from repro_torch.obs.profiling import device_breakdown, device_profile


def main(argv=None):
    ap = train.build_parser()
    ap.add_argument("--top", type=int, default=15,
                    help="device entries to list")
    ap.add_argument("--engine", default="batched",
                    choices=["batched", "sequential"],
                    help="simulator engine to profile")
    args = ap.parse_args(argv)
    log.set_quiet(args.quiet)
    if resolve_device(args.device).type != "cuda":
        raise SystemExit("profile_fl measures a CUDA device")

    train.run_fl(copy.deepcopy(args), engine=args.engine)     # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train.run_fl(copy.deepcopy(args), engine=args.engine)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    with device_profile() as prof:
        t0 = time.perf_counter()
        res = train.run_fl(copy.deepcopy(args), engine=args.engine)
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t0

    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "task": args.task, "method": args.method, "rounds": args.rounds,
        "engine": args.engine,
        "result": res, "wall_s": wall, "profiled_wall_s": wall_prof,
        **device_breakdown(prof, wall_prof, args.top),
    }, indent=1))


if __name__ == "__main__":
    main()
