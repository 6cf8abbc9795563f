"""Readings that the limits of `correct` are set from, on the card.

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,3 \
        --modes program,control,unchanged,half_batch,exchange [--out F]

For each seed, one JSON line with the cell's compared numbers in each
mode:

  program     the program's first steps (set-up only, no window) against
              the float32 reference: the lower readings
  control     the reference computed with TF32 on, in the program's
              place, against the float32 reference: the control
  <fault>     the program with the fault planted (harness/faults.py)
              against the float32 reference

All seeds run in one process, so set-up is paid once for the imports.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse   # noqa: E402
import gc         # noqa: E402
import json       # noqa: E402
import os         # noqa: E402
import sys        # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton_cache")
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench.harness import faults, main, spec  # noqa: E402
from portbench.harness.device import require_cuda  # noqa: E402

MODES = ("program", "control", *faults.FAULTS)


def readings(cell: dict, seed: int, modes, device: str = "cuda") -> dict:
    """{mode: the compared numbers} of one seed."""
    import torch
    c = spec.driver(cell["traffic"]["driver"])(cell, seed, device)
    out = c.calibrate(modes)
    del c
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def run(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--modes", default="program")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    modes = args.modes.split(",")
    if not set(modes) <= set(MODES):
        raise SystemExit(f"modes are {MODES}")
    cell = spec.resolve(spec.load_benchmark(), args.workload)
    torch = require_cuda(cell["chips"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        line = json.dumps({"workload": args.workload, "seed": seed,
                           "readings": readings(cell, seed, modes),
                           "seconds": time.perf_counter() - t0})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    found = main.forbidden_modules()
    if found:
        raise SystemExit(f"calibrate: modules {found} were loaded")


if __name__ == "__main__":
    run()
