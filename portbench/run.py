"""The benchmark of the PyTorch and CUDA port (`src/repro_torch`).

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

One run of one cell of `BENCHMARK.json`: set-up (imports, inputs made from
the seed, the program built and its first steps run, every shape the
cell uses warmed up), a window of `--seconds` seconds of the cell's
traffic, and the check of the program's first steps against the plain
reference under `portbench/reference`. The last line of standard output
is one JSON object: `correct`, `attempted`, `failed`, `metrics` (the
cell's end-to-end metrics with `--trace 0`, its per-layer metrics with
`--trace 1`), `device` and, last, `checks` (each compared number with its
limit); the same numbers are the last lines of standard error.

Caches stay inside the checkout: Triton's in `build/triton_cache`, the
port's nvcc builds in `build/repro_torch_kernels`.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse   # noqa: E402
import json       # noqa: E402
import os         # noqa: E402
import sys        # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton_cache")
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench.harness import main  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


if __name__ == "__main__":
    args = parse()
    result = main.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), t_start=T_START)
    found = main.forbidden_modules()
    if found:
        sys.exit(f"portbench: modules {found} were loaded in the run; the "
                 f"port and the harness may load none")
    print(json.dumps(result))
