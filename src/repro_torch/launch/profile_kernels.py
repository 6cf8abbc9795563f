"""Device times of the pod-sync kernels at their main-path shapes, so two
trees, or two builds of one kernel, can be compared in one run on one card.

    PYTHONPATH=src python -m repro_torch.launch.profile_kernels \
        [--src DIR] [--variants] [--out F]

Times magnitude_hist's coarse (49 edges) and fine (129 edges) passes at
d = 1,663,370 (the cnn width) and d = 832,512 (a pod shard), f32, with
both passes first held to exact counts; and compact_blocks at the pod
shard [813, 1024], budget 10, at the shard's own threshold, first held bit
for bit to its plain version; and, as yardsticks of the method, the same
timing around an empty kernel and around `clone()` of the shard. Timing
is `obs.profiling.time_ms` (CUDA events, median of 30 launches, L2
flushed before each); the checks are `kernels.checks`.

`--src DIR` times the kernel wrappers of the `repro_torch` under DIR
(another checkout's `src`, e.g. a parent commit unpacked under `build/`;
its kernels build into that checkout's `build/`) in place of this tree's,
held to this tree's plain versions. `--variants` also times the builds of
magnitude_hist.cu that its design was chosen against, each held to exact
counts: 4 vector loads per thread in place of 2 (`LOADS=4`), and a copy
of the bins per warp with `__match_any_sync` aggregation in place of 32
lane-indexed copies (`HIST_MATCH_ANY`). Prints one JSON object with the
card's name and power limit; `--out` also writes it to a file.
"""
from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels import checks
from repro_torch.kernels import magnitude_hist as mh
from repro_torch.obs.profiling import time_ms

D_CNN = 1_663_370                     # cnn_fmnist at the paper's width
NBL, BLK, BUDGET = 813, 1024, 10      # a pod shard and its block budget
VARIANTS = {"loads4": ("LOADS=4",), "match_any": ("HIST_MATCH_ANY",)}


def tree_kernels(src: str | None):
    """(magnitude_hist, compact_blocks) of the repro_torch under `src`
    (None: this tree's). Another tree's modules are imported under their
    own names and then taken out of `sys.modules` again, so this tree's
    stay the ones that later imports see."""
    if src is None:
        from repro_torch.kernels.compact_topk import compact_blocks
        return mh.magnitude_hist, compact_blocks

    def ours(name):
        return name == "repro_torch" or name.startswith("repro_torch.")

    saved = {k: sys.modules.pop(k) for k in list(sys.modules) if ours(k)}
    sys.path.insert(0, str(Path(src).resolve()))
    try:
        hist = importlib.import_module(
            "repro_torch.kernels.magnitude_hist").magnitude_hist
        compact = importlib.import_module(
            "repro_torch.kernels.compact_topk").compact_blocks
    finally:
        sys.path.pop(0)
        for k in [k for k in sys.modules if ours(k)]:
            del sys.modules[k]
        sys.modules.update(saved)
    return hist, compact


def _variant(defines):
    """magnitude_hist(g, edges) launched from the build with `defines`."""
    lib = mh._lib(defines)

    def hist(g, edges):
        return mh._launch(g, edges, torch.cuda.current_stream(), lib=lib)
    return hist


def measure(hist, compact, variants: bool = False) -> dict:
    """{name: ms} for the given wrappers (and the build variants)."""
    hists = {"": hist}
    if variants:
        hists.update({f"_{k}": _variant(v) for k, v in VARIANTS.items()})
    out = {}
    for d in (D_CNN, NBL * BLK):
        g = checks.vec(d, 1)
        k = NBL * BUDGET if d == NBL * BLK else None
        for tag, fn in hists.items():
            coarse, fine, _ = checks.check_hist(g, f"d={d}{tag}", k, hist=fn)
            for name, e in (("coarse49", coarse), ("fine129", fine)):
                out[f"magnitude_hist{tag}_{name}_d{d}"] = time_ms(
                    lambda: fn(g, e))
    acc = checks.vec(NBL * BLK, 7).view(NBL, BLK)
    _, _, t = checks.check_hist(acc.reshape(-1), "shard", NBL * BUDGET)
    checks.check_compact(acc, t, BUDGET, f"{NBL}x{BLK} timed",
                         compact=compact)
    out[f"compact_blocks_{NBL}x{BLK}_b{BUDGET}"] = time_ms(
        lambda: compact(acc, t, budget=BUDGET))
    # yardsticks of the method: the same events around a kernel that does
    # nothing (launch and timing cost before any work), and around a plain
    # copy of the shard (compact_blocks' bytes, less the payload)
    out["empty_kernel"] = time_ms(lambda: torch.cuda._sleep(0))
    out["shard_clone"] = time_ms(acc.clone)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", help="the `src` directory of another tree "
                    "whose kernel wrappers are timed")
    ap.add_argument("--variants", action="store_true",
                    help="also time magnitude_hist's build variants")
    ap.add_argument("--out", help="also write the JSON object here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_kernels: needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    hist, compact = tree_kernels(args.src)
    src = Path(hist.__globals__["__file__"]).resolve().parents[2]
    res = {"src": str(src), "card": smi,
           "ms": measure(hist, compact, args.variants)}
    text = json.dumps(res, indent=1)
    print(text, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")


if __name__ == "__main__":
    main()
