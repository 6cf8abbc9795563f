"""Device times of the threshold top-k and pod-sync kernels at their
main-path shapes, so two trees, or two builds of one kernel, can be
compared in one run on one card.

    PYTHONPATH=src python -m repro_torch.launch.profile_kernels \
        [--src DIR] [--variants] [--out F]

Times magnitude_hist's coarse (49 edges) and fine (129 edges) passes at
d = 1,663,370 (the cnn width) and d = 832,512 (a pod shard), f32, with
both passes first held to exact counts; compact_blocks at the pod shard
[813, 1024], budget 10, at the shard's own threshold, first held bit for
bit to its plain version; and ef_topk at d = 1,663,370 (f32 and bf16 g
and r) and d = 1,665,024 (the pod dense wire's padded vector, f32), at the
threshold of top-1%, each first held bit for bit to its plain version.
As yardsticks of the method, the same timing around an empty kernel,
around `clone()` of the shard, and at the cnn width around
`torch.add(g, r)` (two reads and a write) and `g.clone()`. Timing is
`obs.profiling.time_ms` (CUDA events, median of 30 launches, L2 flushed
before each); the checks are `kernels.checks`.

`--src DIR` times the kernel wrappers of the `repro_torch` under DIR
(another checkout's `src`, e.g. a parent commit unpacked under `build/`;
its kernels build into that checkout's `build/`) in place of this tree's,
held to this tree's plain versions. `--variants` also times this tree's
builds that a kernel's design was chosen against, each held to its plain
version: magnitude_hist.cu with 4 vector loads per thread in place of 2
(`LOADS=4`) and with a copy of the bins per warp and `__match_any_sync`
aggregation in place of 32 lane-indexed copies (`HIST_MATCH_ANY`);
ef_topk.cu with 2 quads per thread in place of 4 (`QUADS=2`) and with
plain `__ldg` loads of g and r in place of evict-first ones (`EF_LDG`).
Prints one JSON object with the card's name and power limit; `--out` also
writes it to a file.
"""
from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels import checks, ops
from repro_torch.kernels import ef_topk as ef_mod
from repro_torch.kernels import magnitude_hist as mh
from repro_torch.obs.profiling import time_ms

D_CNN = 1_663_370                     # cnn_fmnist at the paper's width
NBL, BLK, BUDGET = 813, 1024, 10      # a pod shard and its block budget
D_POD = 2 * NBL * BLK                 # the pod dense wire's padded vector
# build variants per kernel source: {source: {tag: defines}}
VARIANTS = {"magnitude_hist": {"loads4": ("LOADS=4",),
                               "match_any": ("HIST_MATCH_ANY",)},
            "ef_topk": {"quads2": ("QUADS=2",), "ldg": ("EF_LDG",)}}


def tree_kernels(src: str | None):
    """(magnitude_hist, compact_blocks, ef_topk) of the repro_torch under
    `src` (None: this tree's). Another tree's modules are imported under
    their own names and then taken out of `sys.modules` again, so this
    tree's stay the ones that later imports see."""
    names = (("magnitude_hist", "magnitude_hist"),
             ("compact_topk", "compact_blocks"), ("ef_topk", "ef_topk"))
    if src is None:
        return tuple(getattr(importlib.import_module(
            f"repro_torch.kernels.{mod}"), fn) for mod, fn in names)

    def ours(name):
        return name == "repro_torch" or name.startswith("repro_torch.")

    saved = {k: sys.modules.pop(k) for k in list(sys.modules) if ours(k)}
    sys.path.insert(0, str(Path(src).resolve()))
    try:
        return tuple(getattr(importlib.import_module(
            f"repro_torch.kernels.{mod}"), fn) for mod, fn in names)
    finally:
        sys.path.pop(0)
        for k in [k for k in sys.modules if ours(k)]:
            del sys.modules[k]
        sys.modules.update(saved)


def _variant(name: str, defines):
    """This tree's wrapper of kernel `name`, launched from its build with
    `defines` (same arguments as the wrapper)."""
    mod = {"magnitude_hist": mh, "ef_topk": ef_mod}[name]
    lib = mod._lib(defines)

    def launch(*args):
        return mod._launch(*args, torch.cuda.current_stream(), lib=lib)
    return launch


def measure(hist, compact, ef, variants: bool = False) -> dict:
    """{name: ms} for the given wrappers (and this tree's build
    variants)."""
    def with_variants(name, fn):
        fns = {"": fn}
        if variants:
            fns.update({f"_{k}": _variant(name, v)
                        for k, v in VARIANTS[name].items()})
        return fns

    out = {}
    for d in (D_CNN, NBL * BLK):
        g = checks.vec(d, 1)
        k = NBL * BUDGET if d == NBL * BLK else None
        for tag, fn in with_variants("magnitude_hist", hist).items():
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
    for d, dtype in ((D_CNN, torch.float32), (D_CNN, torch.bfloat16),
                     (D_POD, torch.float32)):
        g = checks.vec(d, 2).to(dtype)
        r = (checks.vec(d, 3) * 0.1).to(dtype)
        te = ops.solve_threshold(g.float() + r.float(), round(0.01 * d))
        short = str(dtype).split(".")[-1]
        for tag, fn in with_variants("ef_topk", ef).items():
            checks.check_ef(g, r, te, f"d={d} {short}{tag} timed", ef=fn)
            out[f"ef_topk{tag}_{short}_d{d}"] = time_ms(lambda: fn(g, r, te))
    # yardsticks of the method: the same events around a kernel that does
    # nothing (launch and timing cost before any work), around a plain
    # copy of the shard (compact_blocks' bytes, less the payload), and at
    # the cnn width around one add of two vectors (three quarters of
    # ef_topk's bytes) and one copy (half)
    out["empty_kernel"] = time_ms(lambda: torch.cuda._sleep(0))
    out["shard_clone"] = time_ms(acc.clone)
    g, r = checks.vec(D_CNN, 2), checks.vec(D_CNN, 3)
    out[f"torch_add_d{D_CNN}"] = time_ms(lambda: torch.add(g, r))
    out[f"clone_d{D_CNN}"] = time_ms(g.clone)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", help="the `src` directory of another tree "
                    "whose kernel wrappers are timed")
    ap.add_argument("--variants", action="store_true",
                    help="also time the kernels' build variants")
    ap.add_argument("--out", help="also write the JSON object here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_kernels: needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    kernels = tree_kernels(args.src)
    src = Path(kernels[0].__globals__["__file__"]).resolve().parents[2]
    res = {"src": str(src), "card": smi,
           "ms": measure(*kernels, variants=args.variants)}
    text = json.dumps(res, indent=1)
    print(text, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")


if __name__ == "__main__":
    main()
