"""One run of one cell: set-up, window, optional traced segment, the
check against the reference, the result line."""
from __future__ import annotations

import gc
import math
import sys
import time

from portbench.harness import compare, spec
from portbench.harness.device import (breakdown, busy_s, device_info,
                                      power_limit, require_cuda)

# whole top-level module names that may not be loaded in a run: JAX, its
# libraries and the JAX package (`repro_torch` starts with "repro" but is
# another name) and its benchmarks
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def forbidden_modules(modules=None) -> list:
    names = sys.modules if modules is None else modules
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        t_start: float, cell: dict | None = None, device: str = "cuda",
        faults=()) -> dict:
    """The result line of one run. `cell` (default: the workload's entry
    of BENCHMARK.json) and `device` other than "cuda" serve the tests;
    `faults` are callables that break the program under test."""
    cell = cell or spec.resolve(spec.load_benchmark(), workload)
    if device == "cuda":
        torch = require_cuda(cell["chips"])
        torch.cuda.reset_peak_memory_stats()
        log(f"[portbench] {workload} seed={seed} card: {power_limit()}")
    else:
        import torch
    # the configurations state float32 with TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    c = spec.driver(cell["traffic"]["driver"])(cell, seed, device,
                                               trace=trace)
    c.faults = list(faults)
    c.setup()
    setup_s = time.perf_counter() - t_start
    log(f"[portbench] setup {setup_s:.3f} s")
    win = c.window(seconds)
    log(f"[portbench] window {win}")
    tr, tr_rounds = c.traced() if trace else (None, 0)
    dev = device_info(torch, cell["chips"]) if device == "cuda" else {
        "platform": device, "kind": device, "count": 1,
        "memory_peak_bytes": 0}
    e2e = {**c.end_to_end(win), "setup_s": setup_s,
           "peak_mem_gib": dev["memory_peak_bytes"] / 2 ** 30}
    metrics = {}
    if trace:
        ctx = {**c.context(win), "trace": tr, "trace_rounds": tr_rounds,
               "device": dev}
        for m in cell["per_layer"]:
            v = spec.metric_reader(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev = {**dev, "busy_s": busy_s(tr.device, tr.window),
               "window_s": (tr.window[1] - tr.window[0]) / 1e6}
    else:
        for m in cell["end_to_end"]:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}

    c.release()
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    readings = c.check()
    ok, checks = compare.judge(readings, cell["limits"])

    for name, v in checks.items():
        log(f"check {name} = {v['value']!r} (limit {v['limit']!r})")
    result = {"correct": ok, "attempted": len(checks),
              "failed": sum(not (math.isfinite(v["value"])
                                 and v["value"] <= v["limit"])
                            for v in checks.values()),
              "metrics": metrics, "device": {**dev, "power": power_limit()
                                             if device == "cuda" else ""}}
    if tr is not None:
        result["breakdown"] = breakdown(tr)
    result["checks"] = checks
    return result
