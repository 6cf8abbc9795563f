#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. build    compile the CUDA C++ kernels from `src/repro_torch/kernels/csrc`
            (one nvcc per source, started together) and print the card's
            name and power limit;
2. kernels  hold each kernel against its plain PyTorch version on the card
            at d in {127, 40000, 1663370} (f32, plus bf16 inputs) — exact
            counts for magnitude_hist, bitwise out/residual/nnz and
            conservation for ef_topk, rtol 2e-5 / atol 1e-6 for
            fused_momentum — and time kernel, plain version and yardstick
            PyTorch call at d = 1,663,370 (CUDA events, median of 30
            launches, L2 flushed before each);
3. cli      `run_fl(--task cnn_fmnist --method fedluck --error-feedback
            --rounds 3 --device cuda)` with the CLI's other defaults (10
            devices, 4000 samples): finite accuracy, positive gbits, and
            fused_momentum launches == sum of k over the cycles run;
4. thresh   the same task and fleet planned with
            compressor_override="topk_threshold" and error feedback, 2
            rounds of the sequential engine: ef_topk launches == cycles and
            magnitude_hist launches == 2 x cycles;
5. parity   a small run (mlp_micro, 4 devices, topk_threshold + EF) on the
            card and on the CPU (plain versions) from the same weights:
            identical wire bits, counters and staleness, accuracy within
            0.02 and loss within rtol 1e-3.

Kernel launch counts are set to 0 just before each main-path run and read
just after it; launches made to compare a kernel with its plain version
do not count. The line before the last is {"kernels": [...]}, the last
line {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12      # fp32 outside the tensor cores
D_CNN = 1_663_370               # cnn_fmnist at the paper's width
SIZES = (127, 40_000, D_CNN)


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


# ------------------------------------------------------------------- timing
def time_ms(torch, fn, *, iters: int = 30, warmup: int = 5) -> float:
    """Median per-launch device time of `fn` (CUDA events around each
    call), with the 50 MB L2 flushed before every timed call. A sleep
    kernel first holds the stream so the host enqueues every launch ahead
    of the device: the events then time the device, not Python."""
    flush = torch.empty(96 * 2 ** 20 // 4, dtype=torch.float32,
                        device="cuda")
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)       # ~25 ms at the SM clock
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def bound(nbytes: float, nops: float) -> tuple[float, str]:
    """Least time on an H100 SXM: the larger of bytes over the memory rate
    and operations over the fp32 rate, in ms, and which one binds."""
    tb = nbytes / H100_BYTES_PER_S * 1e3
    to = nops / H100_F32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def vec(torch, d: int, seed: int):
    import numpy as np
    rng = np.random.RandomState(seed)
    x = rng.randn(d).astype(np.float32) * np.exp(rng.randn(d)).astype(
        np.float32)
    return torch.from_numpy(x).to("cuda")


def edges_for(torch, g):
    """The coarse (49) and fine (129) edges the pipeline would use on g."""
    from repro_torch.kernels import ops, ref
    acc = g.float()
    k = max(1, round(0.01 * acc.numel()))
    gmax = acc.abs().max() + 1e-30
    coarse = gmax * torch.exp2(-torch.arange(49, dtype=torch.float32,
                                             device="cuda"))
    lo, hi = ops._solve_threshold(ref.ref_magnitude_hist(acc, coarse),
                                  coarse, k)
    frac = torch.arange(129, dtype=torch.float32, device="cuda") / 128
    fine = torch.clamp(hi - (hi - lo) * frac, min=1e-30)
    return coarse, fine, ops.solve_threshold(acc, k)


# ------------------------------------------------------------------- phases
def phase_build(torch) -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    libs = _build.build()
    log(f"[build] {sorted(libs)} in {time.perf_counter() - t0:.1f}s -> "
        f"{_build.BUILD_DIR}")
    for name, text in _build.BUILD_LOG.items():
        for line in text.strip().splitlines():
            log(f"[build] {name}: {line.strip()}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    log(f"[card] {smi.stdout.strip()}")
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")


def phase_kernels(torch) -> dict:
    from repro_torch.kernels import ref
    from repro_torch.kernels.ef_topk import ef_topk
    from repro_torch.kernels.fused_momentum import fused_momentum
    from repro_torch.kernels.magnitude_hist import magnitude_hist

    err = {"magnitude_hist": 0.0, "ef_topk": 0.0, "fused_momentum": 0.0}
    for d in SIZES:
        for dtype in (torch.float32, torch.bfloat16):
            g = vec(torch, d, d).to(dtype)
            r = (vec(torch, d, d + 1) * 0.1).to(dtype)
            coarse, fine, t = edges_for(torch, g)
            # magnitude_hist: exact counts on both passes' edges
            for name, e in (("coarse", coarse), ("fine", fine)):
                got = magnitude_hist(g, e)
                want = ref.ref_magnitude_hist(g, e)
                diff = (got.long() - want.long()).abs().max().item()
                err["magnitude_hist"] = max(err["magnitude_hist"], diff)
                if diff:
                    fail(f"magnitude_hist {name} d={d} {dtype}: counts "
                         f"differ by {diff}")
            # ef_topk: bitwise out / residual / nnz, and conservation
            out, res, nnz = ef_topk(g, r, t)
            ro, rr, rn = ref.ref_ef_topk(g, r, t)
            if not (torch.equal(out, ro) and torch.equal(res, rr)
                    and int(nnz) == int(rn)):
                fail(f"ef_topk d={d} {dtype}: differs from the plain "
                     f"version (nnz {int(nnz)} vs {int(rn)})")
            if dtype == torch.float32 and not torch.equal(out + res, g + r):
                fail(f"ef_topk d={d}: out + r' != g + r")
            # fused_momentum: rtol 2e-5 / atol 1e-6 (the reference's own)
            w, gg = vec(torch, d, d + 2).to(dtype), vec(torch, d, d + 3)
            mu = vec(torch, d, d + 4)
            rw, rmu = ref.ref_fused_momentum(w, mu, gg.to(dtype), lr=0.05,
                                             momentum=0.9)
            fused_momentum(w, mu, gg.to(dtype), lr=0.05, momentum=0.9)
            for a, b, what in ((w, rw, "w"), (mu, rmu, "mu")):
                a32, b32 = a.float(), b.float()
                e = (a32 - b32).abs().max().item()
                err["fused_momentum"] = max(err["fused_momentum"], e)
                if not torch.allclose(a32, b32, rtol=2e-5, atol=1e-6):
                    fail(f"fused_momentum {what} d={d} {dtype}: max abs "
                         f"err {e}")
    torch.cuda.synchronize()
    log(f"[kernels] all three agree with their plain versions at d in "
        f"{SIZES}, f32 and bf16 inputs")

    # timings at the cnn width, f32
    d = D_CNN
    g, r = vec(torch, d, 1), vec(torch, d, 2) * 0.1
    coarse, fine, t = edges_for(torch, g)
    w, mu = vec(torch, d, 3), vec(torch, d, 4)
    p = torch.nn.Parameter(w.clone())
    p.grad = g.clone()
    sgd = torch.optim.SGD([p], lr=0.05, momentum=0.9, fused=True)
    f4 = 4
    rows = {}
    ms = time_ms(torch, lambda: magnitude_hist(g, coarse))
    ms_fine = time_ms(torch, lambda: magnitude_hist(g, fine))
    rows["magnitude_hist"] = dict(
        ms=ms, plain_ms=time_ms(torch, lambda: ref.ref_magnitude_hist(
            g, coarse)), library_ms=None,
        bound=bound(f4 * d + 2 * f4 * coarse.numel(),
                    d * (1 + math.log2(coarse.numel()))))
    log(f"[time] magnitude_hist fine pass (129 edges): {ms_fine:.6f} ms")
    rows["ef_topk"] = dict(
        ms=time_ms(torch, lambda: ef_topk(g, r, t)),
        plain_ms=time_ms(torch, lambda: ref.ref_ef_topk(g, r, t)),
        library_ms=None, bound=bound(4 * f4 * d + 8, 4 * d))
    rows["fused_momentum"] = dict(
        ms=time_ms(torch, lambda: fused_momentum(w, mu, g, lr=0.05,
                                                 momentum=0.9)),
        plain_ms=time_ms(torch, lambda: ref.ref_fused_momentum(
            w, mu, g, lr=0.05, momentum=0.9)),
        library_ms=time_ms(torch, sgd.step),
        bound=bound(5 * f4 * d, 4 * d))
    for name, row in rows.items():
        row["max_abs_err"] = err[name]
        log(f"[time] {name} d={d}: kernel {row['ms']:.6f} ms, plain "
            f"{row['plain_ms']:.6f} ms, library {row['library_ms']}, bound "
            f"{row['bound'][0]:.6f} ms ({row['bound'][1]})")
    return rows


def reset_counts() -> None:
    from repro_torch.kernels.ef_topk import ef_topk
    from repro_torch.kernels.fused_momentum import fused_momentum
    from repro_torch.kernels.magnitude_hist import magnitude_hist
    for fn in (ef_topk, fused_momentum, magnitude_hist):
        fn.launches = 0


def counts() -> dict:
    from repro_torch.kernels.ef_topk import ef_topk
    from repro_torch.kernels.fused_momentum import fused_momentum
    from repro_torch.kernels.magnitude_hist import magnitude_hist
    return {"fused_momentum": fused_momentum.launches,
            "ef_topk": ef_topk.launches,
            "magnitude_hist": magnitude_hist.launches}


def phase_cli(torch) -> int:
    from repro_torch.launch import train
    with tempfile.TemporaryDirectory() as tmp:
        mpath = os.path.join(tmp, "metrics.json")
        args = train.build_parser().parse_args(
            ["--task", "cnn_fmnist", "--method", "fedluck",
             "--error-feedback", "--rounds", "3", "--device", "cuda",
             "--quiet", "--metrics-out", mpath])
        t0 = time.perf_counter()
        reset_counts()
        res = train.run_fl(args)
        torch.cuda.synchronize()
        c = counts()
        wall = time.perf_counter() - t0
        with open(mpath) as f:
            metrics = json.load(f)
    local_k = metrics["histograms"]["sim.local_k"]
    log(f"[cli] {json.dumps(res)}")
    log(f"[cli] wall {wall:.3f}s, cycles {local_k['count']}, sum k "
        f"{local_k['sum']}, launches {c}")
    if not math.isfinite(res["final_accuracy"]) or res["gbits"] <= 0:
        fail(f"cli result not sane: {res}")
    if res["rounds"] != 3:
        fail(f"cli ran {res['rounds']} rounds, expected 3")
    if c["fused_momentum"] != int(local_k["sum"]) or c["fused_momentum"] == 0:
        fail(f"fused_momentum launched {c['fused_momentum']} times, sum of "
             f"k over cycles is {local_k['sum']}")
    return c["fused_momentum"]


def _fleet(task_name: str, n: int, samples: int, k_max: int, compressor):
    import torch
    from repro_torch.core.simulator import (make_heterogeneous_devices,
                                            plan_devices)
    from repro_torch.models.small import make_task
    task = make_task(task_name, num_samples=samples, test_samples=800,
                     batch_size=32)
    flat = task.init_fn(torch.Generator().manual_seed(0))
    profiles = make_heterogeneous_devices(n, flat.numel() * 32, seed=0)
    specs = plan_devices(profiles, "fedluck", 1.0, k_bounds=(1, k_max),
                         compressor_override=compressor, error_feedback=True)
    return task, specs


def phase_threshold(torch) -> dict:
    from repro_torch.core.simulator import AFLSimulator
    from repro_torch.obs import MetricsRegistry
    task, specs = _fleet("cnn_fmnist", 10, 4000, 30, "topk_threshold")
    m = MetricsRegistry()
    sim = AFLSimulator(task, specs, "periodic", engine="sequential",
                       device="cuda", metrics=m)
    t0 = time.perf_counter()
    reset_counts()
    h = sim.run(total_rounds=2, eval_every=1)
    torch.cuda.synchronize()
    c = counts()
    cycles = int(m.counter("sim.cycles").value)
    r = h.records[-1]
    log(f"[thresh] wall {time.perf_counter() - t0:.3f}s, cycles {cycles}, "
        f"acc {r.accuracy} loss {r.loss} gbits {r.gbits}, launches {c}")
    if not (math.isfinite(r.accuracy) and math.isfinite(r.loss)):
        fail("topk_threshold run gave a non-finite result")
    if cycles == 0 or c["ef_topk"] != cycles \
            or c["magnitude_hist"] != 2 * cycles:
        fail(f"topk_threshold launches {c} for {cycles} cycles")
    return c


def phase_parity(torch) -> None:
    from repro_torch.core.simulator import AFLSimulator
    from repro_torch.obs import Tracer

    def run(device):
        task, specs = _fleet("mlp_micro", 4, 600, 8, "topk_threshold")
        tr = Tracer()
        sim = AFLSimulator(task, specs, "periodic", engine="sequential",
                           device=device, seed=3, tracer=tr)
        h = sim.run(total_rounds=4, eval_every=1)
        strip = [(e.track, e.name, e.ph, e.ts, e.dur,
                  tuple(a for a in e.args if a[0] not in ("accuracy", "loss")))
                 for e in tr.events]
        return h, strip

    hc, ec = run("cuda")
    hh, eh = run("cpu")
    if ec != eh or hc.counters != hh.counters:
        fail("card and CPU runs differ in events or counters")
    for a, b in zip(hc.records, hh.records):
        if (a.time, a.round, a.gbits, a.mean_staleness) != \
                (b.time, b.round, b.gbits, b.mean_staleness):
            fail(f"records differ: {a} vs {b}")
        if abs(a.accuracy - b.accuracy) > 0.02 or \
                abs(a.loss - b.loss) > 1e-3 * abs(b.loss) + 1e-6:
            fail(f"accuracy/loss differ: {a} vs {b}")
    log(f"[parity] card vs CPU: {len(ec)} identical events, final acc "
        f"{hc.records[-1].accuracy} vs {hh.records[-1].accuracy}, loss "
        f"{hc.records[-1].loss} vs {hh.records[-1].loss}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    t0 = time.perf_counter()
    phase_build(torch)
    rows = phase_kernels(torch)
    fm = phase_cli(torch)
    th = phase_threshold(torch)
    phase_parity(torch)
    launches = {"fused_momentum": fm, "ef_topk": th["ef_topk"],
                "magnitude_hist": th["magnitude_hist"]}
    meta = {
        "fused_momentum": ("triton", "src/repro_torch/kernels/fused_momentum.py",
                           "src/repro/kernels/fused_momentum.py:46"),
        "ef_topk": ("triton", "src/repro_torch/kernels/ef_topk.py",
                    "src/repro/kernels/ef_topk.py:57"),
        "magnitude_hist": ("cuda",
                           "src/repro_torch/kernels/csrc/magnitude_hist.cu",
                           "src/repro/kernels/magnitude_hist.py:56"),
    }
    kernels = []
    for name, (route, source, replaces) in meta.items():
        row = rows[name]
        kernels.append({
            "name": name, "route": route, "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound"][0],
            "bound_by": row["bound"][1], "library_ms": row["library_ms"]})
    log(f"[done] {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
