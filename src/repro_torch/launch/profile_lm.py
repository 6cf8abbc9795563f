"""Device-time breakdown of the LM family's two paths on one GPU.

    PYTHONPATH=src python -m repro_torch.launch.profile_lm serve \
        --arch gemma3-4b
    PYTHONPATH=src python -m repro_torch.launch.profile_lm datacenter \
        --arch mamba2-780m

`serve`: `launch.serve.serve()` (4 requests at batch 2, prompt 16, gen
16, fp32, random init on the card): a warm-up call, a timed call, and a
call under `torch.profiler`. `datacenter`: `launch.train.run_datacenter`
(2 pods, --local-k 2 --rate 0.01 --steps 2 --batch-size 8): a warm-up
run, a timed run with its per-phase walls (local rounds, compression,
aggregation), and a run under the profiler. Both run the unreduced
config of `--arch`.

Prints one JSON object: the card, the timed wall, the profiled wall,
device-busy seconds (sum of CUDA kernel and copy times, one stream), the
idle share, the top device entries, the top host operators by self time,
and the caching allocator's device allocations, frees and retries over
the whole process (`torch.cuda.memory_stats`). Profiling adds host
overhead, so the idle share of the profiled run is an upper bound.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.configs import get_config
from repro_torch.obs import log
from repro_torch.obs.profiling import (PhaseTimers, device_breakdown,
                                       device_profile)


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def main(argv=None):
    from repro_torch.launch import serve as serve_mod, train
    from repro_torch.models.transformer import LM

    ap = argparse.ArgumentParser()
    ap.add_argument("path", choices=["serve", "datacenter"])
    ap.add_argument("--arch", default="gemma3-4b")
    ap.add_argument("--top", type=int, default=15,
                    help="device entries to list")
    args = ap.parse_args(argv)
    log.set_quiet(True)
    if not torch.cuda.is_available():
        raise SystemExit("profile_lm measures a CUDA device")
    cfg = get_config(args.arch)
    out = {"device": torch.cuda.get_device_name(0), "path": args.path,
           "arch": args.arch, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model}

    if args.path == "serve":
        lm = LM(cfg, dtype=torch.float32, remat=False)
        params = lm.init(torch.Generator(device="cuda").manual_seed(0),
                         "cuda")

        def run():
            return serve_mod.serve(lm, params, requests=4, batch=2,
                                   prompt_len=16, gen=16, seed=0)
        run()                                         # warm-up
        res, wall = _timed(run)
        out.update(tokens_per_s=res["tokens_per_s"])
    else:
        dc = train.build_parser().parse_args(
            ["--mode", "datacenter", "--arch", args.arch, "--pods", "2",
             "--local-k", "2", "--rate", "0.01", "--steps", "2",
             "--batch-size", "8", "--device", "cuda", "--quiet"])

        def run():
            return train.run_datacenter(dc, cfg)
        run()                                         # warm-up
        timers = PhaseTimers()
        res, wall = _timed(lambda: train.run_datacenter(dc, cfg, timers))
        out.update(result=res, phases=timers.snapshot())

    with device_profile() as prof:
        _, wall_prof = _timed(run)
    host = sorted(((e.key, e.count, e.self_cpu_time_total / 1e3)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda r: -r[2])[:args.top]
    stats = torch.cuda.memory_stats()
    out.update(wall_s=wall, profiled_wall_s=wall_prof,
               peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               allocator={k: stats.get(k, 0) for k in (
                   "num_device_alloc", "num_device_free",
                   "num_alloc_retries")},
               **device_breakdown(prof, wall_prof, args.top),
               host_top=[{"name": n[:120], "calls": c, "self_ms": ms}
                         for n, c, ms in host])
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
