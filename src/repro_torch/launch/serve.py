"""Batched serving driver: prefill + decode loop for any token-LM arch
(PyTorch port of `repro.launch.serve`).

Batched prefill, KV/SSM cache management, greedy decode, and simple
continuous batching (the request queue is served `--batch` prompts at a
time; the last batch is padded with its last prompt). Same flags and the
same result JSON as the reference, plus `--device` (default `cuda`; `cpu`
runs without a card). The CLI runs the arch's smoke config, as the
reference does; `serve()` takes any `LM` and parameters.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-4b \
      --requests 6 --batch 2 --prompt-len 16 --gen 24 --device cpu
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.obs import log


def grow_cache(cache: dict, S_max: int) -> dict:
    """The prefill's KV cache [L, B, S, KV, hd] zero-padded to S_max along
    S; SSM and conv states as they are."""
    out = {}
    for k, v in cache.items():
        if k in ("k", "v"):
            pad = v.new_zeros(v.shape[:2] + (S_max - v.shape[2],)
                              + v.shape[3:])
            v = torch.cat([v, pad], dim=2)
        out[k] = v
    return out


@torch.inference_mode()
def serve(lm, params, *, requests: int, batch: int, prompt_len: int,
          gen: int, seed: int = 0) -> dict:
    """Greedy-decode `requests` random prompts (numpy `RandomState(seed)`)
    of `prompt_len` tokens, `gen` tokens each, `batch` at a time, on the
    device of `params`. Returns {"served": one token list per request,
    "tokens_per_s", "wall_s"}; the wall ends after the device has
    finished."""
    cfg = lm.cfg
    if cfg.frontend == "frames":
        raise SystemExit("encoder-only arch has no decode path")
    dev = params["embed"]["embedding"].device
    B, P, G = batch, prompt_len, gen
    S_max = P + G + (cfg.n_patches if cfg.frontend == "patches" else 0)
    rng = np.random.RandomState(seed)
    queue = [rng.randint(0, cfg.vocab, size=(P,)).astype(np.int32)
             for _ in range(requests)]

    served, t0 = [], time.perf_counter()
    while queue:
        prompts = [queue.pop(0) for _ in range(min(B, len(queue)))]
        while len(prompts) < B:                   # pad the last batch
            prompts.append(prompts[-1])
        toks = torch.from_numpy(np.stack(prompts)).to(dev)
        if cfg.frontend == "patches":
            inputs = {"patches": torch.zeros((B, cfg.n_patches,
                                              cfg.patch_dim), device=dev),
                      "tokens": toks}
            base = cfg.n_patches + P
        else:
            inputs = {"tokens": toks}
            base = P
        logits, cache = lm.prefill(params, inputs)
        cache = grow_cache(cache, S_max)
        out = []
        tok = torch.argmax(logits[:, -1, :], -1)[:, None]
        for g in range(G):
            out.append(tok[:, 0])
            logits, cache = lm.decode_step(params, cache, tok, base + g)
            tok = torch.argmax(logits[:, 0, :], -1)[:, None]
        for row in torch.stack(out, dim=1).cpu().numpy():
            served.append(row.tolist())
        log.status(f"[serve] batch done: {len(served)}/{requests} "
                   f"t={time.perf_counter()-t0:.1f}s")
    wall = time.perf_counter() - t0   # .cpu() above waited for the device
    return {"served": served[:requests], "tokens_per_s": requests * G / wall,
            "wall_s": wall}


def main(argv=None):
    from repro_torch import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import LM

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-4b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda | cpu); cuda without a card "
                         "raises")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress status lines (final JSON still printed)")
    args = ap.parse_args(argv)
    log.set_quiet(args.quiet)

    device = resolve_device(args.device)
    cfg = get_config(args.arch).smoke()
    if cfg.frontend == "frames":
        raise SystemExit("encoder-only arch has no decode path")
    lm = LM(cfg, dtype=torch.float32, remat=False)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = lm.init(gen, device)
    res = serve(lm, params, requests=args.requests, batch=args.batch,
                prompt_len=args.prompt_len, gen=args.gen, seed=args.seed)
    print(json.dumps({"arch": args.arch, "requests": args.requests,
                      "tokens_per_s": round(res["tokens_per_s"], 1),
                      "sample": res["served"][0][:8]}))


if __name__ == "__main__":
    main()
