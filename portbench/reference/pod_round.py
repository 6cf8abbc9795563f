"""FedLuck's datacenter pod round, plain PyTorch: P pods start from the
global model w; pod p runs k momentum-SGD steps (its momentum buffer
carried from round to round) on its own batches and ships
acc_p = (w − w_p,k) + r_p, compressed at density δ with error feedback:

  compact wire  per shard of the padded vector, blocks of `blk`, each
                shipping at most `budget` = round(δ·blk) survivors of one
                threshold solved over the shard for n_blocks·budget keeps
  dense wire    one threshold over the whole padded vector for
                round(δ·n) keeps

r_p ← acc_p − shipped_p, and Eq. 6: w ← w − η_g · (Σ_p shipped_p) / P.
"""
from __future__ import annotations

import torch

from portbench.reference import compress


def run(model, cfg: dict, tr: dict, w0: torch.Tensor, batch_of, rounds: int,
        prec, observe, *, padded: int) -> None:
    """Run `rounds` rounds of the LM whose reference is `model` (the
    configuration's) from w0 [d]; `batch_of(r, p, i)` gives the
    (tokens, labels) of round r, pod p, step i; after each round
    `observe(r, w, mus, residuals, losses)` sees the state (w [d],
    mus [d] per pod, residuals [padded] per pod, mean loss per pod)."""
    sp = model.spec(cfg)
    d = w0.numel()
    P, k, lr, m = tr["pods"], tr["local_k"], tr["lr"], tr["momentum"]
    shards, blk = tr["shards"], tr["blk"]
    budget = max(1, min(blk, round(tr["rate"] * blk)))
    w = w0.clone()
    mus = [torch.zeros_like(w0) for _ in range(P)]
    res = [torch.zeros(padded, device=w0.device) for _ in range(P)]
    for r in range(rounds):
        upd = torch.zeros(padded, device=w0.device)
        losses = []
        for p in range(P):
            wp, pl = w.clone(), []
            for i in range(k):
                tokens, labels = batch_of(r, p, i)
                wt = wp.detach().requires_grad_(True)
                lo = model.loss(wt, sp, cfg, tokens, labels, prec)
                g, = torch.autograd.grad(lo, wt)
                mus[p] = mus[p] * m + g
                wp = wp - lr * mus[p]
                pl.append(float(lo.detach()))
                del wt, lo, g
            acc = res[p].clone()
            acc[:d] += w - wp
            del wp
            if tr["wire"] == "compact":
                n = padded // shards
                shipped, new = zip(*(compress.compact_wire(
                    acc[s * n:(s + 1) * n], blk, budget)
                    for s in range(shards)))
                shipped, res[p] = torch.cat(shipped), torch.cat(new)
            else:
                shipped, res[p] = compress.dense_wire(
                    acc, compress.num_keep(padded, tr["rate"]))
            upd += shipped
            losses.append(sum(pl) / k)
            del acc, shipped
        w = w - tr["eta_g"] * (upd / P)[:d]
        del upd
        observe(r, w, mus, res, losses)
