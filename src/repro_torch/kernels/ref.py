"""Plain PyTorch versions of the port's kernels (the oracles the kernels are
held against, and what each wrapper runs for a CPU tensor). Same math as
`repro.kernels.ref`, except that counts come back as integers."""
from __future__ import annotations

import torch


def ref_magnitude_hist(g: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """counts_ge[j] = #{ |g| >= edges[j] }, int32[n_edges]."""
    mag = g.to(torch.float32).abs()
    ge = mag[None, :] >= edges.to(torch.float32)[:, None]
    return ge.sum(dim=1, dtype=torch.int64).to(torch.int32)


def ref_ef_topk(g: torch.Tensor, residual: torch.Tensor,
                threshold: torch.Tensor) -> tuple:
    """(out, new_residual, nnz): acc = g + r, keep = |acc| >= t,
    out = acc·keep, r' = acc − out; nnz is an int32 scalar tensor."""
    acc = g.to(torch.float32) + residual.to(torch.float32)
    keep = acc.abs() >= threshold.to(torch.float32)
    out = torch.where(keep, acc, torch.zeros((), dtype=torch.float32,
                                             device=acc.device))
    res = acc - out
    return (out.to(g.dtype), res.to(residual.dtype),
            keep.sum(dtype=torch.int64).to(torch.int32))


def ref_fused_momentum(w: torch.Tensor, mu: torch.Tensor, g: torch.Tensor, *,
                       lr: float, momentum: float = 0.9) -> tuple:
    """(w', mu') with mu' = m·mu + g, w' = w − lr·mu' (math in fp32)."""
    mu_new = momentum * mu.to(torch.float32) + g.to(torch.float32)
    w_new = w.to(torch.float32) - lr * mu_new
    return w_new.to(w.dtype), mu_new.to(mu.dtype)


def ref_compact_blocks(acc: torch.Tensor, threshold, budget: int) -> tuple:
    """(values f32[nb, budget], indices i32[nb, budget], counts i32[nb],
    residual f32[nb, blk]) for acc [nb, blk]: each block's |acc| >= t
    survivors front-packed in index order into `budget` slots, shard-flat
    indices b·blk + offset, padding slots (0.0, 0), residual acc − shipped.

    The reference packs with an argsort over a slot key; a cumsum gives
    every survivor its slot and one scatter places it, with the same
    outputs bit for bit."""
    acc = acc.to(torch.float32)
    nb, blk = acc.shape
    t = torch.as_tensor(threshold, dtype=torch.float32, device=acc.device)
    keep = acc.abs() >= t
    ki = keep.to(torch.int32)
    pos = torch.cumsum(ki, dim=1, dtype=torch.int32) - ki
    in_budget = keep & (pos < budget)
    zero = torch.zeros((), dtype=torch.float32, device=acc.device)
    shipped = torch.where(in_budget, acc, zero)
    cnt = in_budget.sum(dim=1, dtype=torch.int32)
    # survivors scatter to their slot; everything else to a spare column
    # that is cut off afterwards
    slot = torch.where(in_budget, pos, budget).to(torch.int64)
    gidx = (torch.arange(nb, dtype=torch.int32, device=acc.device)[:, None]
            * blk + torch.arange(blk, dtype=torch.int32,
                                 device=acc.device)[None, :])
    vals = torch.zeros((nb, budget + 1), dtype=torch.float32,
                       device=acc.device).scatter_(1, slot, shipped)
    idx = torch.zeros((nb, budget + 1), dtype=torch.int32,
                      device=acc.device).scatter_(1, slot, gidx)
    return (vals[:, :budget].contiguous(), idx[:, :budget].contiguous(), cnt,
            acc - shipped)
