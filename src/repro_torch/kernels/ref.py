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
