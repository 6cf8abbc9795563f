"""Error-feedback top-k compression and the two pod-sync wires, plain
PyTorch (FedLuck Eq. 4-6 with the EF carry r' = (g + r) − kept).

  topk_ef            exact top-k of |g + r| (ties by lower index)
  threshold          the histogram threshold: a coarse pass over
                     power-of-two edges below max|acc|, then a fine linear
                     pass inside the bracket; t is the largest edge that
                     at least k magnitudes reach (one count per edge,
                     |acc| >= edge)
  threshold_ef       keep |acc| >= t; where more than k reach it, the k
                     largest of them (ties by lower index)
  compact_wire       per block of `blk`, the survivors |acc| >= t in index
                     order, up to `budget` of them (t solved over the whole
                     shard for n_blocks · budget keeps)
  dense_wire         keep |acc| >= t, t solved over the whole vector
"""
from __future__ import annotations

import torch


def num_keep(d: int, rate: float) -> int:
    return max(1, min(d, int(round(rate * d))))


def _first_index(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries of x, ties by lower index."""
    return torch.sort(x, descending=True, stable=True).indices[:k]


def topk_ef(g: torch.Tensor, r: torch.Tensor, k: int):
    """(kept, new residual) of the EF accumulator g + r."""
    acc = g + r
    kept = torch.zeros_like(acc)
    idx = _first_index(acc.abs(), k)
    kept[idx] = acc[idx]
    return kept, acc - kept


def _counts(mag: torch.Tensor, edges: torch.Tensor) -> list:
    return [int((mag >= e).sum()) for e in edges]


def _bracket(counts: list, edges: torch.Tensor, k: int):
    sel = next((i for i, c in enumerate(counts) if c >= k), len(counts) - 1)
    return edges[sel], edges[max(sel - 1, 0)]


def threshold(acc: torch.Tensor, k: int, coarse: int = 48,
              fine: int = 128) -> torch.Tensor:
    mag = acc.abs()
    dev = acc.device
    gmax = mag.max() + 1e-30
    j = torch.arange(coarse + 1, dtype=torch.float32, device=dev)
    edges = gmax * torch.exp2(-j)
    lo, hi = _bracket(_counts(mag, edges), edges, k)
    frac = torch.arange(fine + 1, dtype=torch.float32, device=dev) / fine
    fine_edges = torch.clamp(hi - (hi - lo) * frac, min=1e-30)
    _, t = _bracket(_counts(mag, fine_edges), fine_edges, k)
    return t


def threshold_ef(g: torch.Tensor, r: torch.Tensor, k: int):
    acc = g + r
    mag = acc.abs()
    keep = mag >= threshold(acc, k)
    if int(keep.sum()) > k:
        key = torch.where(keep, mag, torch.full_like(mag, -torch.inf))
        keep = torch.zeros_like(keep)
        keep[_first_index(key, k)] = True
    kept = torch.where(keep, acc, torch.zeros_like(acc))
    return kept, acc - kept


def compact_wire(acc: torch.Tensor, blk: int, budget: int):
    """(shipped, new residual) of a shard acc [n] split in blocks."""
    nb = acc.numel() // blk
    t = threshold(acc, nb * budget)
    a = acc.view(nb, blk)
    keep = a.abs() >= t
    rank = torch.cumsum(keep.to(torch.int64), dim=1) - keep.to(torch.int64)
    shipped = torch.where(keep & (rank < budget), a, torch.zeros_like(a))
    return shipped.reshape(-1), acc - shipped.reshape(-1)


def dense_wire(acc: torch.Tensor, k: int):
    kept = torch.where(acc.abs() >= threshold(acc, k), acc,
                       torch.zeros_like(acc))
    return kept, acc - kept
