"""Public wrappers around the port's kernels (counterpart of
`repro.kernels.ops`).

`topk_compress` is the threshold top-k pipeline:

  pass 0  gmax = max|acc|                     (torch reduction)
  pass 1  coarse log2-bucket histogram        (magnitude_hist, CUDA C++)
  pass 2  fine linear histogram inside bucket (magnitude_hist, CUDA C++)
  solve   threshold t s.t. #{|acc| >= t} ~= δ·d   (tensor ops on the device)
  pass 3  fused EF select                     (ef_topk, CUDA C++)

`compact_shard_topk` is the pod-sync shard compaction: one threshold solve
(passes 0-2) over a blocked shard [nb, blk] targeting nb·budget keeps, then
the `compact_blocks` kernel (CUDA C++) packs each block into `budget`
slots. `momentum_update` is the `fused_momentum` kernel (Triton).
`topk_compress_sparse` is `topk_compress` followed by `compact_topk`.

Every step stays on the tensor's device; nothing here synchronises with
the host.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.compact_topk import compact_blocks
from repro_torch.kernels.ef_topk import ef_topk
from repro_torch.kernels.fused_momentum import fused_momentum
from repro_torch.kernels.magnitude_hist import magnitude_hist
from repro_torch.obs.profiling import annotate


def _solve_threshold(counts_ge: torch.Tensor, edges: torch.Tensor, k):
    """(lo, hi) bracket: largest edge with count >= k and the edge above
    it. edges descending; counts_ge monotone nondecreasing."""
    reached = counts_ge >= k
    sel = reached.to(torch.uint8).argmax()       # first True (or 0 if none)
    sel = torch.where(reached.any(), sel, edges.numel() - 1)
    # `take` with a tensor index reads no value back to the host, so the
    # solve also traces under FakeTensorMode (the dry run)
    hi = torch.take(edges, torch.clamp(sel - 1, min=0))
    lo = torch.take(edges, sel)
    return lo, hi


def solve_threshold(acc: torch.Tensor, k, *, coarse_buckets: int = 48,
                    fine_buckets: int = 128, reduce=None) -> torch.Tensor:
    """Histogram-pipeline threshold t (f32 scalar tensor on acc's device)
    with #{|acc| >= t} ≈ k: two `magnitude_hist` launches.

    `reduce(x, op)` ("max" or "sum") combines the statistics of a vector
    split over processes (an all-reduce over its shards): the max and the
    integer counts combine exactly, so every shard solves the one
    threshold of the whole vector."""
    dev = acc.device
    reduce = reduce or (lambda x, op: x)
    gmax = reduce(acc.abs().max().to(torch.float32), "max") + 1e-30
    # pass 1: coarse log2 buckets (gmax·2^-j is exact)
    j = torch.arange(coarse_buckets + 1, dtype=torch.float32, device=dev)
    coarse_edges = gmax * torch.exp2(-j)
    c_counts = reduce(magnitude_hist(acc, coarse_edges), "sum")
    lo, hi = _solve_threshold(c_counts, coarse_edges, k)
    # pass 2: fine linear buckets inside [lo, hi]; separate ops (no FMA)
    frac = torch.arange(fine_buckets + 1, dtype=torch.float32,
                        device=dev) / fine_buckets
    width = hi - lo
    fine_edges = hi - width * frac                # descending hi -> lo
    fine_edges = torch.clamp(fine_edges, min=1e-30)
    f_counts = reduce(magnitude_hist(acc, fine_edges), "sum")
    _, t = _solve_threshold(f_counts, fine_edges, k)
    return t


def topk_compress(g: torch.Tensor, residual: torch.Tensor, *, rate: float,
                  coarse_buckets: int = 48, fine_buckets: int = 128):
    """Error-feedback threshold top-k at density `rate` (δ = k/d).

    Returns (out_dense, new_residual, nnz, threshold). Selection matches
    exact top-|.|-k up to threshold-resolution ties."""
    d = g.numel()
    k = max(1, min(d, int(round(rate * d))))
    # the statistics must be over the EF accumulator: pass 3 selects on
    # |g + residual|
    acc = g.to(torch.float32) + residual.to(torch.float32)
    t = solve_threshold(acc, k, coarse_buckets=coarse_buckets,
                        fine_buckets=fine_buckets)
    out, new_res, nnz = ef_topk(g, residual, t)
    return out, new_res, nnz, t


def topk_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries of x, largest first, ties broken
    by lower index first — the order `jax.lax.top_k` gives (torch.topk
    promises no order on ties)."""
    return torch.sort(x, descending=True, stable=True).indices[:k]


def compact_topk(dense: torch.Tensor, k: int):
    """Compact a dense masked vector to the (values, int32 indices) wire
    format: the k largest-|.| coordinates; when nnz(dense) <= k the extra
    slots carry zero values, so scatter-adding them onto zeros rebuilds
    `dense` exactly."""
    idx = topk_indices(dense.abs(), k)
    return dense[idx], idx.to(torch.int32)


def topk_compress_sparse(g: torch.Tensor, residual: torch.Tensor, *,
                         rate: float, coarse_buckets: int = 48,
                         fine_buckets: int = 128, slack: float = 1.05):
    """`topk_compress` returning the compact (values, indices) wire pair.

    Returns (values, indices, new_residual, nnz, threshold) with
    len(values) == min(d, int(slack·k) + 8): the histogram threshold can
    overshoot k by ties within one fine bucket, so the capacity carries a
    small slack."""
    out, new_res, nnz, t = topk_compress(
        g, residual, rate=rate, coarse_buckets=coarse_buckets,
        fine_buckets=fine_buckets)
    d = g.numel()
    k = max(1, min(d, int(round(rate * d))))
    vals, idx = compact_topk(out, min(d, int(k * slack) + 8))
    return vals, idx, new_res, nnz, t


def compact_shard_topk(acc: torch.Tensor, *, budget: int,
                       coarse_buckets: int = 48, fine_buckets: int = 128):
    """Per-shard compact top-k over a blocked EF accumulator [nb, blk].

    One histogram threshold solve over the whole shard targeting
    nb·budget keeps (two `magnitude_hist` launches), then one
    `compact_blocks` launch. Returns (values [nb, budget], indices
    [nb, budget] i32 shard-flat, counts [nb] i32, residual [nb, blk])."""
    with annotate("compact_shard_topk"):
        nb, _ = acc.shape
        acc = acc.to(torch.float32).contiguous()
        t = solve_threshold(acc.reshape(-1), nb * budget,
                            coarse_buckets=coarse_buckets,
                            fine_buckets=fine_buckets)
        return compact_blocks(acc, t, budget=budget)


def momentum_update(w: torch.Tensor, mu: torch.Tensor, g: torch.Tensor, *,
                    lr: float, momentum: float = 0.9):
    """One fused momentum-SGD step, in place on (w, mu)."""
    return fused_momentum(w, mu, g, lr=lr, momentum=momentum)
