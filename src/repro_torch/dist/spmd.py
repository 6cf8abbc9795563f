"""Shard-local regions: the explicit collectives the LM's mesh path runs on
`to_local()` tensors (the port's counterpart of the reference's
`shard_map` regions and GSPMD's inserted collectives).

Inside a region every rank holds its tokens — a batch shard over the
batch axes and, with sequence parallelism, a sequence chunk over the
sequence axis — and computes on plain local tensors. Weights arrive by
`sharding.gather_replicated` (an all-gather whose gradient reduce-scatters
back to the at-rest shards) over their FSDP axes only: a feature dim the
tensor-parallel axes shard stays this rank's shard. Every value a rank
computes on more tokens or more features than its own (a block's input
gathered along the sequence, a head's q/k/v gathered over the tp axes,
the SSM scan on every tp rank, a global MoE dispatch) feeds only this
rank's own disjoint slice onward — its tokens, or its feature columns —
so each rank's gradient is a partial sum and the collectives below sum
those partials:

  gather          all-gather along a tensor dim over mesh axes (backward:
                  reduce-scatter)
  shard           this rank's chunk along a tensor dim (backward: the
                  gradient zero-padded to full size)
  reduce_scatter  sum over mesh axes, keep this rank's chunk (backward:
                  all-gather)
  all_reduce      sum (backward: sum) or max (no gradient) over mesh axes
  column_parallel x @ kernel for an input projection whose output
                  features the tp axes may shard: the rank's columns
  row_parallel    y @ kernel for an output projection whose input
                  features the tp axes may shard: the partial sums
                  reduced over the tp axes (Region.seq_out), the bias
                  added once after

Sequence parallelism is Megatron's: the residual stream keeps the rank's
S chunk between blocks, each block's input is all-gathered along S once
(Region.seq_in) and each row-parallel output is reduce-scattered back.

A collective over a size-1 axis is an identity, and it runs all the same:
a one-rank mesh takes the path of any other mesh.
"""
from __future__ import annotations

import math
import warnings

import torch


def _funcol():
    import torch.distributed._functional_collectives as funcol
    return funcol


def _axes(mesh, axes) -> list[str]:
    """The named axes, in mesh order."""
    names = list(mesh.mesh_dim_names)
    axes = [axes] if isinstance(axes, str) else list(axes or ())
    return sorted(axes, key=names.index)


def axes_size(mesh, axes) -> int:
    names = list(mesh.mesh_dim_names)
    return math.prod(mesh.size(names.index(a)) for a in _axes(mesh, axes))


def axes_rank(mesh, axes) -> int:
    """This rank's index among the `axes` shards (nested in mesh order)."""
    names = list(mesh.mesh_dim_names)
    r = 0
    for a in _axes(mesh, axes):
        r = r * mesh.size(names.index(a)) + mesh.get_local_rank(a)
    return r


def _wait(t):
    fc = _funcol()
    return fc.wait_tensor(t) if isinstance(t, fc.AsyncCollectiveTensor) \
        else t


def gather(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """All-gather `x` along `dim` over `axes` (nested in mesh order);
    the backward reduce-scatters the gradient."""
    fc = _funcol()
    dim %= x.ndim
    ag = getattr(fc, "all_gather_single_autograd", None) \
        or fc.all_gather_tensor_autograd
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        for a in reversed(_axes(mesh, axes)):       # innermost first
            x = _wait(ag(x.contiguous(), dim, mesh.get_group(a)))
    return x


def reduce_scatter(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """Sum `x` over `axes` and keep this rank's chunk along `dim`; the
    backward all-gathers the gradient."""
    fc = _funcol()
    dim %= x.ndim
    rs = getattr(fc, "reduce_scatter_single_autograd", None) \
        or fc.reduce_scatter_tensor_autograd
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        for a in _axes(mesh, axes):                 # outermost first
            x = _wait(rs(x.contiguous(), "sum", dim, mesh.get_group(a)))
    return x


def shard(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """This rank's chunk of `x` along `dim` over `axes`."""
    names = list(mesh.mesh_dim_names)
    for a in _axes(mesh, axes):
        x = x.chunk(mesh.size(names.index(a)), dim=dim)[
            mesh.get_local_rank(a)]
    return x


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return _all_reduce(x, mesh, axes, "sum")

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh, ctx.axes, "sum"), None, None


def _all_reduce(x, mesh, axes, op: str):
    fc = _funcol()
    for a in _axes(mesh, axes):
        x = _wait(fc.all_reduce(x.contiguous(), op, mesh.get_group(a)))
    return x


def all_reduce(x: torch.Tensor, mesh, axes, op: str = "sum"
               ) -> torch.Tensor:
    """Sum (differentiable: the gradient is summed too) or max over
    `axes`."""
    if not axes or not _axes(mesh, axes):
        return x
    if op == "sum":
        return _AllReduceSum.apply(x, mesh, tuple(_axes(mesh, axes)))
    return _all_reduce(x.detach(), mesh, axes, op)


def column_parallel(p: dict, x: torch.Tensor, region, full: int, *,
                    dtype=None) -> tuple[torch.Tensor, bool]:
    """`x @ kernel (+ bias)` for an input projection (kernel [in, out])
    whose `full` output features the region's tp axes may shard. x is
    the whole input row. Returns (y, split): the rank's output columns and
    whether they are a shard of the `full` ones (the replicated bias is
    then sliced to them). With `dtype`, kernel, bias and x are cast to it
    first, as `nn.linear_apply` does; `region` None is that linear."""
    k, b = p["kernel"], p.get("bias")
    if dtype is not None:
        k, x = k.to(dtype), x.to(dtype)
        b = None if b is None else b.to(dtype)
    split = is_shard(region, k.shape[-1], full)
    y = torch.matmul(x, k)
    if b is not None:
        y = y + (shard(b, region.mesh, region.tp_axes, 0) if split else b)
    return y, split


def row_parallel(p: dict, y: torch.Tensor, region, full: int, *,
                 dtype=None) -> torch.Tensor:
    """`y @ kernel (+ bias)` for an output projection (kernel [in, out])
    whose `full` input features the region's tp axes may shard. y is the
    rank's feature slice, or the whole row (then sliced to the kernel's
    rows). A shard's partial sums are reduced over the tp axes by
    `region.seq_out` (reduce-scatter along S under sequence parallelism,
    all-reduce otherwise) and a whole result is sliced to the rank's
    chunk; the bias is added once, after the reduce."""
    k, b = p["kernel"], p.get("bias")
    if dtype is not None:
        k, y = k.to(dtype), y.to(dtype)
        b = None if b is None else b.to(dtype)
    split = is_shard(region, k.shape[0], full)
    if split and y.shape[-1] == full:
        y = shard(y, region.mesh, region.tp_axes, -1)
    out = torch.matmul(y, k)
    if region is not None:
        out = region.seq_out(out, partial=split)
    return out if b is None else out + b


def is_shard(region, local: int, full: int) -> bool:
    """Whether a weight's feature dim of `local` of `full` entries is this
    rank's shard over the region's tp axes (False: it is whole)."""
    if local == full:
        return False
    if region is None or local * axes_size(region.mesh,
                                           region.tp_axes) != full:
        raise ValueError(f"a feature dim of {local} is no tp shard of "
                         f"{full}")
    return True


class Region:
    """Where an LM call's tokens live on the mesh.

    batch_axes      mesh axes the batch dim is sharded over (those that
                    exist; dropped when they do not divide B)
    seq_axes        the sequence-parallel axis, when it divides S and S > 1;
                    this rank holds positions [s0, s1)
    moe_axes        the MoE's shard-local dispatch is on (the reference's
                    `moe_dispatch_axes`)
    dup             ranks holding the same tokens (the mesh size over the
                    batch and sequence shard counts): each rank's loss is
                    divided by it, so the partial losses sum to the loss
    cache_seq_axes  axes a decode cache's sequence dim is sharded over
                    (`cache_layout`); this rank holds positions
                    [cache_s0, cache_s0 + local length) of cache_len
    tp_axes         the tensor-parallel axis (`tp_axis`, when the mesh
                    has it): weights keep their feature shards over it;
                    tp_size ranks, this one tp_rank
    """

    def __init__(self, mesh, *, B: int, S: int, batch_axes, seq_axis,
                 moe_axes, tp_axis=None):
        self.mesh = mesh
        names = mesh.mesh_dim_names
        baxes = [a for a in (batch_axes or ()) if a in names]
        self.batch_axes = _axes(mesh, baxes) \
            if B % axes_size(mesh, baxes) == 0 else []
        seq = [seq_axis] if seq_axis in names else []
        self.seq_axes = _axes(mesh, seq) \
            if S > 1 and S % axes_size(mesh, seq) == 0 else []
        if set(self.seq_axes) & set(self.batch_axes):
            raise ValueError(f"sequence axis {seq_axis!r} also shards the "
                             f"batch {self.batch_axes}")
        self.moe_axes = bool(moe_axes)
        self.dup = mesh.size() // (axes_size(mesh, self.batch_axes)
                                   * axes_size(mesh, self.seq_axes))
        self.S = S
        n = axes_size(mesh, self.seq_axes)
        i = axes_rank(mesh, self.seq_axes)
        self.s0, self.s1 = i * S // n, (i + 1) * S // n
        self.cache_seq_axes, self.cache_len, self.cache_s0 = [], None, 0
        self.tp_axes = _axes(mesh, [tp_axis] if tp_axis in names else [])
        if set(self.tp_axes) & set(self.batch_axes):
            raise ValueError(f"tp axis {tp_axis!r} also shards the batch")
        self.tp_size = axes_size(mesh, self.tp_axes)
        self.tp_rank = axes_rank(mesh, self.tp_axes)

    @property
    def token_axes(self) -> list[str]:
        return self.batch_axes + self.seq_axes

    def seq_in(self, h: torch.Tensor) -> torch.Tensor:
        """A block's input [B, S_chunk, ...]: the rank's chunk all-gathered
        along S over the sequence axes (once per block input)."""
        return gather(h, self.mesh, self.seq_axes, 1)

    def seq_out(self, y: torch.Tensor, *, partial: bool) -> torch.Tensor:
        """A value computed on the whole sequence (`seq_in`'s) back to the
        rank's S chunk. `partial`: y is a partial sum over the tp axes,
        reduce-scattered along S over the sequence axes among them and
        all-reduced over the others; else y is whole and sliced."""
        tp = self.tp_axes if partial else []
        seq_tp = [a for a in self.seq_axes if a in tp]
        y = reduce_scatter(y, self.mesh, seq_tp, 1)
        y = all_reduce(y, self.mesh, [a for a in tp if a not in seq_tp])
        return shard(y, self.mesh,
                     [a for a in self.seq_axes if a not in seq_tp], 1)

    def tp_gather(self, y: torch.Tensor, split: bool) -> torch.Tensor:
        """A column-parallel output's features gathered over the tp axes
        (only activations move); a whole one as it is."""
        return gather(y, self.mesh, self.tp_axes, -1) if split else y

    def placements(self, batch_dim: int = 0, seq_dim: int | None = None):
        """DTensor placements of a tensor whose `batch_dim` (and
        `seq_dim`) are laid out as this region's tokens."""
        from torch.distributed.tensor import Replicate, Shard
        return tuple(Shard(batch_dim) if n in self.batch_axes else
                     Shard(seq_dim) if seq_dim is not None
                     and n in self.seq_axes else Replicate()
                     for n in self.mesh.mesh_dim_names)

    def cache_layout(self, k) -> None:
        """Read the decode cache's layout off its "k" leaf (a DTensor
        [L, B, S, ...]): its batch axes must be the tokens', its sequence
        axes are where the flash-decoding partial softmax combines."""
        from torch.distributed.tensor import Shard
        names = self.mesh.mesh_dim_names
        on = lambda dim: _axes(self.mesh, [
            names[i] for i, pl in enumerate(k.placements)
            if isinstance(pl, Shard) and pl.dim == dim])
        # the same rows: equal shard counts and this rank's index among
        # them (a size-1 axis shards nothing, as `sharding._fit` drops it)
        if (axes_size(self.mesh, on(1)), axes_rank(self.mesh, on(1))) != \
                (axes_size(self.mesh, self.batch_axes),
                 axes_rank(self.mesh, self.batch_axes)):
            raise ValueError(f"cache batch axes {on(1)} differ from the "
                             f"tokens' {self.batch_axes}")
        self.cache_seq_axes = on(2)
        self.cache_len = k.shape[2]
        self.cache_s0 = k.to_local().shape[2] * axes_rank(
            self.mesh, self.cache_seq_axes)

    def local_batch(self, t) -> torch.Tensor:
        """This rank's batch shard (full sequence) of a global batch leaf:
        a DTensor (any layout) or a plain tensor holding the whole
        batch."""
        from torch.distributed.tensor import DTensor
        if isinstance(t, DTensor):
            return t.redistribute(self.mesh, self.placements()).to_local()
        return shard(t, self.mesh, self.batch_axes, 0)

    def global_out(self, local: torch.Tensor, shape):
        """A batch-sharded local result as a DTensor of global `shape`."""
        from torch.distributed.tensor import DTensor

        from repro_torch.dist.sharding import _contiguous_stride
        return DTensor.from_local(local, self.mesh, self.placements(),
                                  run_check=False, shape=tuple(shape),
                                  stride=_contiguous_stride(shape))
