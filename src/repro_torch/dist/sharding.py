"""Partition rules for the (pod, data, model) mesh, and their DTensor
layouts (PyTorch port of `repro.dist.sharding`).

One rule table covers every assigned family (dense, MoE, SSM, hybrid,
audio, vlm); it is the reference's, copied as it is:

  params   FSDP over `data` on the d_model ("in") dim, tensor parallel over
           `model` on the feature ("out") dim; transpose layout for the
           output projections (wo / w_down / fc2 / out_proj). The embedding
           shards vocab over `model` and d_model over `data`. MoE experts
           are [L, E, d(fsdp), f(model)] / w_down transposed, router
           replicated.
  opt      mirrors the param layout leaf-for-leaf; scalar counters
           replicate.
  batch    leading (batch) dim over the batch axes, rest replicated.
  cache    KV cache [L, B, S, KV, hd]: batch over the batch axes and the
           SEQUENCE dim over `model` (flash-decoding layout); SSM state is
           batch-sharded only.

Every rule is guarded by divisibility: an axis that does not evenly divide
its dim (or has size 1) is dropped (replicated). `fsdp_axis` may be a tuple
of mesh axes and `model_axis` may be None.

A spec (`P`) is a tuple with one entry per tensor dim, each a mesh axis
name, a tuple of names or None: the entries of the reference's
`PartitionSpec`. The rule functions need only the mesh's {name: size}
shape, so they take a `DeviceMesh` or anything whose `.shape` is such a
dict. `placements` turns a spec into DTensor placements, one per mesh dim;
`distribute` lays a parameter tree out as DTensors whose local shards are
views of ONE flat local buffer (`flat_local`), the layout the optimizer
updates with one kernel launch per rank.
"""
from __future__ import annotations

import logging
import math

import torch

# DTensor warns on every redistribute over nested mesh dims that it takes
# one collective per dim; the port's layouts do that on purpose
logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
    logging.ERROR)

_FSDP, _TP = "fsdp", "tp"

# Projections whose kernel is [in(d_model → fsdp), out(features → tp)].
_IN_KERNELS = ("wq", "wk", "wv", "w_gate", "w_up", "fc1", "in_proj",
               "head", "frontend", "patch_proj", "wi", "wh")
# Output projections: [in(features → tp), out(d_model → fsdp)].
_OUT_KERNELS = ("wo", "w_down", "fc2", "out_proj")
# Cache leaves carrying a sequence dim at index 2 ([L, B, S, ...]).
_SEQ_CACHE = ("k", "v", "k_scale", "v_scale")


class P(tuple):
    """A partition spec: one entry per tensor dim (axis name, tuple of
    names, or None). A one-name tuple is stored as the name, as
    `PartitionSpec` stores it."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, (tuple, list)) and len(e) == 1
            else tuple(e) if isinstance(e, list) else e for e in entries))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def _with_paths(tree, path=()):
    """[(path, leaf)] of a nested dict, keys sorted at every level (the
    reference's flatten order)."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in _with_paths(tree[k], path + (str(k),))]
    return [(path, tree)]


def _map(fn, tree, path=()):
    """A dict shaped like `tree` with fn(path, leaf) at every leaf."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, path + (str(k),)) for k, v in tree.items()}
    return fn(path, tree)


def _roles(names: tuple[str, ...]) -> tuple:
    """Trailing-dim role tags for one param leaf; leading dims (the [L, ...]
    layer stack, the MoE [E, ...] expert dim) are padded to replicated."""
    last = names[-1] if names else ""
    parent = names[-2] if len(names) > 1 else ""
    if last == "embedding":
        return (_TP, _FSDP)                      # [V(model), d(data)]
    if parent == "moe":                          # raw [E, d, f] expert stacks
        if last in ("w_gate", "w_up"):
            return (_FSDP, _TP)
        if last == "w_down":
            return (_TP, _FSDP)
        return ()                                # router handled via "kernel"
    if last == "kernel":
        if parent in _IN_KERNELS:
            return (_FSDP, _TP)
        if parent in _OUT_KERNELS:
            return (_TP, _FSDP)
    return ()                                    # norms, biases, SSM scalars,
                                                 # router: replicated


def mesh_shape(mesh) -> dict:
    """{axis name: size} of a `DeviceMesh`, or `mesh.shape` when it is
    already such a dict (anything with a dict `.shape` stands in for a
    mesh where only its shape matters)."""
    shape = mesh.shape
    if isinstance(shape, dict):
        return dict(shape)
    return dict(zip(mesh.mesh_dim_names, shape))


def batch_axes_for(mesh) -> tuple[str, ...]:
    """Batch shards over pod+data when the pod axis exists."""
    return tuple(a for a in ("pod", "data") if a in mesh_shape(mesh))


def _axis_size(axis, mesh) -> int | None:
    """Total shard count of a mesh-axis entry (str or tuple); None if any
    named axis is absent from this mesh."""
    shape = mesh_shape(mesh)
    axes = axis if isinstance(axis, (tuple, list)) else (axis,)
    n = 1
    for a in axes:
        if a not in shape:
            return None
        n *= shape[a]
    return n


def _fit(axis, dim: int, mesh):
    """The axis entry if it exists and evenly divides `dim`, else None."""
    if axis is None:
        return None
    n = _axis_size(axis, mesh)
    if n is None or n <= 1 or dim % n != 0:
        return None
    return tuple(axis) if isinstance(axis, (tuple, list)) else axis


def _resolve(roles: tuple, shape, mesh, fsdp_axis, model_axis) -> P:
    ndim = len(shape)
    roles = roles[-ndim:] if len(roles) > ndim else roles
    roles = (None,) * (ndim - len(roles)) + tuple(roles)
    entries = []
    for dim, role in zip(shape, roles):
        axis = fsdp_axis if role == _FSDP else \
            model_axis if role == _TP else None
        entries.append(_fit(axis, dim, mesh))
    return P(*entries)


# ------------------------------------------------------------------- params
def param_specs(params, mesh, *, fsdp_axis="data", model_axis="model"):
    """Spec tree mirroring `params` (tensors of any device, `meta`
    included, or DTensors: only `.shape` is read)."""
    return _map(lambda path, leaf: _resolve(_roles(path), tuple(leaf.shape),
                                            mesh, fsdp_axis, model_axis),
                params)


# -------------------------------------------------------------------- opt
def opt_state_specs(opt_state, pspecs, mesh):
    """Optimizer-state specs: a param-shaped sub-tree, or the port's flat
    per-coordinate buffer (`mu`, `m`, `v`: one tensor of the params' total
    size, laid out as the params' local shards), inherits the param
    layout; everything else (step counters) replicates."""
    del mesh  # shapes match params, so the divisibility guard carries over
    pleaves = _with_paths(pspecs)
    keys = [path for path, _ in pleaves]

    def one(sub):
        if isinstance(sub, dict) and \
                [p for p, _ in _with_paths(sub)] == keys:
            return pspecs
        if isinstance(sub, dict):
            return {k: one(v) for k, v in sub.items()}
        if isinstance(sub, torch.Tensor) and sub.dim() == 1:
            return pspecs              # the flat per-coordinate buffer
        return P(*[None] * getattr(sub, "ndim", 0))

    if isinstance(opt_state, dict):
        return {k: one(v) for k, v in opt_state.items()}
    return one(opt_state)


# ------------------------------------------------------------------- batch
def batch_specs(batch, mesh, *, batch_axes=("data",)):
    """Shard every leaf's leading dim over `batch_axes` when divisible."""
    shape_of = mesh_shape(mesh)
    baxes = tuple(a for a in batch_axes if a in shape_of)
    n = _axis_size(baxes, mesh) if baxes else 1

    def one(_, leaf):
        shape = tuple(leaf.shape)
        if shape and n and n > 1 and shape[0] % n == 0:
            return P(baxes, *[None] * (len(shape) - 1))
        return P(*[None] * len(shape))

    return _map(one, batch)


# ------------------------------------------------------------------- cache
def cache_specs(cache, mesh, *, batch_axes=("data",), seq_axis="model"):
    """Decode/prefill cache layout: [L, B(batch), S(model), ...] for KV
    leaves (flash-decoding: the length-S reduction is sequence-sharded over
    `model`), batch-only for SSM state/conv leaves."""
    shape_of = mesh_shape(mesh)
    baxes = tuple(a for a in batch_axes if a in shape_of)
    nb = _axis_size(baxes, mesh) if baxes else 1

    def one(path, leaf):
        shape = tuple(leaf.shape)
        entries = [None] * len(shape)
        if len(shape) >= 2 and nb and nb > 1 and shape[1] % nb == 0:
            entries[1] = baxes
        if path and path[-1] in _SEQ_CACHE and len(shape) >= 3:
            entries[2] = _fit(seq_axis, shape[2], mesh)
        return P(*entries)

    return _map(one, cache)


def strip_axes(spec: P, axes) -> P:
    """Remove mesh axes in `axes` from a spec (→ gather them)."""
    drop = set(axes)

    def one(entry):
        if entry is None:
            return None
        names = tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)
        kept = tuple(a for a in names if a not in drop)
        if not kept:
            return None
        return kept[0] if len(kept) == 1 else kept

    return P(*[one(e) for e in spec])


# -------------------------------------------------------------- placements
def placements(spec, mesh) -> tuple:
    """DTensor placements of `spec` on `mesh`: per mesh dim, Shard(d) for
    the tensor dim d whose entry names it, else Replicate().

    A tuple entry shards one tensor dim over several mesh dims. DTensor
    nests such shards in mesh-dim order (the first mesh dim outermost),
    which is the reference's layout only when the tuple lists its axes in
    mesh order; anything else is refused."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"spec entry {entry!r} is not in mesh order "
                             f"{tuple(names)}")
        for i in order:
            out[i] = Shard(dim)
    return tuple(out)


def local_shape(shape, placements_, mesh) -> tuple:
    """Shape of this rank's shard (every shard divides evenly: `_fit`)."""
    from torch.distributed.tensor import Shard
    shape = list(shape)
    for i, pl in enumerate(placements_):
        if isinstance(pl, Shard):
            shape[pl.dim] //= mesh.size(i)
    return tuple(shape)


def _local_chunk(t: torch.Tensor, placements_, mesh) -> torch.Tensor:
    """This rank's shard of a full tensor, nested in mesh-dim order."""
    from torch.distributed.tensor import Shard
    coord = mesh.get_coordinate()
    for i, pl in enumerate(placements_):
        if isinstance(pl, Shard):
            t = t.chunk(mesh.size(i), dim=pl.dim)[coord[i]]
    return t


def distribute(tree, specs, mesh, *, dtype=None, device=None):
    """Lay `tree` (a nested dict of tensors) out on `mesh` by `specs`:
    a dict of DTensors whose local shards are views of one flat local
    buffer in flatten order (one buffer per leaf when the leaves' dtypes
    differ and no `dtype` is given). A full tensor contributes its local
    chunk; a `meta` tensor only its shape (the shard is left
    uninitialised, as the dry run wants). `dtype`/`device` default to the
    leaves'."""
    from torch.distributed.tensor import DTensor
    leaves = _with_paths(tree)
    spec_of = dict(_with_paths(specs))
    first = leaves[0][1]
    if dtype is None and len({leaf.dtype for _, leaf in leaves}) > 1:
        # mixed dtypes (a batch of tokens and features): one buffer each
        out: dict = {}
        for path, leaf in leaves:
            node = out
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = distribute(
                {"x": leaf}, {"x": spec_of[path]}, mesh, device=device)["x"]
        return out
    dtype = dtype or first.dtype
    if device is None:
        device = torch.device(mesh.device_type) if first.is_meta \
            else first.device
    layout = []
    for path, leaf in leaves:
        pl = placements(spec_of[path], mesh)
        layout.append((path, leaf, pl, local_shape(leaf.shape, pl, mesh)))
    n = sum(math.prod(ls) for *_, ls in layout)
    flat = torch.empty(n, dtype=dtype, device=device)
    out: dict = {}
    pos = 0
    for path, leaf, pl, ls in layout:
        k = math.prod(ls)
        view = flat[pos:pos + k].view(ls)
        pos += k
        if not leaf.is_meta:
            view.copy_(_local_chunk(leaf, pl, mesh))
        dt = DTensor.from_local(view, mesh, pl, run_check=False,
                                shape=tuple(leaf.shape),
                                stride=_contiguous_stride(leaf.shape))
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = dt
    return out


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for s in reversed(tuple(shape)):
        stride.append(acc)
        acc *= s
    return tuple(reversed(stride))


def to_local(t):
    """The local tensor of a DTensor (a view, no copy); a plain tensor as
    it is."""
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def flat_local(tree) -> torch.Tensor | None:
    """The one flat local buffer whose views are the tree's local shards
    in flatten order (`distribute`, `LM.init`, `params_from_jax` all lay
    parameters out so), or None if they are not such views."""
    leaves = [to_local(leaf) for _, leaf in _with_paths(tree)]
    first = leaves[0]
    base = first.untyped_storage()._cdata      # also for fake tensors
    pos = start = first.storage_offset()
    for leaf in leaves:
        if leaf.untyped_storage()._cdata != base or \
                leaf.storage_offset() != pos or not leaf.is_contiguous():
            return None
        pos += leaf.numel()
    return first.as_strided((pos - start,), (1,), start)


def gather_replicated(t, *, keep=()):
    """A DTensor gathered over every mesh dim but those in `keep`, as its
    local tensor: a dim in `keep` that shards the tensor keeps the rank's
    shard (the tp layout keeps its `model` feature shards so); every other
    dim becomes Replicate(). The gradient of the result is taken as a
    per-rank partial sum on every dim but the kept shards, so it returns
    to the DTensor's own layout by reduce-scatter (Shard) or all-reduce
    (Replicate). A plain tensor is returned as it is."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if not isinstance(t, DTensor):
        return t
    mesh = t.device_mesh
    names = mesh.mesh_dim_names
    kept = [names[i] in keep and isinstance(pl, Shard)
            for i, pl in enumerate(t.placements)]
    target = tuple(pl if k else Replicate()
                   for k, pl in zip(kept, t.placements))
    grads = tuple(pl if k else Partial()
                  for k, pl in zip(kept, t.placements))
    return t.redistribute(mesh, target).to_local(grad_placements=grads)


__all__ = ["P", "mesh_shape", "batch_axes_for", "param_specs",
           "opt_state_specs", "batch_specs", "cache_specs", "strip_axes",
           "placements", "local_shape", "distribute", "to_local",
           "flat_local", "gather_replicated"]
