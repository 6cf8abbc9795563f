"""Cross-pod sync: FedLuck Eq. 6 as a δ-adaptive EF top-k sparse reduce
(PyTorch port of `repro.dist.collectives`).

Each pod finishes its k local steps with a pseudo-gradient delta (Eq. 4);
the sync compresses every pod's EF accumulator (delta + residual) to
density δ and applies the server rule

    w  ←  w − η_g · mean_pods(kept)          (Eq. 6)
    r' =  (delta + r) − kept                 (error feedback)

Layout: the flat model is blocked [n_blocks, blk]; in-pod shard s owns
blocks [s·nbl, (s+1)·nbl) with nbl = n_blocks / S, S the product of the
non-pod axes. The mesh comes in one of two forms:

- its shape, a dict such as {"pod": 4, "data": 2, "model": 1}: the P pods
  and the S in-pod shards all live on one card, and the sync runs over
  them in order;
- a `DeviceMesh` over one process per (pod, in-pod shard): params,
  deltas and residuals are DTensors laid out as the reference's
  `shard_map` specs ([n_blocks(in-pod), blk] and [P(pod), n_blocks(in-pod),
  blk]), and each process works on its own shard. The compact wire
  all-gathers the payloads over `pod` and scatter-adds them in pod order;
  the dense wire sums the in-pod shards' `magnitude_hist` counts (integers,
  so every shard solves the pod's one threshold, the one-card path's),
  then all-reduces the kept values over `pod`. Residuals equal the
  one-card path's bitwise; params equal them up to the order of the
  dense wire's sum over pods.

Wire format (compact path)
--------------------------
Below the density crossover each (pod, shard) ships a compact
fixed-budget payload per owned block: `budget = block_budget(blk, δ)`
front-packed f32 values, their i32 shard-flat indices and an i32
kept-count header. One histogram threshold solve per shard
(`kernels.ops.compact_shard_topk`, targeting nbl·budget keeps) and one
`compact_blocks` launch build it; padding slots carry (0.0, 0); survivors
past the budget stay in the residual (`residual' = acc − shipped`,
bitwise). The gather over pods is the stacked [P, S, nbl, budget]
payload, and the scatter-apply adds each pod's payload with `index_add_`
in pod order, then divides by P. Within one pod the live indices are
unique, so the sum's order is fixed.

Above the crossover a dense all-reduce is cheaper and the compression only
serves the EF contract: the dense path runs the exact global threshold
pipeline (`kernels.ops.topk_compress`) per pod. "reference" is the
dense-carrier oracle of the compact selection (same thresholds and
budgets, the plain `ref_compact_blocks`, a dense mean).

Spans (`obs.profiling.annotate`): `pod_sync.compact_pack` (on one card
from the EF accumulate on), `pod_sync.all_gather` and
`pod_sync.scatter_apply` on the compact wire, `pod_sync.dense` on the
dense one; `dist.steps.make_pod_round_step` opens `pod.sync` around the
call of the sync, so they nest under it.

`CompactWire` / `all_gather_bytes` / `density_crossover` are the
wire-cost model, copied from the reference as they are.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.kernels import ef_topk, ops, ref
from repro_torch.dist.sharding import mesh_shape
from repro_torch.obs.profiling import annotate

VALUE_BYTES = 4    # fp32 payload
INDEX_BYTES = 4    # int32 shard-local flat coordinate
HEADER_BYTES = 4   # i32 kept-count per block


def block_budget(blk: int, rate: float) -> int:
    """Fixed per-block slot count of the compact wire format (also the EF
    selection cap): max(1, min(blk, round(rate·blk))). Both the wire-cost
    model and the kernel use this, so they agree by construction."""
    return max(1, min(int(blk), int(round(rate * blk))))


@dataclasses.dataclass(frozen=True)
class CompactWire:
    """Payload shape of one shard's compact sync upload."""
    n_blocks: int   # blocks this shard owns
    blk: int        # coordinates per block
    budget: int     # slots per block (block_budget)

    @property
    def dim(self) -> int:
        return self.n_blocks * self.blk

    def payload_bytes(self) -> int:
        """Bytes one shard ships to one peer: values + indices + headers."""
        return self.n_blocks * (self.budget * (VALUE_BYTES + INDEX_BYTES)
                                + HEADER_BYTES)

    def payload_bits(self) -> int:
        return 8 * self.payload_bytes()


def density_crossover(n_pods: int, *, value_bytes: int = VALUE_BYTES,
                      index_bytes: int = INDEX_BYTES) -> float:
    """Density δ* where compact all-gather bytes == dense ring all-reduce
    bytes. Compact ships (P−1)·δ·d·(val+idx) per device (headers add a
    constant ~HEADER_BYTES/blk per coordinate, negligible for blk ≫ 1);
    the ring costs 2·(P−1)/P·d·val. With 4-byte values/indices δ* = 1/P."""
    return 2.0 * value_bytes / (n_pods * (value_bytes + index_bytes))


def all_gather_bytes(dim: int, n_pods: int, rate: float, *,
                     n_blocks: int = 1, value_bytes: int = VALUE_BYTES,
                     index_bytes: int = INDEX_BYTES) -> float:
    """Per-device wire bytes of one Eq. 6 sync at density `rate` over `dim`
    coordinates in `n_blocks` blocks — the cheaper of the compact gather
    (actual payload: `block_budget` slots + count header per block) and the
    dense ring all-reduce."""
    if dim % n_blocks != 0:
        raise ValueError(f"dim={dim} not divisible by n_blocks={n_blocks}")
    blk = dim // n_blocks
    budget = block_budget(blk, rate)
    compact = (n_pods - 1) * n_blocks * (budget * (value_bytes + index_bytes)
                                         + HEADER_BYTES)
    dense = 2.0 * (n_pods - 1) / n_pods * dim * value_bytes
    return float(min(compact, dense))


def make_pod_sync(mesh, dim: int, *, rate: float, eta_g: float = 1.0,
                  n_blocks: int, wire: str = "auto"):
    """Build sync(params, deltas, residuals) -> (new_params, new_residuals).

    params     [n_blocks, blk]            global model (flat, blocked)
    deltas     [n_pods, n_blocks, blk]    per-pod Eq. 4 pseudo-gradients
    residuals  [n_pods, n_blocks, blk]    per-pod EF carry

    `mesh` is the mesh's shape, e.g. {"pod": 4, "data": 2, "model": 1},
    read as the reference reads `mesh.shape`: the pod count is
    mesh["pod"] (1 without a pod axis) and the in-pod shard count the
    product of the other axes. dim = n_blocks · blk. A `DeviceMesh` gives
    the cross-process sync (module docstring) on DTensors of the same
    global shapes.

    wire: "auto" picks "compact" below `density_crossover` and "dense"
    above; "reference" is the dense-carrier oracle of the compact
    selection. The returned fn carries `.path` (the resolved wire mode),
    `.wire` (the per-shard `CompactWire`, None on the dense path),
    `.bytes_per_device` (wire-cost model for one sync) and
    `.payload_bits_per_pod` (bits one pod's whole update occupies on the
    wire — what `dist.steps.make_pod_round_step` charges).
    """
    procs = None if isinstance(mesh, dict) else mesh
    if procs is not None:
        mesh = mesh_shape(procs)
    n_pods = int(mesh["pod"]) if "pod" in mesh else 1
    if dim % n_blocks != 0:
        raise ValueError(f"dim={dim} not divisible by n_blocks={n_blocks}")
    blk = dim // n_blocks
    inpod = tuple(a for a in mesh if a != "pod")
    n_shards = int(math.prod(mesh[a] for a in inpod)) if inpod else 1
    if wire == "auto":
        wire = ("compact" if rate < density_crossover(max(n_pods, 2))
                else "dense")
    if wire not in ("compact", "dense", "reference"):
        raise ValueError(f"unknown wire mode {wire!r}")

    budget = block_budget(blk, rate)
    if wire in ("compact", "reference"):
        if n_blocks % n_shards != 0:
            raise ValueError(f"n_blocks={n_blocks} not divisible by the "
                             f"in-pod shard count {n_shards}")
        nbl = n_blocks // n_shards      # blocks each shard owns
        k_shard = nbl * budget          # shard threshold target
        wire_fmt = CompactWire(nbl, blk, budget)
    else:
        wire_fmt = None

    if procs is not None:
        if wire == "reference":
            raise ValueError("the dense-carrier oracle runs on one card: "
                             "pass the mesh's shape dict")
        sync = _sync_across(procs, dim, n_blocks, blk, n_pods, inpod,
                            n_shards, rate=rate, eta_g=eta_g, wire=wire,
                            budget=budget)
        return _cost(sync, wire, wire_fmt, n_pods, n_shards, dim)

    def accumulate(params, deltas, residuals):
        want = (n_pods, n_blocks, blk)
        if tuple(params.shape) != want[1:] or tuple(deltas.shape) != want \
                or tuple(residuals.shape) != want:
            raise ValueError(
                f"pod sync: params {tuple(params.shape)}, deltas "
                f"{tuple(deltas.shape)}, residuals {tuple(residuals.shape)};"
                f" expected {want[1:]}, {want}, {want}")
        return deltas.to(torch.float32) + residuals.to(torch.float32)

    if wire == "compact":
        def sync(params, deltas, residuals):
            with annotate("pod_sync.compact_pack"):
                acc = accumulate(params, deltas, residuals)
                dev = acc.device
                new_res = torch.empty_like(acc)
                payloads = []
                for p in range(n_pods):
                    for s in range(n_shards):
                        own = slice(s * nbl, (s + 1) * nbl)
                        v, i, _, r = ops.compact_shard_topk(acc[p, own],
                                                            budget=budget)
                        payloads.append((v, i))
                        new_res[p, own] = r
            with annotate("pod_sync.all_gather"):
                # one card holds every pod: the gather stacks the payloads
                vals = torch.stack([v for v, _ in payloads]).view(
                    n_pods, n_shards, nbl, budget)
                idx = torch.stack([i for _, i in payloads]).view(
                    n_pods, n_shards, nbl, budget)
            with annotate("pod_sync.scatter_apply"):
                # shard-flat index -> model-flat index
                shard_base = (torch.arange(n_shards, device=dev)
                              * (nbl * blk))[:, None, None]
                upd = torch.zeros(dim, dtype=torch.float32, device=dev)
                for p in range(n_pods):
                    upd.index_add_(0, (idx[p] + shard_base).reshape(-1),
                                   vals[p].reshape(-1))
                upd = upd / n_pods
                new_p = (params - eta_g * upd.view(n_blocks, blk)) \
                    .to(params.dtype)
            return new_p, new_res.to(residuals.dtype)

    elif wire == "reference":
        def sync(params, deltas, residuals):
            acc = accumulate(params, deltas, residuals)
            accs = acc.view(n_pods, n_shards, nbl, blk)
            kept = torch.empty_like(accs)
            for p in range(n_pods):
                for s in range(n_shards):
                    a = accs[p, s]
                    t = ops.solve_threshold(a.reshape(-1), k_shard)
                    _, _, _, res = ref.ref_compact_blocks(a, t, budget)
                    kept[p, s] = a - res   # shipped selection, dense carrier
            kept = kept.view(n_pods, n_blocks, blk)
            new_residuals = acc - kept
            update = torch.mean(kept, dim=0)          # Eq. 6 reduce
            return params - eta_g * update, new_residuals

    else:  # dense: exact global threshold per pod, dense mean
        def sync(params, deltas, residuals):
            with annotate("pod_sync.dense"):
                acc = accumulate(params, deltas, residuals)
                res32 = residuals.to(torch.float32)
                kept = torch.empty_like(acc)
                for p in range(n_pods):
                    # the reference hands topk_compress g = acc − r and r,
                    # and selects on (acc − r) + r: kept as it does
                    out, _, _, _ = ops.topk_compress(
                        (acc[p] - res32[p]).reshape(dim),
                        res32[p].reshape(dim), rate=rate)
                    kept[p] = out.view(n_blocks, blk)
                new_residuals = acc - kept
                update = torch.mean(kept, dim=0)      # Eq. 6 cross-pod reduce
                return params - eta_g * update, new_residuals

    return _cost(sync, wire, wire_fmt, n_pods, n_shards, dim)


def _cost(sync, wire, wire_fmt, n_pods, n_shards, dim):
    """`sync` with its wire mode and its wire-cost attributes."""
    sync.path = wire
    sync.wire = wire_fmt
    if wire_fmt is not None:
        sync.bytes_per_device = float(
            (max(n_pods, 1) - 1) * wire_fmt.payload_bytes())
        sync.payload_bits_per_pod = float(n_shards * wire_fmt.payload_bits())
    else:
        dim_local = dim // n_shards
        sync.bytes_per_device = \
            2.0 * (n_pods - 1) / max(n_pods, 1) * dim_local * VALUE_BYTES
        sync.payload_bits_per_pod = float(dim) * 8.0 * VALUE_BYTES
    return sync


def _sync_across(mesh, dim, n_blocks, blk, n_pods, inpod, n_shards, *,
                 rate, eta_g, wire, budget):
    """The sync with one process per (pod, in-pod shard) of `mesh`."""
    from torch.distributed.tensor import DTensor

    from repro_torch.dist import spmd
    from repro_torch.dist.sharding import P, placements, _contiguous_stride
    if n_blocks % n_shards != 0:
        raise ValueError(f"n_blocks={n_blocks} not divisible by the "
                         f"in-pod shard count {n_shards}")
    nbl = n_blocks // n_shards
    has_pod = "pod" in mesh.mesh_dim_names
    inpod_entry = inpod if inpod else None
    p_pl = placements(P(inpod_entry, None), mesh)
    d_pl = placements(P("pod" if has_pod else None, inpod_entry, None), mesh)

    def local(t, pl, shape):
        if not isinstance(t, DTensor) or tuple(t.shape) != shape \
                or tuple(t.placements) != pl:
            raise ValueError(f"pod sync: expected a DTensor {shape} laid "
                             f"out {pl}, got {type(t).__name__} "
                             f"{tuple(t.shape)} "
                             f"{getattr(t, 'placements', None)}")
        return t.to_local()

    def wrap(x, pl, shape):
        return DTensor.from_local(x, mesh, pl, run_check=False, shape=shape,
                                  stride=_contiguous_stride(shape))

    def sync(params, deltas, residuals):
        pshape, dshape = (n_blocks, blk), (n_pods, n_blocks, blk)
        p_l = local(params, p_pl, pshape)
        d_l = local(deltas, d_pl, dshape)
        r_l = local(residuals, d_pl, dshape)
        acc = d_l[0].to(torch.float32) + r_l[0].to(torch.float32)
        if wire == "compact":
            with annotate("pod_sync.compact_pack"):
                vals, idx, _, res = ops.compact_shard_topk(acc, budget=budget)
            with annotate("pod_sync.all_gather"):
                vals = spmd.gather(vals, mesh, ["pod"], 0).view(
                    n_pods, nbl, budget)
                idx = spmd.gather(idx, mesh, ["pod"], 0).view(
                    n_pods, nbl, budget)
            with annotate("pod_sync.scatter_apply"):
                upd = torch.zeros(nbl * blk, dtype=torch.float32,
                                  device=acc.device)
                for p in range(n_pods):
                    upd.index_add_(0, idx[p].reshape(-1), vals[p].reshape(-1))
                upd = upd / n_pods
                new_p = (p_l - eta_g * upd.view(nbl, blk)).to(p_l.dtype)
            new_r = res
        else:
            with annotate("pod_sync.dense"):
                res32 = r_l[0].to(torch.float32).reshape(-1)
                g = (acc.reshape(-1) - res32)
                k = max(1, min(dim, int(round(rate * dim))))
                # the pod's threshold from its shards' summed statistics;
                # selected on (acc − r) + r, as the one-card path
                t = ops.solve_threshold(
                    g + res32, k, reduce=lambda x, op: spmd.all_reduce(
                        x, mesh, inpod, op))
                kept, _, _ = ef_topk.ef_topk(g, res32, t)
                kept = kept.view(nbl, blk)
                new_r = acc - kept
                upd = spmd.all_reduce(kept, mesh, ["pod"], "sum") / n_pods
                new_p = p_l - eta_g * upd
        return wrap(new_p, p_pl, pshape), \
            wrap(new_r[None].to(r_l.dtype), d_pl, dshape)

    sync.mesh = mesh
    return sync
