"""Mixture-of-Experts layer: top-k router + capacity-buffer grouped GEMM
(PyTorch port of `repro.models.moe`).

Dispatch is the sort → position-in-group → scatter-to-[E, C, d] formulation:
the grouped matmuls are plain einsums over the expert axis and the FLOPs
are active-only (E·C·d_ff with C ≈ top_k·T/E·capacity_factor) — no
[T, E, C] one-hot tensor and no dense all-experts compute. Over-capacity
tokens are dropped (Switch-style).

Which slots drop depends on the order of the sort, so the port sorts as
the reference does: top-k and the slot sort are stable (ties keep the
lower index first, as `jax.lax.top_k` and `jnp.argsort`).

Mesh path (`region`, an LM call's `dist.spmd.Region`). The expert
stacks arrive as local tensors; on the tp layout each keeps its d_ff
shard over the tp axes (the FSDP (d_model) slices are gathered), so
every dispatch computes partial outputs that are summed over the tp axes.
Without the shard-local dispatch the layer keeps the unsharded
semantics: every rank gathers all tokens, dispatches them as one group
(the global sort and capacity GSPMD gives the reference), and the
partial outputs are reduced over the tp axes back to the rank's own
tokens (a reduce-scatter along S under sequence parallelism, else an
all-reduce). With it (`moe_dispatch_axes`, the reference's
`shard_tokens_axes`) each token shard dispatches alone, as the
reference's `shard_map` does:

  tokens   the rank's batch shard, gathered over the expert-TP axes,
  experts  TP-in-expert: the d_ff slice is local and the partial
           outputs are summed over the TP axes (a reduce-scatter back to
           the sequence chunks);
  chunks   at least 1024 tokens each, n in {4, 2, 1}, each recomputed in
           the backward pass.
"""
from __future__ import annotations

import math

import torch
import torch.utils.checkpoint

from repro_torch.models import nn


def moe_init(gen: torch.Generator, d_model: int, d_ff: int, n_experts: int,
             *, device=None) -> dict:
    init = nn.trunc_normal(1.0 / math.sqrt(d_model))
    return {
        "router": nn.linear_init(gen, d_model, n_experts, use_bias=False,
                                 device=device),
        "w_gate": init(gen, (n_experts, d_model, d_ff), device),
        "w_up": init(gen, (n_experts, d_model, d_ff), device),
        "w_down": nn.trunc_normal(1.0 / math.sqrt(d_ff))(
            gen, (n_experts, d_ff, d_model), device),
    }


def _top_k(logits: torch.Tensor, k: int):
    """(values, indices) of the k largest per row, ties by lower index."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def capacity(tokens: int, n_experts: int, top_k: int,
             capacity_factor: float) -> int:
    """Slots per expert: ceil(top_k·T/E·cf) rounded up to a multiple of 8,
    at least 8."""
    cap = int(math.ceil(top_k * tokens / n_experts * capacity_factor))
    return max(8, ((cap + 7) // 8) * 8)


def route(xf: torch.Tensor, router_k: torch.Tensor, *, n_experts: int,
          top_k: int, capacity_factor: float) -> dict:
    """The dispatch plan of tokens xf [T, d]: the selected experts `sel`
    [T, k] and their renormalised weights, and per slot (token-major
    order) where it lands in the [E, C, d] buffer and whether it is kept
    under the capacity."""
    T = xf.shape[0]
    logits = xf.to(torch.float32) @ router_k.to(torch.float32)
    gate_vals, sel = _top_k(logits, top_k)                        # [T, k]
    probs = torch.softmax(gate_vals, dim=-1)                      # renormalized

    TK = T * top_k
    flat_eid = sel.reshape(TK)
    sort_idx = torch.argsort(flat_eid, stable=True)
    sorted_eid = flat_eid[sort_idx]
    # (a scatter-add, not bincount: its size does not depend on the data,
    # so the dispatch also traces under FakeTensorMode)
    counts = torch.zeros(n_experts, dtype=torch.int64,
                         device=xf.device).scatter_add_(
        0, flat_eid, torch.ones_like(flat_eid))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(TK, device=xf.device) - starts[sorted_eid]
    keep = pos < capacity(T, n_experts, top_k, capacity_factor)
    return {"sel": sel, "weights": probs.reshape(TK), "sort_idx": sort_idx,
            "sorted_eid": sorted_eid, "pos": torch.where(keep, pos, 0),
            "keep": keep}


def _dispatch_compute(xf, router_k, w_gate, w_up, w_down, *, n_experts: int,
                      top_k: int, capacity_factor: float, dtype):
    """Token-choice dispatch + grouped GEMMs. xf: [T, d];
    w_gate/w_up: [E, d, f]; w_down: [E, f, d]. Returns [T, d]."""
    T, d = xf.shape
    r = route(xf, router_k, n_experts=n_experts, top_k=top_k,
              capacity_factor=capacity_factor)
    sorted_eid, pos, keep = r["sorted_eid"], r["pos"], r["keep"]
    cap = capacity(T, n_experts, top_k, capacity_factor)

    # ---- scatter tokens into the [E, C, d] buffer
    tok_of_slot = r["sort_idx"] // top_k
    gathered = xf[tok_of_slot].to(dtype)
    zero = torch.zeros((), dtype=dtype, device=xf.device)
    buf = torch.zeros((n_experts, cap, d), dtype=dtype, device=xf.device)
    buf = buf.index_put((sorted_eid, pos),
                        torch.where(keep[:, None], gathered, zero),
                        accumulate=True)

    # ---- grouped GEMMs
    h = nn.silu(torch.einsum("ecd,edf->ecf", buf, w_gate.to(dtype))) \
        * torch.einsum("ecd,edf->ecf", buf, w_up.to(dtype))
    y_buf = torch.einsum("ecf,efd->ecd", h, w_down.to(dtype))

    # ---- gather back to slots, weight, combine over top_k
    y_sorted = torch.where(keep[:, None], y_buf[sorted_eid, pos], zero)
    inv = torch.argsort(r["sort_idx"])
    y_slots = y_sorted[inv] * r["weights"][:, None].to(dtype)
    return y_slots.reshape(T, top_k, d).sum(dim=1)


def moe_apply(p, x: torch.Tensor, *, n_experts: int, top_k: int,
              capacity_factor: float = 1.25, dtype=torch.bfloat16,
              region=None, d_ff: int | None = None) -> torch.Tensor:
    """x: [B, S, d] -> [B, S, d]. `region` (mesh path): x is the rank's
    tokens and `d_ff` the experts' whole width (w_gate's last dim may be
    the rank's tp shard of it); see the module docstring."""
    B, S, d = x.shape
    kw = dict(n_experts=n_experts, top_k=top_k,
              capacity_factor=capacity_factor, dtype=dtype)
    if region is None:
        y = _dispatch_compute(x.reshape(B * S, d), p["router"]["kernel"],
                              p["w_gate"], p["w_up"], p["w_down"], **kw)
        return y.reshape(B, S, d).to(x.dtype)
    from repro_torch.dist import spmd
    split = spmd.is_shard(region, p["w_gate"].shape[-1], d_ff)
    if p["w_up"].shape[-1] != p["w_gate"].shape[-1] or \
            p["w_down"].shape[-2] != p["w_gate"].shape[-1]:
        raise ValueError("moe: w_gate / w_up / w_down must share the "
                         "d_ff sharding")
    if region.moe_axes:
        return _moe_shard_local(p, x, region, split, **kw)
    mesh = region.mesh
    xg = spmd.gather(spmd.gather(x, mesh, region.seq_axes, 1), mesh,
                     region.batch_axes, 0)
    y = _dispatch_compute(xg.reshape(-1, d), p["router"]["kernel"],
                          p["w_gate"], p["w_up"], p["w_down"], **kw)
    y = spmd.shard(y.reshape(xg.shape), mesh, region.batch_axes, 0)
    return region.seq_out(y, partial=split).to(x.dtype)


def _moe_shard_local(p, x, region, split: bool, **kw):
    """The reference's shard_map dispatch: one dispatch per token shard,
    d_ff sliced over the expert-TP axes (the tp axes when `split`)."""
    from repro_torch.dist import spmd
    mesh = region.mesh
    tp = region.tp_axes if split else []
    # the tokens must be the same on every expert-TP rank
    seq_tp = [a for a in region.seq_axes if a in tp]
    batch_tp = [a for a in region.batch_axes if a in tp]
    xt = spmd.gather(spmd.gather(x, mesh, seq_tp, 1), mesh, batch_tp, 0)
    b, s, d = xt.shape
    xf = xt.reshape(b * s, d)
    T = xf.shape[0]
    nch = 1
    for cand in (4, 2, 1):
        if T % cand == 0 and T // cand >= 1024:
            nch = cand
            break

    def one(xc):
        return _dispatch_compute(xc, p["router"]["kernel"], p["w_gate"],
                                 p["w_up"], p["w_down"], **kw)

    ys = []
    for xc in xf.chunk(nch):
        if torch.is_grad_enabled():
            ys.append(torch.utils.checkpoint.checkpoint(
                one, xc, use_reentrant=False))
        else:
            ys.append(one(xc))
    y = (torch.cat(ys) if nch > 1 else ys[0]).reshape(b, s, d)
    # d_ff was a TP slice: partial sums over the TP axes
    y = spmd.reduce_scatter(y, mesh, batch_tp, 0)
    y = spmd.reduce_scatter(y, mesh, seq_tp, 1)
    y = spmd.all_reduce(y, mesh, [a for a in tp if a not in region.token_axes])
    return y.to(x.dtype)


def moe_aux_loss(p, x: torch.Tensor, *, n_experts: int,
                 top_k: int) -> torch.Tensor:
    """Switch-style load-balancing auxiliary loss (mean_prob · mean_assign · E)."""
    B, S, d = x.shape
    xf = x.reshape(B * S, d)
    logits = nn.linear_apply(p["router"], xf, dtype=torch.float32)
    probs = torch.softmax(logits, dim=-1)                         # [T, E]
    _, sel = _top_k(logits, top_k)
    assign = torch.zeros_like(probs).scatter_(1, sel, 1.0)
    return n_experts * torch.mean(torch.mean(probs, 0) * torch.mean(assign, 0))
