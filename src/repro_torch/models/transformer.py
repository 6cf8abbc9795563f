"""Unified decoder/encoder stack covering all assigned families (PyTorch
port of `repro.models.transformer`, one device).

One block structure per family, parameters stacked [L, ...] per leaf as
the reference's `vmap(block_init)` makes them, so the flat parameter
vector (`core.compression.flatten_pytree`) holds the reference's
coordinates in the reference's order:

  dense  : attn + (gated|gelu) MLP            (gemma3 / starcoder2 / stablelm …)
  moe    : attn + MoE                          (grok-1, qwen3-moe)
  ssm    : mamba2 block only                   (mamba2-780m)
  hybrid : parallel attn+SSM heads, then MLP   (hymba)
  audio  : non-causal attn + MLP encoder       (hubert)
  vlm    : prefix-LM decoder over [patches; text]  (paligemma)

Mixed local/global attention (gemma3's 5:1, hymba's 3 full layers) gives
each layer its window: sliding-window layers `cfg.window`, full layers
FULL_WINDOW. The layers run as a Python loop over the stack; with `remat`
each block is recomputed in the backward pass (`torch.utils.checkpoint`).

The LM loss is a sequence-chunked cross-entropy whose logits are taken
in bf16, as the reference takes them, whatever the compute dtype.

Mesh path. When the parameters are DTensors (laid out by
`dist.sharding.distribute` on a `DeviceMesh`), every call runs in a
shard-local region (`dist.spmd.Region`): each rank computes on its own
tokens with plain local tensors, and the reference's mesh fields map so:

  batch_axes         the batch dim of the tokens is sharded over these
                     axes (when they divide B);
  act_seq_axis       sequence parallelism: the residual stream keeps this
                     rank's S chunk; attention gathers K/V over the axis
                     and the SSM scan runs on the gathered sequence;
  zero3_layer /      each layer's weights are gathered INSIDE the layer
  layer_param_specs  loop (`sharding.gather_replicated`, the reference's
                     `explicit_gather`: one layer in flight, re-gathered
                     in the remat'd backward) and their gradients return
                     to the at-rest shards by reduce-scatter; the specs
                     are checked against the DTensors' layouts. The port
                     gathers every layer so, whatever the layout: it does
                     no tensor-parallel matmul outside the MoE;
  moe_dispatch_axes  the MoE's shard-local, expert-TP dispatch
                     (`models.moe`);
  _constrain         a DTensor residual stream is redistributed to
                     [B over batch_axes, S over act_seq_axis]; a plain
                     tensor is left as it is.

The decode cache arrives sequence-sharded (`sharding.cache_specs`): each
rank takes the partial softmax over its S chunk and the shards combine
(max, sum, out) by all-reduce (`attention.decode_attention_sharded`);
the cache is never gathered.

`use_scan` has no counterpart: the layers are a Python loop, so a
collective or a cost inside a layer is seen once per layer, and the dry
run needs none of the reference's 1- and 2-layer extrapolation.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core import compression as C
from repro_torch.models import mamba2 as m2
from repro_torch.models import moe as moe_lib
from repro_torch.models import nn
from repro_torch.models.attention import (FULL_WINDOW, decode_attention,
                                          decode_attention_sharded,
                                          flash_attention, quantize_rows,
                                          rope)

F32 = torch.float32


def _norm_init(cfg, d, device=None):
    return nn.rmsnorm_init(d, device=device) if cfg.norm_type == "rms" \
        else nn.layernorm_init(d, device=device)


def _norm_apply(cfg, p, x):
    return nn.rmsnorm_apply(p, x) if cfg.norm_type == "rms" \
        else nn.layernorm_apply(p, x)


# ------------------------------------------------------------------ block init
def block_init(gen: torch.Generator, cfg: ArchConfig, *, device=None) -> dict:
    """One layer's parameters (the reference's tree, unstacked)."""
    d = cfg.d_model
    hd = cfg.head_dim_
    lin = lambda i, o, **kw: nn.linear_init(gen, i, o, device=device, **kw)
    p: dict[str, Any] = {}
    if cfg.has_attention:
        p["attn_norm"] = _norm_init(cfg, d, device)
        p["wq"] = lin(d, cfg.n_heads * hd, use_bias=False)
        p["wk"] = lin(d, cfg.n_kv_heads * hd, use_bias=False)
        p["wv"] = lin(d, cfg.n_kv_heads * hd, use_bias=False)
        p["wo"] = lin(cfg.n_heads * hd, d, use_bias=False)
    if cfg.has_ssm:
        p["ssm_norm"] = _norm_init(cfg, d, device)
        p["ssm"] = m2.mamba2_init(gen, m2.spec_from_cfg(cfg), device=device)
    if cfg.n_experts:
        p["ffn_norm"] = _norm_init(cfg, d, device)
        p["moe"] = moe_lib.moe_init(gen, d, cfg.d_ff, cfg.n_experts,
                                    device=device)
    elif cfg.mlp_type == "gated":
        p["ffn_norm"] = _norm_init(cfg, d, device)
        p["w_gate"] = lin(d, cfg.d_ff, use_bias=False)
        p["w_up"] = lin(d, cfg.d_ff, use_bias=False)
        p["w_down"] = lin(cfg.d_ff, d, use_bias=False)
    elif cfg.mlp_type == "gelu":
        p["ffn_norm"] = _norm_init(cfg, d, device)
        p["fc1"] = lin(d, cfg.d_ff)
        p["fc2"] = lin(cfg.d_ff, d)
    return p


# ------------------------------------------------------------- block sub-parts
def _attn_full(cfg, p, x, window, *, positions, dtype, prefix_len=0,
               region=None):
    """Full-sequence attention (train/prefill). Returns (out, (k, v)); on
    the mesh path x is the rank's S chunk, K/V are gathered over the
    sequence axes and (k, v) are the chunk's."""
    B, S, _ = x.shape
    hd = cfg.head_dim_
    h = _norm_apply(cfg, p["attn_norm"], x)
    q = nn.linear_apply(p["wq"], h, dtype=dtype).reshape(B, S, cfg.n_heads, hd)
    k = nn.linear_apply(p["wk"], h, dtype=dtype).reshape(B, S, cfg.n_kv_heads, hd)
    v = nn.linear_apply(p["wv"], h, dtype=dtype).reshape(B, S, cfg.n_kv_heads, hd)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    if region is not None and region.seq_axes:
        from repro_torch.dist import spmd
        kf = spmd.gather(k, region.mesh, region.seq_axes, 1)
        vf = spmd.gather(v, region.mesh, region.seq_axes, 1)
        o = flash_attention(q, kf, vf, causal=cfg.causal, window=window,
                            prefix_len=prefix_len, q_offset=region.s0)
    else:
        o = flash_attention(q, k, v, causal=cfg.causal, window=window,
                            prefix_len=prefix_len)
    out = nn.linear_apply(p["wo"], o.reshape(B, S, -1), dtype=dtype)
    return out, (k, v)


def _quantize_kv(x: torch.Tensor):
    """Per-(position, kv-head) symmetric int8: x [B, S, KV, hd] →
    (int8 codes, fp32 scales [B, S, KV])."""
    codes, scale = quantize_rows(x.to(F32), 1e-8)
    return codes.to(torch.int8), scale


def _attn_decode(cfg, p, x, cache, cur_index: int, window, *, dtype,
                 region=None):
    """One-token attention against the cache. Writes position `cur_index`
    of the layer's cache tensors in place and returns (out, cache). On a
    sequence-sharded cache (`region.cache_seq_axes`) the rank holding
    `cur_index` writes it and the shards combine their partial softmax."""
    B = x.shape[0]
    hd = cfg.head_dim_
    h = _norm_apply(cfg, p["attn_norm"], x)
    q = nn.linear_apply(p["wq"], h, dtype=dtype).reshape(B, 1, cfg.n_heads, hd)
    k = nn.linear_apply(p["wk"], h, dtype=dtype).reshape(B, 1, cfg.n_kv_heads, hd)
    v = nn.linear_apply(p["wv"], h, dtype=dtype).reshape(B, 1, cfg.n_kv_heads, hd)
    pos = torch.tensor([cur_index], device=x.device)
    q = rope(q, pos, cfg.rope_theta)
    k = rope(k, pos, cfg.rope_theta)
    kc, vc = cache["k"], cache["v"]
    sharded = region is not None and region.cache_seq_axes
    s0 = region.cache_s0 if sharded else 0
    own = s0 <= cur_index < s0 + kc.shape[1]
    i = cur_index - s0
    kw = {}
    if "k_scale" in cache:
        k8, ks = _quantize_kv(k)
        v8, vs = _quantize_kv(v)
        if own:
            kc[:, i] = k8[:, 0]
            vc[:, i] = v8[:, 0]
            cache["k_scale"][:, i] = ks[:, 0]
            cache["v_scale"][:, i] = vs[:, 0]
        kw = dict(k_scale=cache["k_scale"], v_scale=cache["v_scale"])
    elif own:
        kc[:, i] = k[:, 0].to(kc.dtype)
        vc[:, i] = v[:, 0].to(vc.dtype)
    if sharded:
        from repro_torch.dist import spmd
        o = decode_attention_sharded(
            q, kc, vc, cur_index, seq_offset=s0,
            seq_len=region.cache_len, window=window,
            reduce=lambda t, op: spmd.all_reduce(
                t, region.mesh, region.cache_seq_axes, op), **kw)
    else:
        o = decode_attention(q, kc, vc, cur_index, window=window, **kw)
    out = nn.linear_apply(p["wo"], o.reshape(B, 1, -1), dtype=dtype)
    return out, cache


def _ffn(cfg, p, x, *, dtype, region=None):
    if cfg.n_experts:
        h = _norm_apply(cfg, p["ffn_norm"], x)
        return moe_lib.moe_apply(p["moe"], h, n_experts=cfg.n_experts,
                                 top_k=cfg.moe_top_k,
                                 capacity_factor=cfg.capacity_factor,
                                 dtype=dtype, region=region)
    if cfg.mlp_type == "gated":
        h = _norm_apply(cfg, p["ffn_norm"], x)
        g = nn.silu(nn.linear_apply(p["w_gate"], h, dtype=dtype))
        u = nn.linear_apply(p["w_up"], h, dtype=dtype)
        return nn.linear_apply(p["w_down"], g * u, dtype=dtype)
    if cfg.mlp_type == "gelu":
        h = _norm_apply(cfg, p["ffn_norm"], x)
        h = nn.gelu(nn.linear_apply(p["fc1"], h, dtype=dtype))
        return nn.linear_apply(p["fc2"], h, dtype=dtype)
    return None


# ----------------------------------------------------------------- block apply
def _ssm_full(cfg, p, x, *, dtype, collect_cache, region):
    """The SSM mixer over the full sequence: (out, (state, conv) | None).
    On the mesh path the scan runs on the sequence gathered over the
    sequence axes and each rank keeps its chunk's output."""
    spec = m2.spec_from_cfg(cfg)
    s_in = _norm_apply(cfg, p["ssm_norm"], x)
    seq = region.seq_axes if region is not None else ()
    if seq:
        from repro_torch.dist import spmd
        s_in = spmd.gather(s_in, region.mesh, seq, 1)
    if collect_cache:
        out, state = m2.mamba2_train(p["ssm"], spec, s_in, dtype=dtype,
                                     return_state=True)
    else:
        out = m2.mamba2_train(p["ssm"], spec, s_in, dtype=dtype)
        state = None
    if seq:
        out = spmd.shard(out, region.mesh, seq, 1)
    return out, state


def block_train(cfg: ArchConfig, p, x, window, *, positions, dtype,
                prefix_len=0, collect_cache: bool = False, region=None):
    """Full-sequence block. Returns (x, cache_layer|None)."""
    cache = {}
    if cfg.parallel_ssm:                      # hymba: attn ‖ ssm on same input
        a_out, kv = _attn_full(cfg, p, x, window, positions=positions,
                               dtype=dtype, prefix_len=prefix_len,
                               region=region)
        s_out, state = _ssm_full(cfg, p, x, dtype=dtype,
                                 collect_cache=collect_cache, region=region)
        if collect_cache:
            cache.update(k=kv[0], v=kv[1], ssm=state[0], conv=state[1])
        x = x + 0.5 * (a_out + s_out)
    elif cfg.has_ssm:                         # mamba2: SSM is the mixer
        s_out, state = _ssm_full(cfg, p, x, dtype=dtype,
                                 collect_cache=collect_cache, region=region)
        if collect_cache:
            cache.update(ssm=state[0], conv=state[1])
        x = x + s_out
    else:
        a_out, kv = _attn_full(cfg, p, x, window, positions=positions,
                               dtype=dtype, prefix_len=prefix_len,
                               region=region)
        x = x + a_out
        if collect_cache:
            cache.update(k=kv[0], v=kv[1])

    f = _ffn(cfg, p, x, dtype=dtype, region=region)
    if f is not None:
        x = x + f
    return x, (cache if collect_cache else None)


def block_decode(cfg: ArchConfig, p, x, cache, cur_index: int, window, *,
                 dtype, region=None):
    """One-token block vs the layer's cache (updated in place). Returns
    (x, cache)."""
    if cfg.parallel_ssm:
        a_out, cache = _attn_decode(cfg, p, x, cache, cur_index, window,
                                    dtype=dtype, region=region)
        s_out = _ssm_decode(cfg, p, x, cache, dtype=dtype)
        x = x + 0.5 * (a_out + s_out)
    elif cfg.has_ssm:
        x = x + _ssm_decode(cfg, p, x, cache, dtype=dtype)
    else:
        a_out, cache = _attn_decode(cfg, p, x, cache, cur_index, window,
                                    dtype=dtype, region=region)
        x = x + a_out
    f = _ffn(cfg, p, x, dtype=dtype, region=region)
    if f is not None:
        x = x + f
    return x, cache


def _ssm_decode(cfg, p, x, cache, *, dtype):
    """The SSM mixer's one-token output; its state and conv history are
    written into the layer's cache in place."""
    s_in = _norm_apply(cfg, p["ssm_norm"], x)
    s_out, st, cv = m2.mamba2_decode(p["ssm"], m2.spec_from_cfg(cfg), s_in,
                                     cache["ssm"], cache["conv"], dtype=dtype)
    cache["ssm"].copy_(st)
    cache["conv"].copy_(cv)
    return s_out


def _layer(tree, i: int):
    """Layer i of a stacked [L, ...] tree (views)."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _unstack(tree, L: int) -> list:
    """The L layers of a stacked [L, ...] tree, by `torch.unbind` of each
    leaf: its backward stacks the L layer gradients into one [L, ...]
    tensor, where indexing layer by layer would zero-fill a full [L, ...]
    gradient per layer."""
    per_leaf = {k: _unstack(v, L) if isinstance(v, dict)
                else torch.unbind(v, 0) for k, v in tree.items()}
    return [{k: v[i] for k, v in per_leaf.items()} for i in range(L)]


# -------------------------------------------------------------------- LM model
@dataclasses.dataclass(frozen=True)
class LM:
    """Facade: init / loss / prefill / decode for one ArchConfig."""
    cfg: ArchConfig
    dtype: torch.dtype = torch.bfloat16        # compute dtype
    param_dtype: torch.dtype = torch.float32   # storage dtype
    remat: bool = True
    kv_dtype: str = "compute"        # "compute" | "int8": int8 codes with
                                     # per-(position, kv-head) fp32 scales
    # mesh fields (read only when the parameters are DTensors)
    batch_axes: tuple | None = None  # mesh axes of the token batch dim;
                                     # None: every rank holds every token
    moe_dispatch_axes: tuple | None = None  # shard-local MoE dispatch
    zero3_layer: bool = False        # pure-DP layout: layer weights are
                                     # sharded over the whole mesh and
                                     # gathered inside the layer loop
    layer_param_specs: Any = None    # spec tree of ONE layer (the stack's
                                     # specs minus the L dim); required
                                     # with zero3_layer
    act_seq_axis: str | None = None  # sequence parallelism over this axis

    def _constrain(self, x):
        """A DTensor residual stream [B, S, d] redistributed to B over
        `batch_axes` and S over `act_seq_axis` (each where it divides);
        a plain tensor is returned as it is."""
        from torch.distributed.tensor import DTensor
        if not isinstance(x, DTensor) or self.batch_axes is None:
            return x
        from repro_torch.dist import spmd
        r = spmd.Region(x.device_mesh, B=x.shape[0],
                        S=x.shape[1] if x.ndim >= 3 else 1,
                        batch_axes=self.batch_axes,
                        seq_axis=self.act_seq_axis, moe_axes=None)
        return x.redistribute(x.device_mesh, r.placements(0, 1))

    def _region(self, params, B: int, S: int):
        """The shard-local region of a call on DTensor parameters (None
        for plain tensors: the one-device path)."""
        mesh = _mesh_of(params)
        if mesh is None:
            return None
        from repro_torch.dist import spmd
        return spmd.Region(mesh, B=B, S=S, batch_axes=self.batch_axes,
                           seq_axis=self.act_seq_axis,
                           moe_axes=self.moe_dispatch_axes)

    def _gather_top(self, params, region):
        """The non-layer parameters, gathered whole."""
        from repro_torch.dist.sharding import gather_replicated
        return {k: (v if k == "layers" else _tree_map(gather_replicated, v))
                for k, v in params.items()}

    def _layer_shards(self, stacked) -> list:
        """The L layers of a stacked tree of DTensors: each leaf's local
        [L, ...] shard unbound (its backward stacks the L gradients) and
        each layer wrapped again as a DTensor of the layer's shape."""
        from torch.distributed.tensor import DTensor, Shard
        from repro_torch.dist.sharding import _contiguous_stride

        def split(t):
            if not isinstance(t, DTensor):
                return list(torch.unbind(t, 0))
            if any(isinstance(pl, Shard) and pl.dim == 0
                   for pl in t.placements):
                raise ValueError("the layer dim of a stacked leaf is "
                                 "sharded")
            pl = tuple(Shard(p.dim - 1) if isinstance(p, Shard) else p
                       for p in t.placements)
            shape = tuple(t.shape[1:])
            return [DTensor.from_local(u, t.device_mesh, pl,
                                       run_check=False, shape=shape,
                                       stride=_contiguous_stride(shape))
                    for u in torch.unbind(t.to_local(), 0)]

        per_leaf = _tree_map(split, stacked)
        L = self.cfg.n_layers
        return [_tree_map(lambda v, i=i: v[i], per_leaf)
                for i in range(L)]

    def _gather_layer(self, lp, region):
        """One layer's weights gathered whole (`explicit_gather`); with
        the shard-local MoE dispatch the expert stacks stay DTensors for
        `moe_apply`, which keeps their d_ff slices."""
        from repro_torch.dist.sharding import gather_replicated, placements
        if self.zero3_layer:
            if self.layer_param_specs is None:
                raise ValueError("zero3_layer needs layer_param_specs")
            for path, t in _paths(lp):
                want = placements(_get(self.layer_param_specs, path),
                                  t.device_mesh)
                if tuple(t.placements) != want:
                    raise ValueError(f"layer leaf {path}: at rest "
                                     f"{t.placements}, specs say {want}")
        keep = {"w_gate", "w_up", "w_down"} if region.moe_axes else set()
        return _tree_map_path(
            lambda path, t: t if len(path) > 1 and path[-2] == "moe"
            and path[-1] in keep else gather_replicated(t), lp)

    # ------------------------------------------------------------------ init
    def _tree(self, gen, device) -> dict:
        """The parameter tree with ONE layer under "layers"."""
        cfg = self.cfg
        params: dict[str, Any] = {}
        if cfg.frontend in ("tokens", "patches"):
            params["embed"] = nn.embedding_init(gen, cfg.vocab, cfg.d_model,
                                                device=device)
        if cfg.frontend == "frames":
            params["frontend"] = nn.linear_init(gen, cfg.frame_dim,
                                                cfg.d_model, device=device)
            params["head"] = nn.linear_init(gen, cfg.d_model, cfg.vocab,
                                            device=device)
        if cfg.frontend == "patches":
            params["patch_proj"] = nn.linear_init(gen, cfg.patch_dim,
                                                  cfg.d_model, device=device)
        params["layers"] = block_init(gen, cfg, device=device)
        params["final_norm"] = _norm_init(cfg, cfg.d_model, device)
        return params

    def param_spec(self) -> list:
        """[(path, shape)] of the parameter tree in flatten order, layer
        leaves stacked [L, ...] (computed on the `meta` device)."""
        L = self.cfg.n_layers
        spec = []
        for path, leaf in C._leaves(self._tree(None, "meta")):
            shape = tuple(leaf.shape)
            spec.append((path, (L,) + shape if path[0] == "layers" else shape))
        return spec

    def init(self, gen: torch.Generator, device=None) -> dict:
        """Random parameters as views of ONE flat `param_dtype` buffer on
        `device` (draws from `gen`, a generator on that device): every
        leaf drawn as the reference's initializer draws it, each layer of
        a stacked leaf on its own."""
        spec = self.param_spec()
        n = sum(int(np.prod(s)) for _, s in spec)
        params = C.unflatten_pytree(
            torch.empty(n, dtype=self.param_dtype, device=device), spec)
        top = self._tree(gen, device)
        layers = top.pop("layers")
        for path, leaf in C._leaves(top):
            _get(params, path).copy_(leaf)
        del top
        for i in range(self.cfg.n_layers):
            if i:
                layers = block_init(gen, self.cfg, device=device)
            for path, leaf in C._leaves(layers):
                _get(params["layers"], path)[i].copy_(leaf)
        return params

    # ------------------------------------------------------------- internals
    def _windows(self) -> list[int]:
        cfg = self.cfg
        return [cfg.window if k == "sw" else FULL_WINDOW
                for k in cfg.layer_kinds()]

    def _stack(self, params, x, *, positions, prefix_len=0,
               collect_cache=False, region=None):
        cfg = self.cfg
        caches = []
        if region is None:
            layers = _unstack(params["layers"], cfg.n_layers)
            gather = lambda lp: lp
        else:
            layers = self._layer_shards(params["layers"])
            gather = lambda lp: self._gather_layer(lp, region)
        for lp, w in zip(layers, self._windows()):
            # the gather runs inside the remat'd function, so the
            # backward gathers the layer again: one layer in flight
            run = lambda h, lp=lp, w=w: block_train(
                cfg, gather(lp), h, w, positions=positions,
                dtype=self.dtype, prefix_len=prefix_len,
                collect_cache=collect_cache, region=region)
            if self.remat and torch.is_grad_enabled() and not collect_cache:
                x, c = torch.utils.checkpoint.checkpoint(
                    run, x, use_reentrant=False)
            else:
                x, c = run(x)
            caches.append(c)
        x = _norm_apply(cfg, params["final_norm"], x)
        if not collect_cache:
            return x, None
        return x, {k: torch.stack([c[k] for c in caches])
                   for k in caches[0]}

    def _embed_inputs(self, params, batch, region=None):
        """Returns (x [B,S,d], positions [S], prefix_len). On the mesh
        path x is the rank's tokens [B_local, S_local, d] and positions
        their global positions."""
        cfg = self.cfg
        if region is not None:
            from repro_torch.dist import spmd
            batch = {k: region.local_batch(v) for k, v in batch.items()}
            x, positions, prefix = self._embed_inputs(params, batch)
            x = spmd.shard(x, region.mesh, region.seq_axes, 1)
            return x, positions[region.s0:region.s1], prefix
        if cfg.frontend == "frames":
            x = nn.linear_apply(params["frontend"], batch["frames"],
                                dtype=self.dtype)
            return x, torch.arange(x.shape[1], device=x.device), 0
        if cfg.frontend == "patches":
            pe = nn.linear_apply(params["patch_proj"], batch["patches"],
                                 dtype=self.dtype)
            te = nn.embedding_apply(params["embed"], batch["tokens"],
                                    dtype=self.dtype)
            x = torch.cat([pe, te], dim=1)
            return x, torch.arange(x.shape[1], device=x.device), \
                cfg.n_patches
        x = nn.embedding_apply(params["embed"], batch["tokens"],
                               dtype=self.dtype)
        return x, torch.arange(x.shape[1], device=x.device), 0

    # ------------------------------------------------------------------ loss
    def _seq_len(self, batch) -> int:
        cfg = self.cfg
        if cfg.frontend == "frames":
            return batch["frames"].shape[1]
        if cfg.frontend == "patches":
            return cfg.n_patches + batch["tokens"].shape[1]
        return batch["tokens"].shape[1]

    def loss(self, params, batch) -> torch.Tensor:
        cfg = self.cfg
        lead = next(iter(batch.values()))
        region = self._region(params, lead.shape[0], self._seq_len(batch))
        if region is not None:
            return self._loss_sharded(params, batch, region)
        x, positions, prefix = self._embed_inputs(params, batch)
        h, _ = self._stack(params, x, positions=positions, prefix_len=prefix)
        labels = batch["labels"]
        if cfg.frontend == "frames":       # per-frame classification (stub)
            logits = nn.linear_apply(params["head"], h, dtype=F32)
            return _ce(logits, labels)
        if cfg.frontend == "patches":      # loss on text positions only
            h = h[:, cfg.n_patches:, :]
        # next-token LM loss, chunked over sequence
        return chunked_ce_loss(h, params["embed"]["embedding"], labels)

    def _loss_sharded(self, params, batch, region) -> torch.Tensor:
        """The mesh path's loss: this rank's share of the loss (its
        tokens' terms over the global count, over `region.dup`), whose
        gradient is the rank's partial sum; its value is the global loss
        (the shares all-reduced)."""
        from repro_torch.dist import spmd
        cfg = self.cfg
        top = self._gather_top(params, region)
        x, positions, prefix = self._embed_inputs(top, batch, region)
        h, _ = self._stack(top, x, positions=positions,
                           prefix_len=prefix, region=region)
        labels = region.local_batch(batch["labels"])   # [B_l, full length]
        B, b_l = next(iter(batch.values())).shape[0], h.shape[0]
        s0, s1 = region.s0, region.s1
        if cfg.frontend == "frames":
            logits = nn.linear_apply(top["head"], h, dtype=F32)
            part, n_l, n = _ce(logits, labels[:, s0:s1]), \
                b_l * (s1 - s0), B * region.S
        else:
            P = cfg.n_patches if cfg.frontend == "patches" else 0
            a = max(s0, P)                   # text positions of the chunk
            h, lab = h[:, a - s0:], labels[:, a - P:s1 - P]
            n_l, n = b_l * lab.shape[1], B * labels.shape[1]
            part = chunked_ce_loss(h, top["embed"]["embedding"], lab) \
                if lab.shape[1] else h.sum() * 0.0
        scale = n_l / (n * region.dup)
        if scale != 1.0:
            part = part * scale
        total = spmd.all_reduce(part.detach(), region.mesh,
                                region.mesh.mesh_dim_names)
        return part + (total - part.detach())

    # --------------------------------------------------------------- prefill
    def prefill(self, params, batch):
        """Returns (logits [B, 1, vocab] at the last position, caches
        stacked [L, ...]). On DTensor parameters both come back as
        DTensors: logits batch-sharded, the cache laid out as the ranks
        computed it (batch over the batch axes, the KV sequence over the
        sequence axis)."""
        lead = next(iter(batch.values()))
        region = self._region(params, lead.shape[0], self._seq_len(batch))
        if region is not None:
            return self._prefill_sharded(params, batch, region)
        x, positions, prefix = self._embed_inputs(params, batch)
        h, caches = self._stack(params, x, positions=positions,
                                prefix_len=prefix, collect_cache=True)
        # the head reads a contiguous row on both paths: a GEMM may round
        # a strided operand differently
        return self._head(params, h[:, -1:, :].contiguous()), caches

    def _prefill_sharded(self, params, batch, region):
        from torch.distributed.tensor import DTensor
        from repro_torch.dist import spmd
        from repro_torch.dist.sharding import _contiguous_stride
        top = self._gather_top(params, region)
        x, positions, prefix = self._embed_inputs(top, batch, region)
        h, caches = self._stack(top, x, positions=positions,
                                prefix_len=prefix, collect_cache=True,
                                region=region)
        # the last position lives on the last sequence rank
        last = spmd.gather(h[:, -1:, :], region.mesh, region.seq_axes,
                           1)[:, -1:, :].contiguous()
        logits = self._head(top, last)
        B = next(iter(batch.values())).shape[0]
        out = {}
        for k, c in caches.items():
            seq = k in ("k", "v")
            shape = list(c.shape)
            shape[1] = B
            if seq:
                shape[2] = region.S
            out[k] = DTensor.from_local(
                c, region.mesh, region.placements(1, 2 if seq else None),
                run_check=False, shape=tuple(shape),
                stride=_contiguous_stride(shape))
        return region.global_out(logits, (B,) + tuple(logits.shape[1:])), \
            out

    def _head(self, params, h):
        if self.cfg.frontend == "frames":
            return nn.linear_apply(params["head"], h, dtype=F32)
        emb = params["embed"]["embedding"].to(self.dtype)
        return (h.to(self.dtype) @ emb.T).to(F32)

    # ---------------------------------------------------------------- decode
    def decode_step(self, params, cache, token, cur_index: int):
        """token: [B, 1] int; cur_index: the position to write. Writes
        that position of `cache` in place; returns (logits [B, 1, vocab],
        cache)."""
        cfg = self.cfg
        region = self._region(params, token.shape[0], 1)
        if region is not None:
            return self._decode_sharded(params, cache, token, cur_index,
                                        region)
        x = nn.embedding_apply(params["embed"], token, dtype=self.dtype)
        for i, w in enumerate(self._windows()):
            x, _ = block_decode(cfg, _layer(params["layers"], i), x,
                                _layer(cache, i), cur_index, w,
                                dtype=self.dtype)
        x = _norm_apply(cfg, params["final_norm"], x)
        return self._head(params, x), cache

    def _decode_sharded(self, params, cache, token, cur_index: int, region):
        """decode_step on DTensor parameters and a DTensor cache (batch
        over the batch axes, the KV sequence over any axes: each rank
        reads and writes only its own shard)."""
        from torch.distributed.tensor import DTensor
        from repro_torch.dist.sharding import to_local
        cfg = self.cfg
        if isinstance(cache.get("k"), DTensor):
            region.cache_layout(cache["k"])
        local = _tree_map(to_local, cache)
        top = self._gather_top(params, region)
        x = nn.embedding_apply(top["embed"], region.local_batch(token),
                               dtype=self.dtype)
        layers = self._layer_shards(params["layers"])
        for i, w in enumerate(self._windows()):
            x, _ = block_decode(cfg, self._gather_layer(layers[i], region),
                                x, _layer(local, i), cur_index, w,
                                dtype=self.dtype, region=region)
        x = _norm_apply(cfg, top["final_norm"], x)
        logits = self._head(top, x)
        return region.global_out(logits, (token.shape[0],)
                                 + tuple(logits.shape[1:])), cache

    # ------------------------------------------------------------- cache init
    def init_cache(self, B: int, S: int, *, dtype=None, device=None) -> dict:
        """Zeroed cache with leading layer dim [L, ...]."""
        cfg = self.cfg
        dt = dtype or self.dtype
        L = cfg.n_layers
        z = lambda shape, t: torch.zeros(shape, dtype=t, device=device)
        c: dict[str, Any] = {}
        if cfg.has_attention:
            kv = (L, B, S, cfg.n_kv_heads, cfg.head_dim_)
            if self.kv_dtype == "int8":
                c["k"], c["v"] = z(kv, torch.int8), z(kv, torch.int8)
                c["k_scale"], c["v_scale"] = z(kv[:-1], F32), z(kv[:-1], F32)
            else:
                c["k"], c["v"] = z(kv, dt), z(kv, dt)
        if cfg.has_ssm:
            s = m2.spec_from_cfg(cfg)
            c["ssm"] = z((L, B, s.n_heads, s.head_dim, s.state), F32)
            c["conv"] = z((L, B, s.conv_width - 1, s.d_inner + 2 * s.state),
                          F32)
        return c

    def cache_specs(self, B: int, S: int) -> dict:
        return self.init_cache(B, S, device="meta")


def _get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _tree_map(fn, tree):
    """fn at every leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _tree_map_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _tree_map_path(fn, v, path + (k,))
                for k, v in tree.items()}
    return fn(path, tree)


def _paths(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, path + (k,))
    else:
        yield path, tree


def _mesh_of(params):
    """The DeviceMesh of DTensor parameters, else None."""
    from torch.distributed.tensor import DTensor
    for _, t in _paths(params):
        return t.device_mesh if isinstance(t, DTensor) else None
    return None


# ----------------------------------------------------------------------- losses
def _ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits.to(F32), dim=-1)
    ll = torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    return -torch.mean(ll)


def chunked_ce_loss(h: torch.Tensor, embedding: torch.Tensor,
                    labels: torch.Tensor, *, chunk: int = 512
                    ) -> torch.Tensor:
    """CE(h @ E^T, labels) without materializing [B, S, V]; the logits are
    taken in bf16, as the reference takes them. Each chunk's logits are
    recomputed in the backward pass, as the reference's per-chunk
    `jax.checkpoint(nothing_saveable)` does, so autograd keeps no
    [B, chunk, V] tensor."""
    B, S, d = h.shape
    chunk = min(chunk, S)
    while S % chunk:        # e.g. vlm text length 3840 → chunk 256
        chunk //= 2
    emb = embedding.to(torch.bfloat16)

    def one(hc, lc):
        logits = (hc.to(torch.bfloat16) @ emb.T).to(F32)
        logp = torch.log_softmax(logits, dim=-1)
        return -torch.sum(torch.gather(logp, -1, lc.long()[..., None]))

    total = None
    for c0 in range(0, S, chunk):
        part = torch.utils.checkpoint.checkpoint(
            one, h[:, c0:c0 + chunk], labels[:, c0:c0 + chunk],
            use_reentrant=False)
        total = part if total is None else total + part
    return total / (B * S)


# ---------------------------------------------------------------- weights
def params_from_jax(np_tree, device=None) -> dict:
    """`LM`'s parameters from a reference parameter tree of numpy arrays:
    views of one flat fp32 buffer on `device`, in the reference's flatten
    order (keys sorted at every level, layer leaves stacked [L, ...])."""
    flat, spec = C.flatten_pytree(np_tree)
    return C.unflatten_pytree(flat.to(device), spec)


def params_to_numpy(params) -> dict:
    """The inverse of `params_from_jax`: a nested dict of numpy arrays."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    return params.detach().cpu().numpy()
