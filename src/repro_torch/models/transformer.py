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
  hybrid stack : layers of two kinds in a cycled pattern
           (`cfg.mixer_pattern`), each a Mamba-2 or an attention mixer
           then a gated MLP, each sublayer's output scaled by
           `residual_scale` before its add      (granite-4.0-h)
  audio  : non-causal attn + MLP encoder       (hubert)
  vlm    : prefix-LM decoder over [patches; text]  (paligemma)

Mixed local/global attention (gemma3's 5:1, hymba's 3 full layers) gives
each layer its window: sliding-window layers `cfg.window`, full layers
FULL_WINDOW. The layers run as a Python loop over the stack; with `remat`
each block is recomputed in the backward pass (`torch.utils.checkpoint`).
Each layer's forward is the span `lm.layer.<mixer>` (`obs.profiling`):
"ssm", "attention" or "parallel" (hymba).

A hybrid stack keeps one stack of leaves per layer kind, under
`layers/<kind>` ([L_kind, ...] each), and runs the layers in pattern
order, each taking the next layer of its kind's stack. Its attention may
drop RoPE (`cfg.rope`, NoPE) and set the softmax scale (`attn_scale`);
µP multipliers scale the embedding (`embed_scale`) and divide the logits
(`logit_divisor`). Only the one-device train path runs it: prefill,
decode and the mesh path raise for any config that sets one of these
fields (`TRAIN_ONLY`).

The LM loss is a sequence-chunked cross-entropy whose logits are taken
in bf16, as the reference takes them, whatever the compute dtype.

Mesh path. When the parameters are DTensors (laid out by
`dist.sharding.distribute` on a `DeviceMesh`), every call runs in a
shard-local region (`dist.spmd.Region`): each rank computes on its own
tokens with plain local tensors, and the reference's mesh fields map so:

  batch_axes         the batch dim of the tokens is sharded over these
                     axes (when they divide B);
  (TP_AXIS)          tensor parallelism over `model` (the tp layout; the
                     reference's GSPMD infers it from the weights'
                     layout): each weight is gathered over its FSDP axes
                     only and keeps its feature shard over `model`.
                     q/k/v, w_gate/w_up, fc1, in_proj, the frontends and
                     the head are column-parallel,
                     wo/w_down/fc2/out_proj row-parallel
                     (`spmd.column_parallel` / `row_parallel`); the
                     embedding lookup and the tied CE are vocab-parallel;
                     attention runs the rank's whole heads, or gathers
                     q/k/v when its columns split heads; the SSM gathers
                     in_proj's output and scans on every tp rank; the
                     MoE keeps its experts' d_ff shards;
  act_seq_axis       Megatron sequence parallelism: the residual stream
                     keeps this rank's S chunk, each block's input is
                     all-gathered along S and each row-parallel output
                     reduce-scattered back;
  zero3_layer /      no tp axis: each layer's weights are gathered whole
  layer_param_specs  INSIDE the layer loop (`sharding.gather_replicated`,
                     the reference's `explicit_gather`: one layer in
                     flight, re-gathered in the remat'd backward) and
                     their gradients return to the at-rest shards by
                     reduce-scatter; the specs are checked against the
                     DTensors' layouts (the tp layout gathers inside the
                     loop too, over the FSDP axes);
  moe_dispatch_axes  the MoE's shard-local, expert-TP dispatch
                     (`models.moe`);
  _constrain         a DTensor residual stream is redistributed to
                     [B over batch_axes, S over act_seq_axis]; a plain
                     tensor is left as it is.

The decode cache arrives sequence-sharded (`sharding.cache_specs`, every
KV head): each rank takes the partial softmax over its S chunk and the
shards combine (max, sum, out) by all-reduce
(`attention.decode_attention_sharded`); the cache is never gathered.
Prefill hands its K/V over to that layout by a gather and a slice, not
an all-to-all: where a rank's wq columns are not whole heads over whole
KV heads (gemma3-4b, paligemma, starcoder2 and qwen3-moe at 16 ranks),
the K/V are already gathered over the tp axes for attention and the
hand-over only slices the rank's S chunk; only ranks that own whole KV
heads gather them, once per prompt.

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
from repro_torch.dist import spmd
from repro_torch.models import mamba2 as m2
from repro_torch.models import moe as moe_lib
from repro_torch.models import nn
from repro_torch.models.attention import (FULL_WINDOW, decode_attention,
                                          decode_attention_sharded,
                                          flash_attention, quantize_rows,
                                          rope)
from repro_torch.obs.profiling import annotate

F32 = torch.float32
# the mesh axis the weights' feature dims are sharded over on the tp
# layout (`sharding.param_specs`' model_axis)
TP_AXIS = "model"


def _norm_init(cfg, d, device=None):
    return nn.rmsnorm_init(d, device=device) if cfg.norm_type == "rms" \
        else nn.layernorm_init(d, device=device)


def _norm_apply(cfg, p, x):
    return nn.rmsnorm_apply(p, x, eps=cfg.norm_eps) \
        if cfg.norm_type == "rms" else nn.layernorm_apply(p, x)


def _mixer(cfg) -> str:
    """The mixer of a one-kind stack's layers."""
    if cfg.parallel_ssm:
        return "parallel"
    return "ssm" if cfg.has_ssm else "attention"


def _residual(cfg, x, y):
    """x + y, y scaled by `cfg.residual_scale` first where it is not 1."""
    r = cfg.residual_scale
    return x + y if r == 1.0 else x + y * r


def _rope(cfg, x, positions):
    """RoPE on q or k [.., S, heads, hd]; x itself under NoPE."""
    return rope(x, positions, cfg.rope_theta) if cfg.rope else x


# port-only ArchConfig fields that only the one-device train path
# honours: prefill, decode and the mesh path raise where one is set
TRAIN_ONLY = ("mixer_pattern", "rope", "attn_scale", "embed_scale",
              "residual_scale", "logit_divisor")


def _check_ported(cfg, what: str):
    """Raise for `what` where `cfg` sets a field of TRAIN_ONLY."""
    fields = ArchConfig.__dataclass_fields__
    set_ = [f for f in TRAIN_ONLY if getattr(cfg, f) != fields[f].default]
    if set_:
        raise NotImplementedError(
            f"{cfg.name}: {what} is not ported for {', '.join(set_)}; "
            f"only the one-device train path (LM.loss) is")


# ------------------------------------------------------------------ block init
def block_init(gen: torch.Generator, cfg: ArchConfig, *, kind=None,
               device=None) -> dict:
    """One layer's parameters (the reference's tree, unstacked); `kind`
    ("ssm" | "attention") is a hybrid stack's layer kind."""
    d = cfg.d_model
    hd = cfg.head_dim_
    lin = lambda i, o, **kw: nn.linear_init(gen, i, o, device=device, **kw)
    p: dict[str, Any] = {}
    attn = cfg.has_attention if kind is None else kind == "attention"
    ssm = cfg.has_ssm if kind is None else kind == "ssm"
    if attn:
        p["attn_norm"] = _norm_init(cfg, d, device)
        p["wq"] = lin(d, cfg.n_heads * hd, use_bias=False)
        p["wk"] = lin(d, cfg.n_kv_heads * hd, use_bias=False)
        p["wv"] = lin(d, cfg.n_kv_heads * hd, use_bias=False)
        p["wo"] = lin(cfg.n_heads * hd, d, use_bias=False)
    if ssm:
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
# On the mesh path (`region` given) every projection runs through
# `spmd.column_parallel` / `spmd.row_parallel`: on the tp layout a
# weight's feature dim is the rank's shard over the tp axes, elsewhere it
# is whole and the same code is the one-device linear.
def _col_whole(p, x, region, full: int, dtype):
    """A column-parallel projection's whole output (its features gathered
    over the tp axes when the rank holds a shard)."""
    y, split = spmd.column_parallel(p, x, region, full, dtype=dtype)
    return region.tp_gather(y, split) if split else y


def _own_heads(cfg, region) -> tuple[int, int] | None:
    """(first, count) of the q heads this rank attends with when its wq
    columns are whole heads whose KV heads it can read, else None."""
    n, H = region.tp_size, cfg.n_heads
    G = H // cfg.n_kv_heads                     # q heads per KV head
    if H % n or ((H // n) % G and G % (H // n)):
        return None
    return region.tp_rank * (H // n), H // n


def _qkv(cfg, p, h, positions, dtype, region, collect: bool):
    """(q, k, v, kv, cols): q, k, v [B, S, heads, hd] (rope'd) of the
    heads this rank attends with, with `collect` (k, v) of every KV head
    (the cache's), and the slice of the attention's output columns that
    are this rank's wo rows (None: all of them, or `row_parallel`'s).

    One device, or a whole wq: every head. On the tp layout, whole heads
    (`_own_heads`): the rank's q heads; its KV heads are its own wk/wv
    columns when the tp axes divide n_kv_heads, else the k/v activations
    are gathered over the tp axes and the KV heads its q heads need are
    read. Split heads (the rank's wq columns cut a head): q, k and v are
    gathered over the tp axes and the rank attends with the heads its
    columns touch, each with its KV head."""
    B, S, _ = h.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    G = H // KV
    split = region is not None and spmd.is_shard(
        region, p["wq"]["kernel"].shape[-1], H * hd)
    own = _own_heads(cfg, region) if split else None
    if own is not None:
        h0, hl = own
        q, _ = spmd.column_parallel(p["wq"], h, region, H * hd, dtype=dtype)
        q = rope(q.reshape(B, S, hl, hd), positions, cfg.rope_theta)
        k, kv_split = spmd.column_parallel(p["wk"], h, region, KV * hd,
                                           dtype=dtype)
        v, _ = spmd.column_parallel(p["wv"], h, region, KV * hd,
                                    dtype=dtype)
        if kv_split and KV % region.tp_size == 0:   # its own KV heads
            k = rope(k.reshape(B, S, -1, hd), positions, cfg.rope_theta)
            v = v.reshape(B, S, -1, hd)
            kv = (region.tp_gather(k, True).reshape(B, S, KV, hd),
                  region.tp_gather(v, True).reshape(B, S, KV, hd)) \
                if collect else None
            return q, k, v, kv, None
        k = rope(region.tp_gather(k, kv_split).reshape(B, S, KV, hd),
                 positions, cfg.rope_theta)
        v = region.tp_gather(v, kv_split).reshape(B, S, KV, hd)
        k0, kn = h0 // G, max(1, hl // G)
        return q, k[:, :, k0:k0 + kn], v[:, :, k0:k0 + kn], (k, v), None
    q = _col_whole(p["wq"], h, region, H * hd, dtype)
    k = _col_whole(p["wk"], h, region, KV * hd, dtype)
    v = _col_whole(p["wv"], h, region, KV * hd, dtype)
    q = _rope(cfg, q.reshape(B, S, H, hd), positions)
    k = _rope(cfg, k.reshape(B, S, KV, hd), positions)
    v = v.reshape(B, S, KV, hd)
    if not split:
        return q, k, v, (k, v), None
    c = H * hd // region.tp_size            # the rank's output columns
    c0 = region.tp_rank * c
    h0, h1 = c0 // hd, (c0 + c - 1) // hd + 1
    kv_of = torch.arange(h0, h1, device=h.device) // G
    return q[:, :, h0:h1], k[:, :, kv_of], v[:, :, kv_of], (k, v), \
        slice(c0 - h0 * hd, c0 - h0 * hd + c)


def _attn_full(cfg, p, x, window, *, positions, dtype, prefix_len=0,
               region=None, collect: bool = False):
    """Full-sequence attention (train/prefill). Returns (out, (k, v) |
    None). On the mesh path x is the rank's S chunk: the block's input is
    gathered along S, q/k/v are column-parallel (`_qkv`), wo is
    row-parallel on the rank's columns of the output, and (k, v) are the
    chunk's, every KV head."""
    B = x.shape[0]
    hd = cfg.head_dim_
    h = _norm_apply(cfg, p["attn_norm"], x)
    if region is not None:
        h = region.seq_in(h)
    S = h.shape[1]
    q, k, v, kv, cols = _qkv(cfg, p, h, positions, dtype, region, collect)
    o = flash_attention(q, k, v, causal=cfg.causal, window=window,
                        prefix_len=prefix_len,
                        softmax_scale=cfg.attn_scale or None
                        ).reshape(B, S, -1)
    out = spmd.row_parallel(p["wo"], o if cols is None else o[..., cols],
                            region, cfg.n_heads * hd, dtype=dtype)
    if not collect:
        return out, None
    if region is not None and region.seq_axes:
        # the chunk in storage of its own: a view would keep the whole
        # sequence's K/V of every layer alive until the caches stack
        kv = tuple(spmd.shard(t, region.mesh, region.seq_axes, 1).clone()
                   for t in kv)
    return out, kv


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
    `cur_index` writes it and the shards combine their partial softmax;
    on the tp layout the token's q/k/v are gathered over the tp axes
    (every head meets the rank's S chunk of the cache) and wo is
    row-parallel."""
    B = x.shape[0]
    hd = cfg.head_dim_
    h = _norm_apply(cfg, p["attn_norm"], x)
    q = _col_whole(p["wq"], h, region, cfg.n_heads * hd, dtype
                   ).reshape(B, 1, cfg.n_heads, hd)
    k = _col_whole(p["wk"], h, region, cfg.n_kv_heads * hd, dtype
                   ).reshape(B, 1, cfg.n_kv_heads, hd)
    v = _col_whole(p["wv"], h, region, cfg.n_kv_heads * hd, dtype
                   ).reshape(B, 1, cfg.n_kv_heads, hd)
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
        o = decode_attention_sharded(
            q, kc, vc, cur_index, seq_offset=s0,
            seq_len=region.cache_len, window=window,
            reduce=lambda t, op: spmd.all_reduce(
                t, region.mesh, region.cache_seq_axes, op), **kw)
    else:
        o = decode_attention(q, kc, vc, cur_index, window=window, **kw)
    out = spmd.row_parallel(p["wo"], o.reshape(B, 1, -1), region,
                            cfg.n_heads * hd, dtype=dtype)
    return out, cache


def _ffn(cfg, p, x, *, dtype, region=None):
    """The MLP (or MoE) sub-block's output. On the mesh path the dense
    MLP is column-parallel (w_gate / w_up / fc1, each rank its d_ff
    columns) then row-parallel (w_down / fc2)."""
    if cfg.n_experts:
        h = _norm_apply(cfg, p["ffn_norm"], x)
        return moe_lib.moe_apply(p["moe"], h, n_experts=cfg.n_experts,
                                 top_k=cfg.moe_top_k,
                                 capacity_factor=cfg.capacity_factor,
                                 dtype=dtype, region=region, d_ff=cfg.d_ff)
    if cfg.mlp_type not in ("gated", "gelu"):
        return None
    h = _norm_apply(cfg, p["ffn_norm"], x)
    if region is not None:
        h = region.seq_in(h)
    col = lambda name: spmd.column_parallel(p[name], h, region, cfg.d_ff,
                                            dtype=dtype)[0]
    if cfg.mlp_type == "gated":
        f, down = nn.silu(col("w_gate")) * col("w_up"), "w_down"
    else:
        f, down = nn.gelu(col("fc1")), "fc2"
    return spmd.row_parallel(p[down], f, region, cfg.d_ff, dtype=dtype)


# ----------------------------------------------------------------- block apply
def _ssm_projections(cfg, p, region, dtype) -> dict:
    """The mesh path's SSM projections: in_proj column-parallel with its
    output gathered over the tp axes (its columns interleave z, x, B, C
    and dt, so no shard stands alone: the conv, the scan and the gated
    norm run on every tp rank), out_proj row-parallel (the rank's d_inner
    rows)."""
    if region is None:
        return {}
    s = m2.spec_from_cfg(cfg)
    return dict(
        in_proj=lambda x: _col_whole(p["in_proj"], x, region,
                                     2 * s.d_inner + 2 * s.state + s.n_heads,
                                     dtype),
        out_proj=lambda y: spmd.row_parallel(p["out_proj"], y, region,
                                             s.d_inner, dtype=dtype))


def _ssm_full(cfg, p, x, *, dtype, collect_cache, region):
    """The SSM mixer over the full sequence: (out, (state, conv) | None).
    On the mesh path the scan runs on the block's input gathered along S
    and the row-parallel out_proj returns the rank's chunk."""
    spec = m2.spec_from_cfg(cfg)
    s_in = _norm_apply(cfg, p["ssm_norm"], x)
    if region is not None:
        s_in = region.seq_in(s_in)
    kw = _ssm_projections(cfg, p["ssm"], region, dtype)
    if collect_cache:
        return m2.mamba2_train(p["ssm"], spec, s_in, dtype=dtype,
                               return_state=True, **kw)
    return m2.mamba2_train(p["ssm"], spec, s_in, dtype=dtype, **kw), None


def block_train(cfg: ArchConfig, p, x, window, *, positions, dtype,
                prefix_len=0, collect_cache: bool = False, region=None,
                kind=None):
    """Full-sequence block (of a hybrid stack's layer `kind`). Returns
    (x, cache_layer|None)."""
    cache = {}
    mixer = kind or _mixer(cfg)
    if mixer == "parallel":                   # hymba: attn ‖ ssm on same input
        a_out, kv = _attn_full(cfg, p, x, window, positions=positions,
                               dtype=dtype, prefix_len=prefix_len,
                               region=region, collect=collect_cache)
        s_out, state = _ssm_full(cfg, p, x, dtype=dtype,
                                 collect_cache=collect_cache, region=region)
        if collect_cache:
            cache.update(k=kv[0], v=kv[1], ssm=state[0], conv=state[1])
        x = x + 0.5 * (a_out + s_out)
    elif mixer == "ssm":                      # mamba2: SSM is the mixer
        s_out, state = _ssm_full(cfg, p, x, dtype=dtype,
                                 collect_cache=collect_cache, region=region)
        if collect_cache:
            cache.update(ssm=state[0], conv=state[1])
        x = _residual(cfg, x, s_out)
    else:
        a_out, kv = _attn_full(cfg, p, x, window, positions=positions,
                               dtype=dtype, prefix_len=prefix_len,
                               region=region, collect=collect_cache)
        x = _residual(cfg, x, a_out)
        if collect_cache:
            cache.update(k=kv[0], v=kv[1])

    f = _ffn(cfg, p, x, dtype=dtype, region=region)
    if f is not None:
        x = _residual(cfg, x, f)
    return x, (cache if collect_cache else None)


def block_decode(cfg: ArchConfig, p, x, cache, cur_index: int, window, *,
                 dtype, region=None):
    """One-token block vs the layer's cache (updated in place). Returns
    (x, cache)."""
    if cfg.parallel_ssm:
        a_out, cache = _attn_decode(cfg, p, x, cache, cur_index, window,
                                    dtype=dtype, region=region)
        s_out = _ssm_decode(cfg, p, x, cache, dtype=dtype, region=region)
        x = x + 0.5 * (a_out + s_out)
    elif cfg.has_ssm:
        x = x + _ssm_decode(cfg, p, x, cache, dtype=dtype, region=region)
    else:
        a_out, cache = _attn_decode(cfg, p, x, cache, cur_index, window,
                                    dtype=dtype, region=region)
        x = x + a_out
    f = _ffn(cfg, p, x, dtype=dtype, region=region)
    if f is not None:
        x = x + f
    return x, cache


def _ssm_decode(cfg, p, x, cache, *, dtype, region=None):
    """The SSM mixer's one-token output; its state and conv history are
    written into the layer's cache in place."""
    s_in = _norm_apply(cfg, p["ssm_norm"], x)
    s_out, st, cv = m2.mamba2_decode(
        p["ssm"], m2.spec_from_cfg(cfg), s_in, cache["ssm"], cache["conv"],
        dtype=dtype, **_ssm_projections(cfg, p["ssm"], region, dtype))
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
        _check_ported(self.cfg, "the mesh path")
        return spmd.Region(mesh, B=B, S=S, batch_axes=self.batch_axes,
                           seq_axis=self.act_seq_axis,
                           moe_axes=self.moe_dispatch_axes,
                           tp_axis=None if self.zero3_layer
                           else TP_AXIS)

    def _gather_top(self, params, region):
        """The non-layer parameters, gathered over their FSDP axes (a tp
        feature shard stays local)."""
        from repro_torch.dist.sharding import gather_replicated
        keep = tuple(region.tp_axes)
        return {k: (v if k == "layers" else _tree_map(
            lambda t: gather_replicated(t, keep=keep), v))
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
        """One layer's weights gathered over their FSDP axes
        (`explicit_gather`): on the tp layout each keeps its feature
        shard over the tp axes; under zero3_layer (no tp axes) they are
        gathered whole."""
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
        keep = tuple(region.tp_axes)
        return _tree_map(lambda t: gather_replicated(t, keep=keep), lp)

    # ------------------------------------------------------------------ init
    def _stacks(self) -> dict:
        """{layer kind: its number of layers}: {None: L} for one stack of
        every layer; a hybrid stack's kinds in sorted (flat) order."""
        mixers = self.cfg.layer_mixers()
        if not mixers:
            return {None: self.cfg.n_layers}
        return {k: mixers.count(k) for k in sorted(set(mixers))}

    def _tree(self, gen, device) -> dict:
        """The parameter tree with ONE layer under "layers" (one layer of
        each kind under "layers/<kind>" in a hybrid stack)."""
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
        stacks = self._stacks()
        params["layers"] = block_init(gen, cfg, device=device) \
            if None in stacks else {
                k: block_init(gen, cfg, kind=k, device=device)
                for k in stacks}
        params["final_norm"] = _norm_init(cfg, cfg.d_model, device)
        return params

    def param_spec(self) -> list:
        """[(path, shape)] of the parameter tree in flatten order, layer
        leaves stacked [L, ...] (computed on the `meta` device)."""
        stacks = self._stacks()
        spec = []
        for path, leaf in C._leaves(self._tree(None, "meta")):
            shape = tuple(leaf.shape)
            if path[0] == "layers":
                shape = (stacks[None if None in stacks else path[1]],) \
                    + shape
            spec.append((path, shape))
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
        first = top.pop("layers")
        for path, leaf in C._leaves(top):
            _get(params, path).copy_(leaf)
        del top
        for kind, n in self._stacks().items():
            dst = params["layers"] if kind is None \
                else params["layers"][kind]
            for i in range(n):
                layer = (first if kind is None else first[kind]) if not i \
                    else block_init(gen, self.cfg, kind=kind, device=device)
                for path, leaf in C._leaves(layer):
                    _get(dst, path)[i].copy_(leaf)
        return params

    # ------------------------------------------------------------- internals
    def _windows(self) -> list[int]:
        cfg = self.cfg
        return [cfg.window if k == "sw" else FULL_WINDOW
                for k in cfg.layer_kinds()]

    def _layers(self, params, region) -> list:
        """(kind, the layer's parameters) of every layer in order: a
        hybrid stack's layer takes the next layer of its kind's stack."""
        stacks = self._stacks()
        if None not in stacks:
            per = {k: iter(_unstack(params["layers"][k], n))
                   for k, n in stacks.items()}
            return [(k, next(per[k])) for k in self.cfg.layer_mixers()]
        layers = _unstack(params["layers"], self.cfg.n_layers) \
            if region is None else self._layer_shards(params["layers"])
        return [(None, lp) for lp in layers]

    def _stack(self, params, x, *, positions, prefix_len=0,
               collect_cache=False, region=None):
        cfg = self.cfg
        caches = []
        gather = (lambda lp: lp) if region is None \
            else (lambda lp: self._gather_layer(lp, region))
        for (kind, lp), w in zip(self._layers(params, region),
                                 self._windows()):
            # the gather runs inside the remat'd function, so the
            # backward gathers the layer again: one layer in flight
            run = lambda h, lp=lp, w=w, kind=kind: block_train(
                cfg, gather(lp), h, w, positions=positions,
                dtype=self.dtype, prefix_len=prefix_len,
                collect_cache=collect_cache, region=region, kind=kind)
            with annotate("lm.layer." + (kind or _mixer(cfg))):
                if self.remat and torch.is_grad_enabled() \
                        and not collect_cache:
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
        """Returns (x [B, S, d], positions [S], prefix_len). On the mesh
        path x is the rank's tokens [B_local, S_chunk, d] and the
        positions are the whole sequence's (the blocks gather their
        inputs along S). The frontends are column-parallel (their d_model
        columns gathered over the tp axes); the token lookup is
        vocab-parallel, its partial sums reduced over the tp axes
        (reduce-scattered along S under sequence parallelism); `region`
        None is the one-device embedding."""
        cfg = self.cfg
        if region is not None:
            batch = {k: region.local_batch(v) for k, v in batch.items()}
        prefix, split = 0, False
        if cfg.frontend == "frames":
            x = _col_whole(params["frontend"], batch["frames"], region,
                           cfg.d_model, self.dtype)
        elif cfg.frontend == "patches":
            pe = _col_whole(params["patch_proj"], batch["patches"], region,
                            cfg.d_model, self.dtype)
            te, split = self._lookup(params["embed"], batch["tokens"],
                                     region)
            if split:
                te = spmd.all_reduce(te, region.mesh, region.tp_axes)
            x, split = torch.cat([pe, te], dim=1), False
            prefix = cfg.n_patches
        else:
            x, split = self._lookup(params["embed"], batch["tokens"],
                                    region)
        if cfg.embed_scale != 1.0:
            x = x * cfg.embed_scale
        if region is None:
            return x, torch.arange(x.shape[1], device=x.device), prefix
        return region.seq_out(x, partial=split), \
            torch.arange(region.S, device=x.device), prefix

    def _lookup(self, emb, ids, region):
        """(token embeddings, split). The table [V, d] may be the rank's
        vocab shard over the tp axes (split): a token outside its rows
        gives zeros, so the result is a partial sum over the tp axes."""
        e = emb["embedding"]
        if not spmd.is_shard(region, e.shape[0], self.cfg.vocab):
            return nn.embedding_apply(emb, ids, dtype=self.dtype), False
        rows = e.shape[0]
        local = ids.long() - region.tp_rank * rows
        x = torch.nn.functional.embedding(local.clamp(0, rows - 1),
                                          e.to(self.dtype))
        own = ((local >= 0) & (local < rows))[..., None]
        return torch.where(own, x, torch.zeros((), dtype=x.dtype,
                                               device=x.device)), True

    # ------------------------------------------------------------------ loss
    def _seq_len(self, batch) -> int:
        cfg = self.cfg
        if cfg.frontend == "frames":
            return batch["frames"].shape[1]
        if cfg.frontend == "patches":
            return cfg.n_patches + batch["tokens"].shape[1]
        return batch["tokens"].shape[1]

    def loss(self, params, batch) -> torch.Tensor:
        """The next-token CE (per-frame for "frames"; text positions only
        for "patches"). On the mesh path each rank computes its share of
        the loss (its tokens' terms over the global count, over
        `region.dup`), whose gradient is the rank's partial sum; its value
        is the global loss (the shares all-reduced)."""
        lead = next(iter(batch.values()))
        region = self._region(params, lead.shape[0], self._seq_len(batch))
        top = params if region is None else self._gather_top(params, region)
        x, positions, prefix = self._embed_inputs(top, batch, region)
        h, _ = self._stack(top, x, positions=positions, prefix_len=prefix,
                           region=region)
        part = self._ce_share(top, h, batch["labels"], region,
                              lead.shape[0])
        if region is None:
            return part
        total = spmd.all_reduce(part.detach(), region.mesh,
                                region.mesh.mesh_dim_names)
        return part + (total - part.detach())

    def _ce_share(self, top, h, labels, region, B: int):
        """This rank's share of the CE loss over h [B_l, S_chunk, d]. The
        head is the frames head or the tied embedding, whose logits are
        taken in bf16 as the reference takes them. When its vocab is the
        rank's tp shard, h is gathered along S and every position's term
        is taken vocab-parallel; otherwise the rank takes its own
        positions' terms with the same `vocab_parallel_ce_terms`, its
        reductions over no axes (on one device: the whole loss)."""
        cfg = self.cfg
        if cfg.frontend == "frames":
            p = top["head"]
            split = spmd.is_shard(region, p["kernel"].shape[-1], cfg.vocab)
            logits = lambda hc: spmd.column_parallel(p, hc, region,
                                                     cfg.vocab,
                                                     dtype=F32)[0]
        else:
            emb = top["embed"]["embedding"]
            split = spmd.is_shard(region, emb.shape[0], cfg.vocab)
            e16 = emb.to(torch.bfloat16)
            logits = lambda hc: (hc.to(torch.bfloat16) @ e16.T).to(F32)
        if cfg.logit_divisor != 1.0:
            z_of = logits
            logits = lambda hc: z_of(hc) / cfg.logit_divisor
        P = cfg.n_patches if cfg.frontend == "patches" else 0
        S = h.shape[1] if region is None else region.S
        s0, s1 = (0, S) if region is None else (region.s0, region.s1)
        if region is not None:
            labels = region.local_batch(labels)  # [B_l, the text length]
        mesh, axes, v0 = None, (), 0
        if split:
            h, lo = region.seq_in(h), 0          # every position of S
            mesh, axes = region.mesh, region.tp_axes
            v0 = region.tp_rank * (cfg.vocab // region.tp_size)
        else:
            lo = s0                              # the rank's own chunk
        a = max(lo, P)                           # its text positions
        lab = labels[:, a - P:lo + h.shape[1] - P]
        if not lab.shape[1]:                     # a chunk of patches only
            return h.sum() * 0.0
        terms = vocab_parallel_ce_terms(logits, h[:, a - lo:], lab, mesh,
                                        axes, v0)
        own = terms[:, max(s0, P) - a:max(s1, P) - a]
        dup = 1 if region is None else region.dup
        return own.sum() / (B * labels.shape[1] * dup)

    # --------------------------------------------------------------- prefill
    def prefill(self, params, batch):
        """Returns (logits [B, 1, vocab] at the last position, caches
        stacked [L, ...]). On DTensor parameters both come back as
        DTensors: logits batch-sharded, the cache laid out as the ranks
        computed it (batch over the batch axes, the KV sequence over the
        sequence axis)."""
        _check_ported(self.cfg, "prefill")
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

        from repro_torch.dist.sharding import _contiguous_stride
        top = self._gather_top(params, region)
        x, positions, prefix = self._embed_inputs(top, batch, region)
        h, caches = self._stack(top, x, positions=positions,
                                prefix_len=prefix, collect_cache=True,
                                region=region)
        # the last position lives on the last sequence rank
        last = spmd.gather(h[:, -1:, :], region.mesh, region.seq_axes,
                           1)[:, -1:, :].contiguous()
        logits = self._head(top, last, region)
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

    def _head(self, params, h, region=None):
        """The logits [.., vocab] (fp32). On the mesh path a head whose
        vocab is the rank's tp shard gives its slice of the logits, and
        the slices are gathered over the tp axes."""
        if self.cfg.frontend == "frames":
            y, split = spmd.column_parallel(params["head"], h, region,
                                            self.cfg.vocab, dtype=F32)
        else:
            emb = params["embed"]["embedding"]
            split = spmd.is_shard(region, emb.shape[0], self.cfg.vocab)
            y = (h.to(self.dtype) @ emb.to(self.dtype).T).to(F32)
        return region.tp_gather(y, split) if split else y

    # ---------------------------------------------------------------- decode
    def decode_step(self, params, cache, token, cur_index: int):
        """token: [B, 1] int; cur_index: the position to write. Writes
        that position of `cache` in place; returns (logits [B, 1, vocab],
        cache)."""
        cfg = self.cfg
        _check_ported(cfg, "decode")
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
        x, split = self._lookup(top["embed"], region.local_batch(token),
                                region)
        x = region.seq_out(x, partial=split)
        layers = self._layer_shards(params["layers"])
        for i, w in enumerate(self._windows()):
            x, _ = block_decode(cfg, self._gather_layer(layers[i], region),
                                x, _layer(local, i), cur_index, w,
                                dtype=self.dtype, region=region)
        x = _norm_apply(cfg, top["final_norm"], x)
        logits = self._head(top, x, region)
        return region.global_out(logits, (token.shape[0],)
                                 + tuple(logits.shape[1:])), cache

    # ------------------------------------------------------------- cache init
    def init_cache(self, B: int, S: int, *, dtype=None, device=None) -> dict:
        """Zeroed cache with leading layer dim [L, ...]."""
        cfg = self.cfg
        _check_ported(cfg, "the decode cache")
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
    taken in bf16, as the reference takes them: the value `LM.loss`
    takes for a tied-embedding LM on one device."""
    emb = embedding.to(torch.bfloat16)
    terms = vocab_parallel_ce_terms(
        lambda hc: (hc.to(torch.bfloat16) @ emb.T).to(F32), h, labels,
        chunk=chunk)
    return terms.sum() / terms.numel()


def vocab_parallel_ce_terms(logits_fn, h: torch.Tensor, labels: torch.Tensor,
                            mesh=None, axes=(), v0: int = 0, *,
                            chunk: int = 512) -> torch.Tensor:
    """Per-position CE terms [B, S] (fp32) of logits whose vocab may be
    sharded over the mesh `axes`: `logits_fn(hc)` is this rank's slice
    [B, c, V_local] (vocab rows v0 ...) of the logits of hc. The
    logsumexp takes its max and its sum over the ranks by all-reduce; the
    label's logit comes from the rank that holds it (no axes: the whole
    vocab, and the all-reduces are the identity). Chunked over S so that
    no [B, S, V] tensor exists; each chunk's logits are recomputed in the
    backward pass, as the reference's per-chunk
    `jax.checkpoint(nothing_saveable)` does."""
    S = h.shape[1]
    chunk = min(chunk, S)
    while S % chunk:        # e.g. vlm text length 3840 → chunk 256
        chunk //= 2

    def one(hc, lc):
        z = logits_fn(hc)
        m = spmd.all_reduce(torch.amax(z.detach(), -1, keepdim=True), mesh,
                            axes, "max")
        tot = spmd.all_reduce(torch.sum(torch.exp(z - m), -1), mesh, axes)
        loc = lc.long() - v0
        own = (loc >= 0) & (loc < z.shape[-1])
        zl = torch.gather(z, -1, loc.clamp(0, z.shape[-1] - 1)[..., None])
        zl = spmd.all_reduce(torch.where(own, zl[..., 0], 0.0), mesh, axes)
        return torch.log(tot) + m[..., 0] - zl

    return torch.cat([torch.utils.checkpoint.checkpoint(
        one, h[:, c0:c0 + chunk], labels[:, c0:c0 + chunk],
        use_reentrant=False) for c0 in range(0, S, chunk)], dim=1)


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
