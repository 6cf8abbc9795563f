"""Mamba-2 (SSD, state-space duality — arXiv:2405.21060), chunked
(PyTorch port of `repro.models.mamba2`).

Train/prefill use the chunked SSD algorithm: within-chunk "attention-like"
term via the segment-sum decay matrix, across-chunk linear recurrence over
chunk states (O(S·Q) compute, O(S/Q) sequential steps, state [H, P, N]
carried in fp32). Decode is the O(1) per-token recurrence over the same
state.

`ssd_chunked` is `kernels.ssd.ssd` on every device: one custom-op
dispatch runs the hand-written CUDA kernels of `kernels/csrc/ssd.cu`
(forward and backward) on a card and their plain versions on the CPU.
`ssd_reference` is the O(S) oracle the tests hold it to.

Block layout follows the reference Mamba2 module: in_proj → (z | xBC | dt),
depthwise causal conv over xBC, SSD, gated RMSNorm, out_proj. n_groups=1.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd import ssd as ssd_chunked
from repro_torch.models import nn

F32 = torch.float32


class SSMSpec(NamedTuple):
    d_model: int
    d_inner: int       # expand * d_model
    n_heads: int       # d_inner // head_dim
    head_dim: int      # P
    state: int         # N
    conv_width: int
    norm_eps: float = 1e-6   # the gated RMSNorm's epsilon


def spec_from_cfg(cfg) -> SSMSpec:
    d_inner = cfg.ssm_expand * cfg.d_model
    return SSMSpec(cfg.d_model, d_inner, d_inner // cfg.ssm_head_dim,
                   cfg.ssm_head_dim, cfg.ssm_state, cfg.conv_width,
                   cfg.norm_eps)


# ------------------------------------------------------------------------ init
def mamba2_init(gen: torch.Generator, s: SSMSpec, *, device=None) -> dict:
    conv_ch = s.d_inner + 2 * s.state          # x, B, C share the conv
    d_in_proj = 2 * s.d_inner + 2 * s.state + s.n_heads  # z,xBC,dt
    return {
        "in_proj": nn.linear_init(gen, s.d_model, d_in_proj, use_bias=False,
                                  device=device),
        "conv_w": nn.lecun_normal(gen, (s.conv_width, conv_ch), device),
        "conv_b": torch.zeros(conv_ch, device=device),
        "A_log": torch.zeros(s.n_heads, device=device),     # A = -exp(A_log)
        "dt_bias": torch.full((s.n_heads,), math.log(math.e - 1),
                              device=device),
        "D": torch.ones(s.n_heads, device=device),
        "norm": nn.rmsnorm_init(s.d_inner, device=device),
        "out_proj": nn.linear_init(gen, s.d_inner, s.d_model, use_bias=False,
                                   device=device),
    }


# ------------------------------------------------------------------ block apply
def _split_proj(s: SSMSpec, zxbcdt: torch.Tensor):
    return torch.split(zxbcdt, [s.d_inner, s.d_inner + 2 * s.state,
                                s.n_heads], dim=-1)


def _projections(p, dtype, in_proj, out_proj):
    """The block's two projections: the given callables, else the plain
    linears (`in_proj(x)` is the whole [z | xBC | dt] row, `out_proj(y)`
    the block's output)."""
    return (in_proj or (lambda x: nn.linear_apply(p["in_proj"], x,
                                                  dtype=dtype)),
            out_proj or (lambda y: nn.linear_apply(p["out_proj"], y,
                                                   dtype=dtype)))


def mamba2_train(p, s: SSMSpec, x: torch.Tensor, *, chunk: int = 256,
                 dtype=torch.bfloat16, return_state: bool = False,
                 in_proj=None, out_proj=None):
    """x: [B, S, d_model] -> [B, S, d_model] (full-sequence train/prefill).
    With `return_state`, also (final SSM state, conv state); the conv state
    holds the last W−1 PRE-activation (pre-bias, pre-silu) xBC rows.
    `in_proj` / `out_proj` replace the two linears (the mesh path's
    tensor-parallel projections)."""
    B, S, _ = x.shape
    in_proj, out_proj = _projections(p, dtype, in_proj, out_proj)
    zxbcdt = in_proj(x)
    z, xBC, dt = _split_proj(s, zxbcdt)

    # depthwise causal conv over features of xBC
    w = p["conv_w"].to(F32)                              # [W, conv_ch]
    xBC32 = xBC.to(F32)
    pad = F.pad(xBC32, (0, 0, s.conv_width - 1, 0))
    conv = sum(pad[:, i:i + S, :] * w[i] for i in range(s.conv_width))
    xBC = nn.silu(conv + p["conv_b"].to(F32))

    xh, Bm, Cm = torch.split(xBC, [s.d_inner, s.state, s.state], dim=-1)
    xh = xh.reshape(B, S, s.n_heads, s.head_dim)
    dt = nn.softplus(dt.to(F32) + p["dt_bias"].to(F32))
    A = -torch.exp(p["A_log"].to(F32))                   # [H]
    dtA = dt * A[None, None, :]                          # [B,S,H]

    y, final = ssd_chunked(xh, dtA, dt, Bm, Cm, chunk=chunk)
    y = y + xh.to(F32) * p["D"].to(F32)[None, None, :, None]
    y = y.reshape(B, S, s.d_inner)
    y = nn.rmsnorm_apply(p["norm"], y * nn.silu(z.to(F32)), eps=s.norm_eps)
    out = out_proj(y.to(dtype))
    if return_state:
        W1 = s.conv_width - 1
        conv_state = xBC32[:, S - W1:, :] if S >= W1 \
            else F.pad(xBC32, (0, 0, W1 - S, 0))
        return out.to(x.dtype), (final, conv_state)
    return out.to(x.dtype)


def mamba2_decode(p, s: SSMSpec, x: torch.Tensor, state: torch.Tensor,
                  conv_state: torch.Tensor, *, dtype=torch.bfloat16,
                  in_proj=None, out_proj=None):
    """One token. x: [B, 1, d_model]; state: [B,H,P,N] fp32;
    conv_state: [B, W-1, conv_ch] fp32 (pre-activation xBC history).
    Returns (out [B, 1, d_model], new_state, new_conv_state).
    `in_proj` / `out_proj` as in `mamba2_train`."""
    B = x.shape[0]
    in_proj, out_proj = _projections(p, dtype, in_proj, out_proj)
    zxbcdt = in_proj(x[:, 0, :])
    z, xBC_new, dt = _split_proj(s, zxbcdt)

    hist = torch.cat([conv_state, xBC_new.to(F32)[:, None, :]], dim=1)
    w = p["conv_w"].to(F32)
    conv = torch.einsum("bwc,wc->bc", hist, w) + p["conv_b"].to(F32)
    xBC = nn.silu(conv)
    new_conv_state = hist[:, 1:, :]

    xh, Bm, Cm = torch.split(xBC, [s.d_inner, s.state, s.state], dim=-1)
    xh = xh.reshape(B, s.n_heads, s.head_dim)
    dt = nn.softplus(dt.to(F32) + p["dt_bias"].to(F32))
    A = -torch.exp(p["A_log"].to(F32))
    a = torch.exp(dt * A[None, :])                        # [B,H]
    new_state = state * a[..., None, None] + \
        torch.einsum("bh,bhp,bn->bhpn", dt, xh.to(F32), Bm)
    y = torch.einsum("bn,bhpn->bhp", Cm, new_state)
    y = y + xh.to(F32) * p["D"].to(F32)[None, :, None]
    y = y.reshape(B, s.d_inner)
    y = nn.rmsnorm_apply(p["norm"], y * nn.silu(z.to(F32)), eps=s.norm_eps)
    out = out_proj(y.to(dtype))
    return out[:, None, :].to(x.dtype), new_state, new_conv_state


# ---------------------------------------------------------------------- oracle
def ssd_reference(xh, dtA, dtx_scale, Bm, Cm, initial_state=None):
    """O(S) sequential recurrence oracle for tests (exact SSD semantics),
    in fp32, or in float64 when xh is float64."""
    b, S, H, P = xh.shape
    N = Bm.shape[-1]
    ft = torch.promote_types(xh.dtype, F32)
    st = torch.zeros((b, H, P, N), dtype=ft, device=xh.device) \
        if initial_state is None else initial_state.to(ft)
    ys = []
    for t in range(S):
        a = torch.exp(dtA[:, t, :]).to(ft)                       # [b,H]
        xt = (xh[:, t] * dtx_scale[:, t, :, None]).to(ft)
        st = st * a[..., None, None] + torch.einsum("bhp,bn->bhpn", xt,
                                                    Bm[:, t].to(ft))
        ys.append(torch.einsum("bn,bhpn->bhp", Cm[:, t].to(ft), st))
    return torch.stack(ys, dim=1), st                            # [b,S,H,P]
