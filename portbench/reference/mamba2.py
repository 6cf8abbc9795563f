"""Mamba-2 language model (arXiv:2405.21060), plain PyTorch in float32.

A pre-norm residual stack of Mamba-2 blocks between a token embedding and
a tied output head:

  h = embedding[tokens]
  per layer:  h = h + block(rmsnorm(h))
  logits = rmsnorm(h) @ embedding^T

block(u): [z | xBC | dt] = u @ W_in; xBC = silu(causal depthwise conv
(width d_conv) of xBC + b); split xBC into x (heads of head_dim), B, C
(one group, d_state each); dt = softplus(dt + dt_bias); A = −exp(A_log);
y = SSD(x·dt, A·dt, B, C) + D·x; out = rmsnorm(y · silu(z)) @ W_out.

SSD is the paper's minimal chunked algorithm (Listing 1): within a chunk
the quadratic "attention" form with the decay matrix exp(segsum(A)),
across chunks the state recurrence, with the paper's stable segsum.

Departures from the published model, each as the port runs it: the
logits of the loss are taken in bfloat16 (the hidden state and the
embedding rounded to bf16, the product widened to f32), as the JAX
package and its port take them; rms-norm epsilon, vocabulary size and
initialisation are the configuration file's. Each layer runs under
activation checkpointing, which changes no value.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
import torch.utils.checkpoint


def sizes(cfg: dict) -> dict:
    s = cfg["ssm_cfg"]
    di = s["expand"] * cfg["d_model"]
    return {"D": cfg["d_model"], "di": di, "H": di // s["headdim"],
            "P": s["headdim"], "N": s["d_state"], "W": s["d_conv"],
            "Q": s["chunk_size"], "V": cfg["vocab_size"],
            "L": cfg["n_layer"], "eps": cfg["norm_epsilon"]}


def spec(cfg: dict) -> list:
    """[(path, shape)] in flat order (sorted keys; layer leaves stacked
    [L, ...])."""
    z = sizes(cfg)
    L, D, di, H, N, W = z["L"], z["D"], z["di"], z["H"], z["N"], z["W"]
    conv = di + 2 * N
    leaves = {
        ("embed", "embedding"): (z["V"], D),
        ("final_norm", "scale"): (D,),
        ("layers", "ssm", "A_log"): (L, H),
        ("layers", "ssm", "D"): (L, H),
        ("layers", "ssm", "conv_b"): (L, conv),
        ("layers", "ssm", "conv_w"): (L, W, conv),
        ("layers", "ssm", "dt_bias"): (L, H),
        ("layers", "ssm", "in_proj", "kernel"): (L, D, 2 * di + 2 * N + H),
        ("layers", "ssm", "norm", "scale"): (L, di),
        ("layers", "ssm", "out_proj", "kernel"): (L, di, D),
        ("layers", "ssm_norm", "scale"): (L, D),
    }
    return sorted(leaves.items())


def unflatten(flat, sp) -> dict:
    out, pos = {}, 0
    for path, shape in sp:
        n = math.prod(shape)
        out["/".join(path)] = flat[pos:pos + n].view(shape)
        pos += n
    return out


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def segsum(x):
    """[..., T] -> [..., T, T]: sum of x over (j, i] at [i, j], −inf above
    the diagonal (the paper's stable form: masked cumsum, no
    difference of cumsums)."""
    T = x.size(-1)
    x = x[..., None].expand(*x.shape, T)
    below = torch.tril(torch.ones(T, T, dtype=torch.bool, device=x.device),
                       -1)
    x = x.masked_fill(~below, 0)
    s = torch.cumsum(x, dim=-2)
    diag = torch.tril(torch.ones(T, T, dtype=torch.bool, device=x.device))
    return s.masked_fill(~diag, -torch.inf)


def ssd(X, A, B, C, Q, prec):
    """X [b, l, h, p], A [b, l, h], B and C [b, l, h, n] -> Y like X."""
    r = prec.r
    b, l, h, p = X.shape
    Q = min(Q, l)
    c = l // Q
    X, B, C = (t.reshape(b, c, Q, *t.shape[2:]) for t in (X, B, C))
    A = A.reshape(b, c, Q, h).permute(0, 3, 1, 2)          # b h c l
    A_cum = torch.cumsum(A, dim=-1)
    Lm = torch.exp(segsum(A))
    Y_diag = torch.einsum("bclhn,bcshn,bhcls,bcshp->bclhp",
                          r(C), r(B), r(Lm), r(X))
    decay_states = torch.exp(A_cum[..., -1:] - A_cum)
    states = torch.einsum("bclhn,bhcl,bclhp->bchpn", r(B), r(decay_states),
                          r(X))
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    decay_chunk = torch.exp(segsum(F.pad(A_cum[..., -1], (1, 0))))
    states = torch.einsum("bhzc,bchpn->bzhpn", r(decay_chunk),
                          r(states))[:, :-1]
    Y_off = torch.einsum("bclhn,bchpn,bhcl->bclhp", r(C), r(states),
                         r(torch.exp(A_cum)))
    return (Y_diag + Y_off).reshape(b, l, h, p)


def block(u, p: dict, i: int, z: dict, prec):
    r = prec.r
    Bsz, S, _ = u.shape
    di, H, N, W = z["di"], z["H"], z["N"], z["W"]
    g = lambda k: p["layers/" + k][i]
    x_in = rmsnorm(u, g("ssm_norm/scale"), z["eps"])
    zxbcdt = r(x_in) @ r(g("ssm/in_proj/kernel"))
    zg, xBC, dt = torch.split(zxbcdt, [di, di + 2 * N, H], dim=-1)
    w = g("ssm/conv_w")                                    # [W, C]
    xBC = F.conv1d(F.pad(xBC.transpose(1, 2), (W - 1, 0)),
                   w.t()[:, None, :], g("ssm/conv_b"), groups=w.shape[1])
    xBC = F.silu(xBC.transpose(1, 2))
    x, Bm, Cm = torch.split(xBC, [di, N, N], dim=-1)
    dt = F.softplus(dt + g("ssm/dt_bias"))                 # [B, S, H]
    A = -torch.exp(g("ssm/A_log"))
    xh = x.reshape(Bsz, S, H, z["P"])
    y = ssd(xh * dt[..., None], A * dt, Bm[:, :, None].expand(-1, -1, H, -1),
            Cm[:, :, None].expand(-1, -1, H, -1), z["Q"], prec)
    y = (y + xh * g("ssm/D")[:, None]).reshape(Bsz, S, di)
    y = rmsnorm(y * F.silu(zg), g("ssm/norm/scale"), z["eps"])
    return u + r(y) @ r(g("ssm/out_proj/kernel"))


def _ce_sum(h, emb16, labels):
    logits = (h.to(torch.bfloat16) @ emb16.T).float()
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1), reduction="sum")


def loss(flat, sp, cfg: dict, tokens, labels, prec, chunk: int = 512):
    """Mean next-token cross-entropy of tokens [B, S] against labels."""
    z = sizes(cfg)
    p = unflatten(flat, sp)
    emb = p["embed/embedding"]
    h = F.embedding(tokens, emb)
    for i in range(z["L"]):
        h = torch.utils.checkpoint.checkpoint(
            block, h, p, i, z, prec, use_reentrant=False)
    h = rmsnorm(h, p["final_norm/scale"], z["eps"])
    emb16 = emb.to(torch.bfloat16)
    total = sum(torch.utils.checkpoint.checkpoint(
        _ce_sum, h[:, s:s + chunk], emb16, labels[:, s:s + chunk],
        use_reentrant=False) for s in range(0, h.shape[1], chunk))
    return total / labels.numel()


def forward_flops(cfg: dict) -> int:
    """2 x multiply-adds of one token's forward: the matrix products of
    in_proj, out_proj and the tied head, the depthwise conv and the SSD
    chunk terms (C·Bᵀ per chunk, its product with x, the chunk states and
    their output term)."""
    z = sizes(cfg)
    D, N, Q, W, di, H, P = (z[k] for k in ("D", "N", "Q", "W", "di", "H",
                                           "P"))
    in_proj = D * (2 * di + 2 * N + H)
    out_proj = di * D
    conv = W * (di + 2 * N)
    ssd = Q * N + Q * H * P + 2 * H * P * N
    return 2 * (z["L"] * (in_proj + out_proj + conv + ssd) + D * z["V"])
