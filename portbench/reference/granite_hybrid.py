"""granite-4.0-h (IBM's `granitemoehybrid` with no experts), plain PyTorch
in float32.

A pre-norm residual stack of Mamba-2 and attention layers between a token
embedding and a tied output head, with the source's µP multipliers:

  h = embedding_multiplier · embedding[tokens]
  per layer l, its mixer M = Mamba-2 or attention as layer_types[l] says:
    h = h + residual_multiplier · M(rmsnorm(h))
    h = h + residual_multiplier · mlp(rmsnorm(h))
  logits = rmsnorm(h) @ embedding^T / logits_scaling

mlp(u) = (silu(u @ W_gate) · (u @ W_up)) @ W_down, width
shared_intermediate_size (num_local_experts 0: the shared MLP alone).

attention(u): q, k, v = u @ W_q, u @ W_k, u @ W_v in heads of
hidden_size / num_attention_heads; grouped-query: q head h reads KV head
h // (heads / kv heads); no positional encoding (position_embedding_type
"nope"); causal softmax(q·kᵀ · attention_multiplier) · v, then @ W_o. No
biases.

Mamba-2(u), one group, as `reference/mamba2.py`'s block and with its
SSD: [z | xBC | dt] = u @ W_in; xBC = silu(causal depthwise conv (width
mamba_d_conv, with bias) of xBC); x (heads of mamba_d_head), B, C =
split(xBC); dt = softplus(dt + dt_bias); A = −exp(A_log);
y = SSD(x·dt, A·dt, B, C) + D·x in chunks of mamba_chunk_size; the gated
RMSNorm after the gate, rmsnorm(y · silu(z)); out = y @ W_out.

Every RMSNorm takes rms_norm_eps. The run takes the first
num_hidden_layers entries of layer_types.

Departures from the published model, each as the port runs it: the
logits of the loss are taken in bfloat16 (the hidden state and the
embedding rounded to bf16, the product widened to f32) before the
division by logits_scaling; the MLP's `input_linear`, whose output's
first half is the gate and second half the up projection, is held as two
leaves `w_gate` and `w_up`, the same arithmetic; the initialisation is
the configuration file's. Each layer runs under activation checkpointing,
which changes no value.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from portbench.reference import mamba2
from portbench.reference.mamba2 import rmsnorm, unflatten


def sizes(cfg: dict) -> dict:
    D, H = cfg["hidden_size"], cfg["num_attention_heads"]
    di = cfg["mamba_expand"] * D
    return {"D": D, "H": H, "KV": cfg["num_key_value_heads"],
            "hd": D // H, "F": cfg["shared_intermediate_size"],
            "di": di, "Hs": di // cfg["mamba_d_head"],
            "P": cfg["mamba_d_head"], "N": cfg["mamba_d_state"],
            "W": cfg["mamba_d_conv"], "Q": cfg["mamba_chunk_size"],
            "V": cfg["vocab_size"], "eps": cfg["rms_norm_eps"],
            "emb": cfg["embedding_multiplier"],
            "res": cfg["residual_multiplier"],
            "att": cfg["attention_multiplier"],
            "div": cfg["logits_scaling"]}


def kinds(cfg: dict) -> list:
    """Each layer's kind, "ssm" (Mamba-2) or "attention", in order."""
    names = {"mamba": "ssm", "attention": "attention"}
    return [names[t] for t in cfg["layer_types"][:cfg["num_hidden_layers"]]]


def spec(cfg: dict) -> list:
    """[(path, shape)] in flat order (sorted keys; each kind's layer
    leaves stacked [L_kind, ...] under layers/<kind>)."""
    z = sizes(cfg)
    D, F_, di, N, Hs, W = z["D"], z["F"], z["di"], z["N"], z["Hs"], z["W"]
    qd, kvd = z["H"] * z["hd"], z["KV"] * z["hd"]
    conv = di + 2 * N
    per = {
        "attention": {("attn_norm", "scale"): (D,), ("wq", "kernel"): (D, qd),
                      ("wk", "kernel"): (D, kvd), ("wv", "kernel"): (D, kvd),
                      ("wo", "kernel"): (qd, D)},
        "ssm": {("ssm_norm", "scale"): (D,), ("ssm", "A_log"): (Hs,),
                ("ssm", "D"): (Hs,), ("ssm", "conv_b"): (conv,),
                ("ssm", "conv_w"): (W, conv), ("ssm", "dt_bias"): (Hs,),
                ("ssm", "in_proj", "kernel"): (D, 2 * di + 2 * N + Hs),
                ("ssm", "norm", "scale"): (di,),
                ("ssm", "out_proj", "kernel"): (di, D)},
    }
    mlp = {("ffn_norm", "scale"): (D,), ("w_gate", "kernel"): (D, F_),
           ("w_up", "kernel"): (D, F_), ("w_down", "kernel"): (F_, D)}
    leaves = {("embed", "embedding"): (z["V"], D),
              ("final_norm", "scale"): (D,)}
    ks = kinds(cfg)
    for kind in set(ks):
        n = ks.count(kind)
        for path, shape in {**per[kind], **mlp}.items():
            leaves[("layers", kind) + path] = (n,) + shape
    return sorted(leaves.items())


def mamba(u, g, z: dict, prec):
    r = prec.r
    Bsz, S, _ = u.shape
    di, Hs, N, W = z["di"], z["Hs"], z["N"], z["W"]
    zxbcdt = r(u) @ r(g("ssm/in_proj/kernel"))
    zg, xBC, dt = torch.split(zxbcdt, [di, di + 2 * N, Hs], dim=-1)
    w = g("ssm/conv_w")                                    # [W, C]
    xBC = F.conv1d(F.pad(xBC.transpose(1, 2), (W - 1, 0)),
                   w.t()[:, None, :], g("ssm/conv_b"), groups=w.shape[1])
    xBC = F.silu(xBC.transpose(1, 2))
    x, Bm, Cm = torch.split(xBC, [di, N, N], dim=-1)
    dt = F.softplus(dt + g("ssm/dt_bias"))                 # [B, S, Hs]
    A = -torch.exp(g("ssm/A_log"))
    xh = x.reshape(Bsz, S, Hs, z["P"])
    y = mamba2.ssd(xh * dt[..., None], A * dt,
                   Bm[:, :, None].expand(-1, -1, Hs, -1),
                   Cm[:, :, None].expand(-1, -1, Hs, -1), z["Q"], prec)
    y = (y + xh * g("ssm/D")[:, None]).reshape(Bsz, S, di)
    y = rmsnorm(y * F.silu(zg), g("ssm/norm/scale"), z["eps"])
    return r(y) @ r(g("ssm/out_proj/kernel"))


def attention(u, g, z: dict, prec):
    r = prec.r
    Bsz, S, _ = u.shape
    H, KV, hd = z["H"], z["KV"], z["hd"]
    heads = lambda t, n: t.view(Bsz, S, n, hd).transpose(1, 2)
    q = heads(r(u) @ r(g("wq/kernel")), H)
    k = heads(r(u) @ r(g("wk/kernel")), KV).repeat_interleave(H // KV, 1)
    v = heads(r(u) @ r(g("wv/kernel")), KV).repeat_interleave(H // KV, 1)
    s = (r(q) @ r(k).transpose(-1, -2)) * z["att"]
    above = torch.ones(S, S, dtype=torch.bool, device=u.device).triu(1)
    a = torch.softmax(s.masked_fill(above, -torch.inf), dim=-1)
    o = (r(a) @ r(v)).transpose(1, 2).reshape(Bsz, S, H * hd)
    return r(o) @ r(g("wo/kernel"))


def layer(h, p: dict, kind: str, i: int, z: dict, prec):
    r = prec.r
    g = lambda k: p[f"layers/{kind}/{k}"][i]
    if kind == "ssm":
        m = mamba(rmsnorm(h, g("ssm_norm/scale"), z["eps"]), g, z, prec)
    else:
        m = attention(rmsnorm(h, g("attn_norm/scale"), z["eps"]), g, z,
                      prec)
    h = h + m * z["res"]
    u = r(rmsnorm(h, g("ffn_norm/scale"), z["eps"]))
    f = F.silu(u @ r(g("w_gate/kernel"))) * (u @ r(g("w_up/kernel")))
    return h + (r(f) @ r(g("w_down/kernel"))) * z["res"]


def hidden(flat, sp, cfg: dict, tokens, prec):
    """The final RMSNorm's output [B, S, D] of tokens [B, S]."""
    z = sizes(cfg)
    p = unflatten(flat, sp)
    h = F.embedding(tokens, p["embed/embedding"]) * z["emb"]
    seen = {"ssm": 0, "attention": 0}
    for kind in kinds(cfg):
        h = torch.utils.checkpoint.checkpoint(
            layer, h, p, kind, seen[kind], z, prec, use_reentrant=False)
        seen[kind] += 1
    return rmsnorm(h, p["final_norm/scale"], z["eps"])


def _ce_sum(h, emb16, labels, div):
    logits = (h.to(torch.bfloat16) @ emb16.T).float() / div
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1), reduction="sum")


def loss(flat, sp, cfg: dict, tokens, labels, prec, chunk: int = 512):
    """Mean next-token cross-entropy of tokens [B, S] against labels."""
    h = hidden(flat, sp, cfg, tokens, prec)
    emb16 = unflatten(flat, sp)["embed/embedding"].to(torch.bfloat16)
    div = sizes(cfg)["div"]
    total = sum(torch.utils.checkpoint.checkpoint(
        _ce_sum, h[:, s:s + chunk], emb16, labels[:, s:s + chunk], div,
        use_reentrant=False) for s in range(0, h.shape[1], chunk))
    return total / labels.numel()


def forward_flops(cfg: dict) -> int:
    """2 x multiply-adds of one token's forward: the matrix products of
    every layer's mixer and MLP and of the tied head; in the Mamba-2
    layers the depthwise conv and the SSD chunk terms as
    `mamba2.forward_flops` counts them; in the attention layers the
    causal half of q·kᵀ and of the scores' product with v at the
    configuration's `context` (H·hd·context per token)."""
    z = sizes(cfg)
    D, F_, di, N, Hs, P, W, Q = (z[k] for k in ("D", "F", "di", "N", "Hs",
                                                "P", "W", "Q"))
    qd, kvd = z["H"] * z["hd"], z["KV"] * z["hd"]
    mlp = 3 * D * F_
    ssm = D * (2 * di + 2 * N + Hs) + di * D + W * (di + 2 * N) \
        + Q * N + Q * Hs * P + 2 * Hs * P * N
    attn = 2 * D * qd + 2 * D * kvd + qd * cfg["context"]
    ks = kinds(cfg)
    per = ks.count("ssm") * ssm + ks.count("attention") * attn
    return 2 * (per + len(ks) * mlp + D * z["V"])

