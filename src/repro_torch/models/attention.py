"""Attention: GQA/MQA + RoPE + sliding window + prefix-LM (PyTorch port of
`repro.models.attention`).

Training/prefill attention is `F.scaled_dot_product_attention` in fp32
over an explicit boolean [S, S] mask (`_mask`: causal, sliding window,
prefix-LM), with K/V repeated to the query heads. The reference's
double-chunked flash attention is jnp (a scan with a running max and
sum), not a Pallas kernel, so a library call stands in for it.

Decode is one token against the cache, written as the reference writes
it so that reductions run over the cache's S axis. int8 caches keep the
reference's arithmetic: q and the probabilities are quantized to int8
codes per (b, kv, g) and both dots multiply int8 codes. PyTorch has no
s8×s8→s32 product on the card, so the codes are widened to a float type
in which every partial sum is an exact integer (fp32 while terms·127² <
2^24, else fp64): both dots are exact, as the reference's integer dots.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG_INF = -1e30
FULL_WINDOW = 1 << 30     # "window" value meaning full attention


# ------------------------------------------------------------------------ rope
def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """x: [..., S, H, hd] (hd even), positions: [S] or [B, S] int."""
    hd = x.shape[-1]
    half = hd // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freq     # [..., S, half]
    ang = ang[..., None, :]                                 # broadcast H
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1.to(x.dtype), y2.to(x.dtype)], dim=-1)


# ------------------------------------------------------------------------ mask
def _mask(qpos: torch.Tensor, kpos: torch.Tensor, *, causal: bool,
          window: int | None, prefix_len: int) -> torch.Tensor:
    """True where q may attend k. qpos [qc], kpos [kc] absolute positions;
    `window` FULL_WINDOW (or None) means no windowing."""
    q = qpos[:, None]
    k = kpos[None, :]
    if causal:
        m = k <= q
        if prefix_len:
            m = m | (k < prefix_len)          # prefix-LM: prefix always visible
    else:
        m = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                       device=qpos.device)
    if window is not None:
        m = m & (k > q - window)
    return m


def _heads_first(q, k, v):
    """[B, S, H|KV, hd] -> [B, H, S, hd] fp32, K/V repeated to the H query
    heads (head h = kv·G + g, the reference's [KV, G] split)."""
    G = q.shape[2] // k.shape[2]
    q, k, v = (t.to(torch.float32).transpose(1, 2) for t in (q, k, v))
    if G > 1:
        k = k.repeat_interleave(G, dim=1)
        v = v.repeat_interleave(G, dim=1)
    return q, k, v


# ------------------------------------------------- flash attention (train/prefill)
MASK_ELEMS = 1 << 26     # the largest [Sq, Sk] mask made at once
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    prefix_len: int = 0,
                    softmax_scale: float | None = None,
                    q_offset: int = 0) -> torch.Tensor:
    """q: [B, Sq, H, hd], k/v: [B, S, KV, hd] with H = KV * G. Returns
    [B, Sq, H, hd] in q's dtype; the softmax runs in fp32. The queries sit
    at positions q_offset .. q_offset + Sq - 1 (Sq = S, q_offset = 0 for a
    whole sequence). Past MASK_ELEMS mask entries the queries run in
    chunks of MASK_ELEMS // S rows."""
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    if Sq * Sk > MASK_ELEMS and Sq > 1:
        # query chunks, so that no [Sq, Sk] mask (nor SDPA's float copy
        # of it) is made whole: a 32k prefill's would take 5.4 GB
        n = max(1, MASK_ELEMS // Sk)
        return torch.cat([flash_attention(
            q[:, i:i + n], k, v, causal=causal, window=window,
            prefix_len=prefix_len, softmax_scale=softmax_scale,
            q_offset=q_offset + i) for i in range(0, Sq, n)], dim=1)
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(hd)
    kpos = torch.arange(Sk, device=q.device)
    qpos = kpos if Sq == Sk and not q_offset else \
        torch.arange(q_offset, q_offset + Sq, device=q.device)
    msk = _mask(qpos, kpos, causal=causal, window=window,
                prefix_len=prefix_len)
    qh, kh, vh = _heads_first(q, k, v)
    out = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=msk,
                                         scale=scale)
    return out.transpose(1, 2).to(q.dtype)


# --------------------------------------------------------------- decode (1 token)
def _exact_dtype(terms: int) -> torch.dtype:
    """A float type in which a sum of `terms` products of int8 codes
    (each |.| <= 127²) is exact."""
    return torch.float32 if terms * 127 * 127 < 2 ** 24 else torch.float64


def quantize_rows(x: torch.Tensor, floor: float):
    """Per-row symmetric int8 codes of x [..., n] (as float values) and
    their fp32 scales [...]: s = max(max|x| / 127, floor), codes =
    clip(round(x / s), ±127), rounding half to even as `jnp.round`."""
    s = torch.clamp(torch.amax(torch.abs(x), dim=-1) / 127.0, min=floor)
    return torch.clamp(torch.round(x / s[..., None]), -127, 127), s


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cur_index: int, *,
                     window: int | None = None,
                     softmax_scale: float | None = None,
                     k_scale: torch.Tensor | None = None,
                     v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """q: [B, 1, H, hd]; caches: [B, S, KV, hd]; cur_index: the position
    being written/read this step (attends to [0, cur_index]).

    int8 caches: pass per-(position, head) `k_scale`/`v_scale` [B, S, KV];
    the dequantization folds into the logits (×k_scale after the dot) and
    the PV contraction (×v_scale into p before the dot)."""
    B, _, H, hd = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(hd)
    qh = q.reshape(B, KV, G, hd)

    if k_scale is not None:
        q8, qs = quantize_rows(qh.to(torch.float32), 1e-8)     # [B,KV,G]
        wide = _exact_dtype(hd)
        li = torch.einsum("bkgd,bskd->bkgs", q8.to(wide), k_cache.to(wide))
        logits = li.to(torch.float32) * qs[..., None] * scale \
            * k_scale.permute(0, 2, 1)[:, :, None, :]
    else:
        logits = torch.einsum("bkgd,bskd->bkgs", qh.to(torch.float32),
                              k_cache.to(torch.float32)) * scale

    pos = torch.arange(S, device=q.device)
    valid = pos <= cur_index
    if window is not None:
        valid = valid & (pos > cur_index - window)
    logits = torch.where(valid[None, None, None, :], logits,
                         torch.full((), NEG_INF, device=q.device))
    m = torch.amax(logits, dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    pn = p / torch.clamp(l, min=1e-30)
    if v_scale is not None:
        pf = pn * v_scale.permute(0, 2, 1)[:, :, None, :]
        p8, ps = quantize_rows(pf, 1e-12)                       # [B,KV,G]
        wide = _exact_dtype(S)
        oi = torch.einsum("bkgs,bskd->bkgd", p8.to(wide), v_cache.to(wide))
        out = oi.to(torch.float32) * ps[..., None]
    else:
        out = torch.einsum("bkgs,bskd->bkgd", pn.to(v_cache.dtype),
                           v_cache).to(torch.float32)
    return out.reshape(B, 1, H, hd).to(q.dtype)


def decode_attention_sharded(q: torch.Tensor, k_cache: torch.Tensor,
                             v_cache: torch.Tensor, cur_index: int, *,
                             seq_offset: int, seq_len: int, reduce,
                             window: int | None = None,
                             softmax_scale: float | None = None,
                             k_scale: torch.Tensor | None = None,
                             v_scale: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """`decode_attention` over a sequence-sharded cache (flash decoding):
    this rank holds positions [seq_offset, seq_offset + S_local) of a
    length-`seq_len` cache. Each rank takes its partial softmax; the
    (max, sum, out) terms are combined over the shards by
    `reduce(x, op)` (an all-reduce over the sequence axes, op "max" or
    "sum"): the row max first, so every probability is the unsharded
    one's up to the order of the sum. The int8 cache quantizes the
    probabilities with the row's global max and sums the exact integer
    dots over the shards."""
    B, _, H, hd = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(hd)
    qh = q.reshape(B, KV, G, hd)
    if k_scale is not None:
        q8, qs = quantize_rows(qh.to(torch.float32), 1e-8)
        wide = _exact_dtype(hd)
        li = torch.einsum("bkgd,bskd->bkgs", q8.to(wide), k_cache.to(wide))
        logits = li.to(torch.float32) * qs[..., None] * scale \
            * k_scale.permute(0, 2, 1)[:, :, None, :]
    else:
        logits = torch.einsum("bkgd,bskd->bkgs", qh.to(torch.float32),
                              k_cache.to(torch.float32)) * scale
    pos = torch.arange(seq_offset, seq_offset + S, device=q.device)
    valid = pos <= cur_index
    if window is not None:
        valid = valid & (pos > cur_index - window)
    logits = torch.where(valid[None, None, None, :], logits,
                         torch.full((), NEG_INF, device=q.device))
    m = reduce(torch.amax(logits, dim=-1, keepdim=True), "max")
    p = torch.exp(logits - m)
    l = reduce(torch.sum(p, dim=-1, keepdim=True), "sum")
    pn = p / torch.clamp(l, min=1e-30)
    if v_scale is not None:
        pf = pn * v_scale.permute(0, 2, 1)[:, :, None, :]
        ps = torch.clamp(reduce(torch.amax(torch.abs(pf), dim=-1), "max")
                         / 127.0, min=1e-12)
        p8 = torch.clamp(torch.round(pf / ps[..., None]), -127, 127)
        wide = _exact_dtype(seq_len)
        oi = reduce(torch.einsum("bkgs,bskd->bkgd", p8.to(wide),
                                 v_cache.to(wide)), "sum")
        out = oi.to(torch.float32) * ps[..., None]
    else:
        out = reduce(torch.einsum("bkgs,bskd->bkgd", pn.to(v_cache.dtype),
                                  v_cache).to(torch.float32), "sum")
    return out.reshape(B, 1, H, hd).to(q.dtype)


# -------------------------------------------------------------------- reference
def reference_attention(q, k, v, *, causal=True, window=None, prefix_len=0,
                        softmax_scale=None):
    """O(S²) oracle for tests: explicit logits, mask and softmax."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(hd)
    qr = q.reshape(B, S, KV, G, hd).to(torch.float32)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qr,
                          k.to(torch.float32)) * scale
    pos = torch.arange(S, device=q.device)
    msk = _mask(pos, pos, causal=causal, window=window, prefix_len=prefix_len)
    logits = torch.where(msk[None, None, None], logits,
                         torch.full((), NEG_INF, device=q.device))
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bkgqd", w, v.to(torch.float32))
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd).to(q.dtype)
