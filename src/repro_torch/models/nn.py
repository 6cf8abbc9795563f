"""Minimal functional NN substrate (PyTorch port of `repro.models.nn`).

Every layer is a pair of plain functions over a dict of tensors:
  *_init(gen, ...) -> params    (torch.Generator-seeded)
  layer(params, x) -> y

Layouts follow the reference at every public function, so the flat
parameter vector means the same coordinates in both packages: linear
kernels are [in, out] (`x @ kernel`), conv kernels HWIO and activations
NHWC. They are permuted to OIHW / NCHW only around `F.conv2d` /
`F.max_pool2d`. LSTM gates come in i, f, g, o order with +1.0 on the
forget gate.

Initializers take `(gen, shape, device=None)` and draw with the
generator on `device` (a `torch.Generator` on that device); on the
`meta` device they allocate nothing, which gives a parameter tree's
shapes. dtype policy: `param_dtype` for storage, `dtype` for compute.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
import torch.nn.functional as F

Initializer = Callable[..., torch.Tensor]


# ---------------------------------------------------------------- initializers
def _trunc(gen, shape, device) -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32, device=device)
    return torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)


def trunc_normal(stddev: float = 0.02) -> Initializer:
    """Truncated normal in [-2, 2] times `stddev`."""
    def init(gen, shape, device=None):
        return _trunc(gen, shape, device) * stddev
    return init


def lecun_normal(gen: torch.Generator, shape, device=None) -> torch.Tensor:
    """Truncated normal in [-2, 2] scaled by 1/sqrt(fan_in) (HWIO convs:
    fan_in = H·W·I)."""
    fan_in = shape[0] if len(shape) >= 1 else 1
    if len(shape) == 4:
        fan_in = shape[0] * shape[1] * shape[2]
    return _trunc(gen, shape, device) * (1.0 / math.sqrt(max(1, fan_in)))


# ---------------------------------------------------------------------- linear
def linear_init(gen: torch.Generator, in_dim: int, out_dim: int, *,
                use_bias: bool = True, device=None) -> dict:
    p = {"kernel": lecun_normal(gen, (in_dim, out_dim), device)}
    if use_bias:
        p["bias"] = torch.zeros(out_dim, device=device)
    return p


def linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = torch.matmul(x, p["kernel"])
    if "bias" in p:
        y = y + p["bias"]
    return y


def linear_apply(p: dict, x: torch.Tensor, *, dtype=None) -> torch.Tensor:
    """`x @ kernel (+ bias)`; with `dtype`, kernel, bias and x are cast to
    it first."""
    if dtype is not None:
        p = {k: v.to(dtype) for k, v in p.items()}
        x = x.to(dtype)
    return linear(p, x)


# ------------------------------------------------------------------- embedding
def embedding_init(gen: torch.Generator, vocab: int, dim: int, *,
                   device=None) -> dict:
    return {"embedding": trunc_normal(1.0 / math.sqrt(dim))(
        gen, (vocab, dim), device)}


def embedding_apply(p: dict, ids: torch.Tensor, *, dtype=None
                    ) -> torch.Tensor:
    emb = p["embedding"]
    if dtype is not None:
        emb = emb.to(dtype)
    return F.embedding(ids.long(), emb)


def embedding_attend(p: dict, x: torch.Tensor, *, dtype=None
                     ) -> torch.Tensor:
    """Tied decode head: logits = x @ E^T."""
    emb = p["embedding"]
    if dtype is not None:
        emb, x = emb.to(dtype), x.to(dtype)
    return x @ emb.T


# ----------------------------------------------------------------------- norms
def rmsnorm_init(dim: int, *, device=None) -> dict:
    return {"scale": torch.ones(dim, device=device)}


def rmsnorm_apply(p: dict, x: torch.Tensor, *, eps: float = 1e-6,
                  upcast: bool = True) -> torch.Tensor:
    orig = x.dtype
    if upcast:
        x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps) * p["scale"].to(x.dtype)
    return y.to(orig)


def layernorm_init(dim: int, *, device=None) -> dict:
    return {"scale": torch.ones(dim, device=device),
            "bias": torch.zeros(dim, device=device)}


def layernorm_apply(p: dict, x: torch.Tensor, *, eps: float = 1e-5
                    ) -> torch.Tensor:
    """Population variance, as `jnp.var`."""
    orig = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, correction=0)
    y = (x - mu) * torch.rsqrt(var + eps)
    y = y * p["scale"].to(x.dtype) + p["bias"].to(x.dtype)
    return y.to(orig)


# ------------------------------------------------------------------------ conv
def conv2d_init(gen: torch.Generator, in_ch: int, out_ch: int,
                kernel: int) -> dict:
    return {"kernel": lecun_normal(gen, (kernel, kernel, in_ch, out_ch)),
            "bias": torch.zeros(out_ch)}


def conv2d(p: dict, x: torch.Tensor, *, padding: str = "SAME") -> torch.Tensor:
    """Stride-1 conv, x NHWC, kernel HWIO -> NHWC. "SAME" pads like JAX
    (extra row/column at the high end for even kernels)."""
    if padding not in ("SAME", "VALID"):
        raise ValueError(f"unknown padding {padding!r}")
    y = F.conv2d(x.permute(0, 3, 1, 2), p["kernel"].permute(3, 2, 0, 1),
                 padding="same" if padding == "SAME" else "valid")
    return y.permute(0, 2, 3, 1) + p["bias"]


def max_pool(x: torch.Tensor, window: int = 2, stride: int = 2) -> torch.Tensor:
    """VALID max pool over NHWC."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride)
    return y.permute(0, 2, 3, 1)


# ------------------------------------------------------------------------ lstm
def lstm_cell_init(gen: torch.Generator, in_dim: int, hidden: int) -> dict:
    return {"wi": lecun_normal(gen, (in_dim, 4 * hidden)),
            "wh": lecun_normal(gen, (hidden, 4 * hidden)),
            "bias": torch.zeros(4 * hidden)}


def lstm_cell(p: dict, carry, x: torch.Tensor):
    h, c = carry
    gates = torch.matmul(x, p["wi"]) + torch.matmul(h, p["wh"]) + p["bias"]
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return (h, c), h


def lstm_layer(p: dict, xs: torch.Tensor) -> torch.Tensor:
    """xs [B, T, D] -> hs [B, T, H], one cell step per time step."""
    B, H = xs.shape[0], p["wh"].shape[0]
    carry = (xs.new_zeros((B, H)), xs.new_zeros((B, H)))
    hs = []
    for t in range(xs.shape[1]):
        carry, h = lstm_cell(p, carry, xs[:, t])
        hs.append(h)
    return torch.stack(hs, dim=1)


# ------------------------------------------------------------------ activation
def gelu(x: torch.Tensor) -> torch.Tensor:
    """tanh approximation, as `jax.nn.gelu(approximate=True)`."""
    return F.gelu(x, approximate="tanh")


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) with no linear cut-off (`jax.nn.softplus`;
    `F.softplus` returns x above its threshold)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))



# ------------------------------------------------------------------- utilities
def _tensors(params):
    if isinstance(params, dict):
        for key in sorted(params):
            yield from _tensors(params[key])
    else:
        yield params


def count_params(params) -> int:
    return sum(t.numel() for t in _tensors(params))


def param_bytes(params) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(params))


@dataclasses.dataclass(frozen=True)
class DTypePolicy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def small() -> "DTypePolicy":
        return DTypePolicy(torch.float32, torch.float32)

    @staticmethod
    def large() -> "DTypePolicy":
        return DTypePolicy(torch.float32, torch.bfloat16)
