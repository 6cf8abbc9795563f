"""Minimal functional NN substrate (PyTorch port of `repro.models.nn`).

Every layer is a pair of plain functions over a dict of tensors:
  *_init(gen, ...) -> params    (torch.Generator-seeded)
  layer(params, x) -> y

Layouts follow the reference at every public function, so the flat
parameter vector means the same coordinates in both packages: conv
kernels are HWIO and activations NHWC. They are permuted to OIHW / NCHW
only around `F.conv2d` / `F.max_pool2d`. LSTM gates come in i, f, g, o
order with +1.0 on the forget gate.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------- initializers
def lecun_normal(gen: torch.Generator, shape) -> torch.Tensor:
    """Truncated normal in [-2, 2] scaled by 1/sqrt(fan_in) (HWIO convs:
    fan_in = H·W·I)."""
    fan_in = shape[0] if len(shape) >= 1 else 1
    if len(shape) == 4:
        fan_in = shape[0] * shape[1] * shape[2]
    t = torch.empty(shape, dtype=torch.float32)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t * (1.0 / math.sqrt(max(1, fan_in)))


# ---------------------------------------------------------------------- linear
def linear_init(gen: torch.Generator, in_dim: int, out_dim: int) -> dict:
    return {"kernel": lecun_normal(gen, (in_dim, out_dim)),
            "bias": torch.zeros(out_dim)}


def linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = torch.matmul(x, p["kernel"])
    if "bias" in p:
        y = y + p["bias"]
    return y


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
