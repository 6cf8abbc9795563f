"""The paper's FMNIST CNN (arXiv:2407.05125 Sec 4.1), plain PyTorch:
conv 5x5 → ReLU → 2x2 max pool → conv 5x5 → ReLU → 2x2 max pool →
dense → ReLU → dense, on NHWC images with HWIO kernels, "same" padding.

Parameters are one flat float32 vector whose leaves follow sorted keys at
every level (conv1/bias, conv1/kernel, conv2/..., fc1/..., fc2/...); the
flatten of the last pooled map is in NHWC order, which is what gives fc1's
rows their meaning.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def spec(cfg: dict) -> list:
    """[(path, shape)] in flat order."""
    k, c = cfg["kernel"], cfg["image_shape"][2]
    c1, c2, h = cfg["conv1_channels"], cfg["conv2_channels"], cfg["hidden"]
    side = cfg["image_shape"][0] // 4
    leaves = {
        ("conv1", "bias"): (c1,), ("conv1", "kernel"): (k, k, c, c1),
        ("conv2", "bias"): (c2,), ("conv2", "kernel"): (k, k, c1, c2),
        ("fc1", "bias"): (h,), ("fc1", "kernel"): (side * side * c2, h),
        ("fc2", "bias"): (cfg["classes"],),
        ("fc2", "kernel"): (h, cfg["classes"]),
    }
    return sorted(leaves.items())


def dim(cfg: dict) -> int:
    return sum(math.prod(s) for _, s in spec(cfg))


def unflatten(flat: torch.Tensor, sp) -> dict:
    out, pos = {}, 0
    for path, shape in sp:
        n = math.prod(shape)
        out[path] = flat[pos:pos + n].view(shape)
        pos += n
    return out


def forward(p: dict, x: torch.Tensor, prec) -> torch.Tensor:
    """Logits [B, classes] of images x [B, H, W, C]."""
    r = prec.r
    h = x.permute(0, 3, 1, 2)
    for name in ("conv1", "conv2"):
        w = p[(name, "kernel")].permute(3, 2, 0, 1)
        h = F.conv2d(r(h), r(w), padding="same") \
            + p[(name, "bias")][None, :, None, None]
        h = F.max_pool2d(torch.relu(h), 2, 2)
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    h = torch.relu(r(h) @ r(p[("fc1", "kernel")]) + p[("fc1", "bias")])
    return r(h) @ r(p[("fc2", "kernel")]) + p[("fc2", "bias")]


def loss(flat: torch.Tensor, sp, cfg: dict, x, y, prec) -> torch.Tensor:
    """Mean softmax cross-entropy."""
    return F.cross_entropy(forward(unflatten(flat, sp), x, prec), y)


def forward_flops(cfg: dict) -> int:
    """2 x multiply-adds of one image's forward ("same" 5x5
    convolutions, 2x2 pools, two dense layers)."""
    H, W, C = cfg["image_shape"]
    k, c1, c2 = cfg["kernel"], cfg["conv1_channels"], cfg["conv2_channels"]
    conv1 = H * W * c1 * k * k * C
    conv2 = (H // 2) * (W // 2) * c2 * k * k * c1
    fc1 = (H // 4) * (W // 4) * c2 * cfg["hidden"]
    fc2 = cfg["hidden"] * cfg["classes"]
    return 2 * (conv1 + conv2 + fc1 + fc2)

