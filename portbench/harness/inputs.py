"""Inputs made from `--seed`: the seeds of each stream, the data (by the
generator the configuration names, a module of `portbench.data`) and the
weights. The program and the reference get the same inputs from these
functions; neither makes its own.
"""
from __future__ import annotations

import importlib
import math

import numpy as np


def seeds(seed: int) -> dict:
    """Independent 30-bit seeds for each stream of a run, from any whole
    number (the numpy and simulator seeds need 32 bits or fewer)."""
    w = np.random.SeedSequence(int(seed) % 2 ** 63).generate_state(6)
    names = ("sim", "task", "train", "test", "weights", "tokens")
    return {k: int(v) % 2 ** 30 for k, v in zip(names, w)}


def generator(data: dict):
    """The module `portbench.data.<data["generator"]>`."""
    return importlib.import_module(f"portbench.data.{data['generator']}")


def _fan_in(path, shape) -> int:
    if len(shape) == 4:                     # HWIO conv kernel
        return shape[0] * shape[1] * shape[2]
    if path[-1] == "conv_w":                # depthwise [L, W, C]
        return shape[-2]
    return shape[-2] if len(shape) >= 2 else 1


def weights(spec, seed: int, device, init: dict):
    """One flat f32 buffer [d] on `device` for the leaves of `spec`
    [(path, shape)], drawn in one call from a generator on the device:
    normal with std 1/sqrt(fan_in) (clipped at 2 std), and the leaves
    `init` names (by the last key of their path) set as it says:
    "zeros", "ones", "a_log" (log of U[1, 16], Mamba-2's A), "dt_bias"
    (inverse softplus of log-uniform dt in [1e-3, 1e-1]),
    "embedding" (std 1/sqrt(width))."""
    import torch
    n = sum(math.prod(s) for _, s in spec)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.empty(n, dtype=torch.float32, device=device)
    flat.normal_(generator=gen).clamp_(-2.0, 2.0)
    pos = 0
    for path, shape in spec:
        k = math.prod(shape)
        leaf = flat[pos:pos + k].view(shape)
        rule = init.get(path[-1], "lecun")
        if rule == "zeros":
            leaf.zero_()
        elif rule == "ones":
            leaf.fill_(1.0)
        elif rule == "a_log":
            leaf.uniform_(1.0, 16.0, generator=gen).log_()
        elif rule == "dt_bias":
            dt = torch.empty(shape, device=device).uniform_(
                math.log(1e-3), math.log(1e-1), generator=gen).exp_()
            leaf.copy_(dt + torch.log(-torch.expm1(-dt)))
        elif rule == "embedding":
            leaf.mul_(1.0 / math.sqrt(shape[-1]))
        else:
            leaf.mul_(1.0 / math.sqrt(_fan_in(path, shape)))
        pos += k
    return flat
