"""Optimizers with the reference's (init, update) protocol (PyTorch port of
`repro.optim.optim`).

`params` is a flat tensor (the port's flat fp32 parameter buffer) or a
nested dict of tensors. The optimizer state keeps every per-coordinate
buffer (`mu`, `m`, `v`) as ONE flat fp32 tensor in the params' flat order
(keys sorted at every level, as `core.compression.flatten_pytree`), and
`step` as a host int, so a schedule yields a Python float lr and no step
waits on the device.

`update(grads, state, params)` works IN PLACE: it writes the new values
into the params' tensors and the state's buffers and returns
(params, new_state) with the same tensors, so the model's parameter views
stay valid and a step allocates no parameter-sized tensor. On the flat
buffer, `momentum_sgd` without weight decay or Nesterov is one
`fused_momentum` launch per step.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.kernels.fused_momentum import fused_momentum

Schedule = Callable[[int], float]


def constant_schedule(lr: float) -> Schedule:
    return lambda step: float(lr)


def cosine_schedule(lr: float, total_steps: int,
                    final_frac: float = 0.1) -> Schedule:
    def f(step):
        t = min(float(step) / max(1, total_steps), 1.0)
        cos = 0.5 * (1 + math.cos(math.pi * t))
        return lr * (final_frac + (1 - final_frac) * cos)
    return f


def warmup_cosine(lr: float, warmup: int, total_steps: int,
                  final_frac: float = 0.1) -> Schedule:
    cos = cosine_schedule(lr, max(1, total_steps - warmup), final_frac)

    def f(step):
        if step < warmup:
            return lr * float(step) / max(1, warmup)
        return cos(step - warmup)
    return f


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """(init, update) pair. update returns (params, new_state), in place."""
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple[Any, Any]]  # (grads, state, params)
    name: str = "opt"


def _leaves(tree) -> list:
    """The tensors of a flat tensor or nested dict, in flatten order; a
    DTensor contributes its local shard (a view), so the state mirrors
    the rank's local layout."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in _leaves(tree[key])]
    return [tree.to_local() if hasattr(tree, "to_local") else tree]


def _flat_zeros(params) -> torch.Tensor:
    leaves = _leaves(params)
    return torch.zeros(sum(p.numel() for p in leaves), dtype=torch.float32,
                       device=leaves[0].device)


def _slices(params, grads, *bufs):
    """(param, grad, buffer slices...) per leaf; each param and buffer
    slice is a flat view that writes through to its tensor."""
    pos = 0
    for p, g in zip(_leaves(params), _leaves(grads)):
        n = p.numel()
        yield (p.detach().view(-1), g.reshape(-1),
               *(b[pos:pos + n] for b in bufs))
        pos += n


def _sched(lr) -> Schedule:
    return lr if callable(lr) else constant_schedule(lr)


def sgd(lr: float | Schedule) -> Optimizer:
    sched = _sched(lr)

    def init(params):
        return {"step": 0}

    def update(grads, state, params):
        eta = sched(state["step"])
        with torch.no_grad():
            for p, g in _slices(params, grads):
                p.copy_(p.to(torch.float32) - eta * g.to(torch.float32))
        return params, {"step": state["step"] + 1}

    return Optimizer(init, update, "sgd")


def momentum_sgd(lr: float | Schedule, momentum: float = 0.9,
                 weight_decay: float = 0.0, nesterov: bool = False
                 ) -> Optimizer:
    """Paper's optimizer: momentum-SGD, momentum 0.9 (Sec 4.3)."""
    sched = _sched(lr)

    def init(params):
        return {"step": 0, "mu": _flat_zeros(params)}

    def update(grads, state, params):
        eta = sched(state["step"])
        mu = state["mu"]
        with torch.no_grad():
            for p, g, m in _slices(params, grads, mu):
                if not weight_decay and not nesterov:
                    fused_momentum(p, m, g, lr=eta, momentum=momentum)
                    continue
                g32 = g.to(torch.float32)
                if weight_decay:
                    g32 = g32 + weight_decay * p.to(torch.float32)
                m.copy_(momentum * m + g32)
                step_dir = (g32 + momentum * m) if nesterov else m
                p.copy_(p.to(torch.float32) - eta * step_dir)
        return params, {"step": state["step"] + 1, "mu": mu}

    return Optimizer(init, update, "momentum_sgd")


def adamw(lr: float | Schedule, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    sched = _sched(lr)

    def init(params):
        return {"step": 0, "m": _flat_zeros(params),
                "v": _flat_zeros(params)}

    def update(grads, state, params):
        step = state["step"] + 1
        eta = sched(state["step"])
        b1t = 1 - b1 ** step
        b2t = 1 - b2 ** step
        with torch.no_grad():
            for p, g, m, v in _slices(params, grads, state["m"], state["v"]):
                g32 = g.to(torch.float32)
                m.copy_(b1 * m + (1 - b1) * g32)
                v.copy_(b2 * v + (1 - b2) * torch.square(g32))
                delta = (m / b1t) / (torch.sqrt(v / b2t) + eps)
                if weight_decay:
                    delta = delta + weight_decay * p.to(torch.float32)
                p.copy_(p.to(torch.float32) - eta * delta)
        return params, {"step": step, "m": state["m"], "v": state["v"]}

    return Optimizer(init, update, "adamw")


def apply_updates(params, updates, scale: float = 1.0):
    """params + scale * updates as new tensors, in each param's dtype
    (the PS-side global update, Eq. 6)."""
    if isinstance(params, dict):
        return {k: apply_updates(params[k], updates[k], scale)
                for k in params}
    return (params.to(torch.float32)
            + scale * updates.to(torch.float32)).to(params.dtype)
