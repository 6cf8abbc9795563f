"""Gradient compressors (paper Sec 2.2: top-k sparsification, rate δ = k/d).

PyTorch port of `repro.core.compression`. Compressors are functions over
*flat* fp32 tensors plus pytree adapters for nested dicts of parameters.
Each returns a `Compressed` carrying enough to (a) exactly reconstruct the
dense update and (b) account wire bits the way the paper does
(tx time ∝ δ·β → bits = nnz·(value+index)). Wire bits are Python floats,
rounded through float32 exactly as the reference's f32 scalars are, so
they never cost a device synchronisation.

Error feedback is a wrapper usable with any compressor; `topk_threshold`
runs its fused path (`magnitude_hist` ×2 + `ef_topk`) on the residual
directly.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.kernels import ops


class Compressed(NamedTuple):
    """Sparse/quantized payload. `dense()` is exact reconstruction."""
    values: torch.Tensor          # [k] or [d] (quantizers)
    indices: torch.Tensor | None  # [k] int32 or None (dense codes)
    dim: int                      # original flat dim d
    wire_bits: float              # bits on the wire
    meta: Any = None

    def dense(self) -> torch.Tensor:
        if self.indices is None:
            return self.values
        out = torch.zeros((self.dim,), dtype=self.values.dtype,
                          device=self.values.device)
        return out.index_add_(0, self.indices.long(), self.values)


CompressFn = Callable[[torch.Tensor], Compressed]


def _f32(x) -> float:
    """A wire-bit count rounded like the reference's f32 scalar."""
    return float(np.float32(x))


# ---------------------------------------------------------------------- utils
def _leaves(tree, prefix=()):
    """(path, leaf) pairs in JAX dict-flatten order: keys sorted at every
    level."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], prefix + (key,))
    else:
        yield prefix, tree


def flatten_pytree(tree, device=None) -> tuple[torch.Tensor, list]:
    """Flat fp32 vector of a nested dict of arrays/tensors, plus its spec
    [(path, shape)], in the order `repro`'s flatten uses."""
    flat, spec = [], []
    for path, leaf in _leaves(tree):
        t = leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(
            np.array(leaf, dtype=np.float32))
        spec.append((path, tuple(t.shape)))
        flat.append(t.reshape(-1).to(torch.float32))
    if not flat:
        return torch.zeros((0,), dtype=torch.float32, device=device), spec
    out = torch.cat([f.to(device) if device is not None else f
                     for f in flat])
    return out, spec


def unflatten_pytree(flat: torch.Tensor, spec) -> dict:
    """Nested dict of *views* of `flat` (no copies): writing the flat
    buffer changes every leaf, and gradients of a leaf-tensor `flat` come
    back flat."""
    tree: dict = {}
    pos = 0
    for path, shape in spec:
        n = int(np.prod(shape)) if shape else 1
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = flat[pos:pos + n].view(shape)
        pos += n
    return tree


def num_keep(dim: int, rate: float) -> int:
    """δ = k/d (paper's definition); always keep at least 1."""
    return max(1, min(dim, int(round(rate * dim))))


# -------------------------------------------------------------- wire payload
HEADER_BITS = 32   # i32 kept-count header of the compact wire format

# Compressors whose payload ships as the compact (values, indices, count)
# wire format rather than a dense code.
SPARSE_WIRE = ("topk", "topk_threshold", "randk")


def sparse_wire(name: str, dim: int, rate: float) -> bool:
    """True when `name`'s payload ships compact: explicit (values, indices)
    plus a kept-count header. A δ = 1 top-k ships dense — its index vector
    would be a d-length iota and the payload IS the vector."""
    return name in SPARSE_WIRE and num_keep(dim, rate) < dim


def payload_bits(cc: Compressed) -> float:
    """Bits of `cc` as actually shipped: the compressor's strict value/index
    bits plus the kept-count header compact payloads carry."""
    return cc.wire_bits + (HEADER_BITS if cc.indices is not None else 0)


# ----------------------------------------------------------------- compressors
def topk(g: torch.Tensor, rate: float) -> Compressed:
    """Paper's compressor C_δ: keep the δ·d largest-|g| coordinates (ties
    by lower index, as `jax.lax.top_k`)."""
    d = g.shape[0]
    k = num_keep(d, rate)
    idx = ops.topk_indices(g.abs(), k)
    return Compressed(g[idx], idx.to(torch.int32), d, _f32(k * (32 + 32)))


def topk_capped(g: torch.Tensor, k: int, *, k_cap: int) -> Compressed:
    """Top-k with a per-call k bounded by `k_cap`: the payload always has
    `k_cap` slots, entries beyond k zero-valued, so `dense()` rebuilds the
    exact top-k selection (bitwise equal to `topk(g, k/d)`)."""
    d = g.shape[0]
    idx = ops.topk_indices(g.abs(), k_cap)
    keep = torch.arange(k_cap, device=g.device) < k
    vals = torch.where(keep, g[idx], torch.zeros((), dtype=g.dtype,
                                                 device=g.device))
    return Compressed(vals, idx.to(torch.int32), d,
                      _f32(float(np.float32(k)) * (32.0 + 32.0)))


def randk(g: torch.Tensor, rate: float,
          key: torch.Generator | None) -> Compressed:
    d = g.shape[0]
    k = num_keep(d, rate)
    idx = torch.randperm(d, generator=key, device=g.device)[:k]
    scale = d / k  # unbiased
    return Compressed(g[idx] * scale, idx.to(torch.int32), d, _f32(k * 64))


def qsgd(g: torch.Tensor, levels: int = 256) -> Compressed:
    """QSGD quantization (dense code, log2(levels)+sign bits/coord)."""
    d = g.shape[0]
    norm = torch.linalg.vector_norm(g) + 1e-12
    scaled = g.abs() / norm * (levels - 1)
    lower = torch.floor(scaled)
    # deterministic rounding variant, as in the reference
    q = torch.where(scaled - lower > 0.5, lower + 1, lower)
    vals = torch.sign(g) * q * norm / (levels - 1)
    bits_per = np.log2(levels) + 1
    return Compressed(vals, None, d, _f32(d * bits_per + 32))


def signsgd(g: torch.Tensor) -> Compressed:
    scale = g.abs().mean()
    return Compressed(torch.sign(g) * scale, None, g.shape[0],
                      _f32(g.shape[0] * 1 + 32))


def terngrad(g: torch.Tensor, key: torch.Generator | None) -> Compressed:
    s = g.abs().max() + 1e-12
    p = g.abs() / s
    b = torch.bernoulli(p, generator=key)
    return Compressed(torch.sign(g) * b * s, None, g.shape[0],
                      _f32(g.shape[0] * np.log2(3) + 32))


def identity(g: torch.Tensor) -> Compressed:
    return Compressed(g, None, g.shape[0], _f32(g.shape[0] * 32))


# ------------------------------------------------------------ threshold top-k
def topk_threshold_ef(g: torch.Tensor, residual: torch.Tensor, rate: float,
                      *, coarse_buckets: int = 48, fine_buckets: int = 128,
                      exact_k: bool | None = None
                      ) -> tuple[Compressed, torch.Tensor]:
    """Error-feedback threshold top-k on the kernels: `ops.topk_compress`
    (two `magnitude_hist` launches over acc = g + residual, then one
    `ef_topk` launch). When more than k coordinates reach the threshold
    (ties within a fine bucket) the reference's count-based exact-k
    correction keeps the k largest selected magnitudes (ties by lower
    index) and the residual is recomputed as acc − out. Returns
    (dense masked payload, new residual)."""
    d = g.shape[0]
    k = num_keep(d, rate)
    out, new_res, nnz, t = ops.topk_compress(
        g, residual, rate=rate, coarse_buckets=coarse_buckets,
        fine_buckets=fine_buckets)
    if exact_k is None:
        exact_k = d < 2 ** 31
    if exact_k and int(nnz) > k:     # one host read of the count
        acc = g.to(torch.float32) + residual.to(torch.float32)
        mag = acc.abs()
        key = torch.where(mag >= t, mag,
                          torch.full((), -torch.inf, device=acc.device))
        mask = torch.zeros(d, dtype=torch.bool, device=acc.device)
        mask[ops.topk_indices(key, k)] = True
        out = torch.where(mask, acc, torch.zeros((), device=acc.device))
        new_res = acc - out
        out, new_res = out.to(g.dtype), new_res.to(residual.dtype)
    return (Compressed(out, None, d, _f32(k * 64), meta={"threshold": t}),
            new_res)


def topk_threshold(g: torch.Tensor, rate: float, *, coarse_buckets: int = 48,
                   fine_buckets: int = 128,
                   exact_k: bool | None = None) -> Compressed:
    """Threshold top-k without error feedback: the fused path run with a
    zero residual. Returns a *dense masked* payload (indices=None); the
    wire cost is still accounted sparse (k values + k indices)."""
    cc, _ = topk_threshold_ef(g, torch.zeros_like(g), rate,
                              coarse_buckets=coarse_buckets,
                              fine_buckets=fine_buckets, exact_k=exact_k)
    return cc


# --------------------------------------------------------------- error feedback
@dataclasses.dataclass(frozen=True)
class Compressor:
    """Named compressor with δ baked in; uniform callable interface. `key`
    is a torch.Generator for the random compressors."""
    name: str
    rate: float  # δ (1.0 for dense codes)
    fn: Callable[..., Compressed]
    needs_key: bool = False
    kwargs: tuple = ()

    def __call__(self, g: torch.Tensor,
                 key: torch.Generator | None = None) -> Compressed:
        if self.needs_key:
            # by keyword: `randk`'s fn is partial(randk, rate=...), whose
            # second positional parameter is the rate
            return self.fn(g, key=key)
        return self.fn(g)


def make_compressor(name: str, rate: float = 1.0, **kw) -> Compressor:
    if name == "topk":
        return Compressor("topk", rate, partial(topk, rate=rate))
    if name == "topk_threshold":
        return Compressor("topk_threshold", rate,
                          partial(topk_threshold, rate=rate, **kw),
                          kwargs=tuple(sorted(kw.items())))
    if name == "randk":
        return Compressor("randk", rate, partial(randk, rate=rate),
                          needs_key=True)
    if name == "qsgd":
        return Compressor("qsgd", 1.0, partial(qsgd, **kw))
    if name == "signsgd":
        return Compressor("signsgd", 1.0, signsgd)
    if name == "terngrad":
        return Compressor("terngrad", 1.0, terngrad, needs_key=True)
    if name in ("identity", "none"):
        return Compressor("identity", 1.0, identity)
    raise ValueError(f"unknown compressor {name}")


def ef_compress(compressor: Compressor, g: torch.Tensor,
                residual: torch.Tensor, key: torch.Generator | None = None
                ) -> tuple[Compressed, torch.Tensor]:
    """Error-feedback: compress (g + residual), keep what was dropped."""
    if compressor.name == "topk_threshold":
        return topk_threshold_ef(g, residual, compressor.rate,
                                 **dict(compressor.kwargs))
    acc = g + residual
    comp = compressor(acc, key)
    new_residual = acc - comp.dense()
    return comp, new_residual
