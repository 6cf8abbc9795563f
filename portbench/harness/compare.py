"""The numbers `correct` is decided on, and their limits.

A training cell is compared leaf by leaf, each leaf held against the
reference's, taken by the worst leaf, in one of two forms:

  error of a leaf  ‖program's leaf − reference's leaf‖
                   / max(‖reference's leaf‖, median leaf's ‖reference‖)

where both sides are computed from the same inputs and nothing
discontinuous lies between them (gradients at the same parameters and
batch, an update of the same state, a selection of the same
accumulator), so a leaf laid out, permuted or taken from another row
shows; and

  gap of a leaf    | ‖program's leaf‖ − ‖reference's leaf‖ | / (the same)

where a threshold selection lies between inputs that differ by rounding,
so that a coordinate at the threshold can go either way on either side
and moves a leaf's norm by about the threshold only.

Leaves whose reference norm is under a thousandth of the median leaf's
are nought to rounding and are left out, by that rule and not by name.
"""
from __future__ import annotations

import math

import numpy as np

BLOCK = 1 << 26         # elements moved between devices at a time


def leaf_norms(flat, spec) -> np.ndarray:
    """The L2 norm of each leaf of a flat vector (torch or numpy), in
    float64."""
    import torch
    t = torch.as_tensor(flat)
    out, pos = [], 0
    for _, shape in spec:
        n = math.prod(shape)
        out.append(float(torch.linalg.vector_norm(
            t[pos:pos + n].to(torch.float64))))
        pos += n
    return np.asarray(out)


def leaf_diff_norms(a, b, spec) -> np.ndarray:
    """‖a − b‖ of each leaf, in float64; `b` may live on another device
    (the host) and is brought to `a`'s in blocks."""
    import torch
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    out, pos = [], 0
    for _, shape in spec:
        n, sq = math.prod(shape), 0.0
        for s in range(pos, pos + n, BLOCK):
            e = min(s + BLOCK, pos + n)
            d = a[s:e].to(torch.float64) - b[s:e].to(a.device, torch.float64)
            sq += float(torch.dot(d, d))
        out.append(math.sqrt(sq))
        pos += n
    return np.asarray(out)


def counted(ref: np.ndarray) -> np.ndarray:
    """Mask of the leaves that count: reference norm at least a
    thousandth of the median leaf's."""
    return ref >= 1e-3 * np.median(ref)


def worst_leaf_error(diff: np.ndarray, ref: np.ndarray, mask=None) -> float:
    """The worst counted leaf's `diff` (a norm of a difference, or a
    difference of norms) over its scale; where the reference is zero, 0
    if the difference is zero too and inf if it is not."""
    mask = counted(ref) if mask is None else mask
    if not mask.any():
        return math.inf
    scale = np.maximum(ref, np.median(ref[mask]))[mask]
    diff = np.asarray(diff)[mask]
    with np.errstate(divide="ignore", invalid="ignore"):
        gaps = np.where(diff == 0, 0.0, diff / scale)
    return float(np.max(gaps))


def worst_leaf_gap(prog: np.ndarray, ref: np.ndarray, mask=None) -> float:
    """The worst counted leaf's gap of norms."""
    return worst_leaf_error(np.abs(prog - ref), ref, mask)


def rel_gap(prog: float, ref: float) -> float:
    return abs(prog - ref) / abs(ref) if ref else math.inf


def judge(readings: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) for every limit the cell has;
    a reading that is missing or not a number fails."""
    out, ok = {}, True
    for name, lim in limits["limits"].items():
        v = readings.get(name, math.nan)
        good = isinstance(v, (int, float)) and math.isfinite(v) and v <= lim
        ok &= good
        out[name] = {"value": v, "limit": lim}
    return ok, out
