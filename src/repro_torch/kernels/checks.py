"""Checks of the pod-sync kernels against their plain versions, for
`chip_smoke.py`.

`check_hist` builds the two edge sets of the threshold solve (49 coarse
edges, then 129 fine edges between the coarse bracket) for top-k of a
vector and holds `magnitude_hist` to exact counts on both;
`check_compact` holds `compact_blocks` to its plain version bit for bit
on all four outputs; `check_ef` holds `ef_topk` to its plain version bit
for bit on out, r' and nnz. Each calls the package's wrapper. A mismatch
raises `CheckFailed`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import compact_topk, ef_topk, magnitude_hist, ops, ref


class CheckFailed(AssertionError):
    """A kernel disagreed with its plain version."""


def vec(d: int, seed: int, device="cuda") -> torch.Tensor:
    """A heavy-tailed f32 vector of d entries (a normal times a log-normal,
    as gradient magnitudes are), made from `seed` with numpy."""
    rng = np.random.RandomState(seed)
    x = rng.randn(d).astype(np.float32) * np.exp(rng.randn(d)).astype(
        np.float32)
    return torch.from_numpy(x).to(device)


_BITS = {4: torch.int32, 2: torch.int16}


def bits_equal(a: torch.Tensor, b: torch.Tensor, *,
               any_nan: bool = False) -> bool:
    """Same shape, dtype and bit patterns (f32 or bf16; NaN payloads and
    the sign of zero included). With `any_nan`, a NaN matches a NaN
    whatever its payload and sign (two frameworks' NaNs differ there), and
    every other entry still bit for bit."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if any_nan:
        nan = torch.isnan(a)
        if not torch.equal(nan, torch.isnan(b)):
            return False
        a, b = a.masked_fill(nan, 0), b.masked_fill(nan, 0)
    bits = _BITS[a.element_size()]
    return torch.equal(a.contiguous().view(bits), b.contiguous().view(bits))


def check_hist(g: torch.Tensor, what: str, k: int | None = None):
    """The coarse (49) and fine (129) edges the threshold solve uses on g
    for top-k (k = 1% of g by default), each pass of `magnitude_hist`
    held to exact counts against the plain version; returns (coarse,
    fine, t) with t the solve's threshold."""
    acc = g.float()
    k = k or max(1, round(0.01 * acc.numel()))
    gmax = acc.abs().max() + 1e-30
    coarse = gmax * torch.exp2(-torch.arange(49, dtype=torch.float32,
                                             device=g.device))
    lo, hi = ops._solve_threshold(ref.ref_magnitude_hist(acc, coarse),
                                  coarse, k)
    frac = torch.arange(129, dtype=torch.float32, device=g.device) / 128
    fine = torch.clamp(hi - (hi - lo) * frac, min=1e-30)
    for name, e in (("coarse", coarse), ("fine", fine)):
        diff = (magnitude_hist.magnitude_hist(g, e).long()
                - ref.ref_magnitude_hist(g, e).long()).abs().max().item()
        if diff:
            raise CheckFailed(f"magnitude_hist {name} {what}: counts differ "
                              f"by {diff}")
    return coarse, fine, ops.solve_threshold(acc, k)


def check_compact(acc: torch.Tensor, t, budget: int, what: str) -> float:
    """`compact_blocks` against the plain version: all four outputs bit
    for bit (floats compared as their int32 patterns). Returns the largest
    absolute difference of the float outputs (0.0 when they agree)."""
    got = compact_topk.compact_blocks(acc, t, budget=budget)
    want = ref.ref_compact_blocks(acc, t, budget)
    err = 0.0
    for g, w, name in zip(got, want, ("vals", "idx", "cnt", "res")):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise CheckFailed(f"compact_blocks {what} {name}: {g.dtype} "
                              f"{tuple(g.shape)} vs plain {w.dtype} "
                              f"{tuple(w.shape)}")
        if g.dtype == torch.float32:
            err = max(err, (g - w).abs().max().item() if g.numel() else 0.0)
            same = bits_equal(g, w)
        else:
            same = torch.equal(g, w)
        if not same:
            raise CheckFailed(f"compact_blocks {what}: {name} differs from "
                              f"the plain version")
    return err


def check_ef(g: torch.Tensor, r: torch.Tensor, t, what: str) -> float:
    """`ef_topk` against the plain version: out, r' bit for bit in their
    dtypes (NaN payloads included), nnz equal, and where g and r are f32
    and g + r is finite, out + r' == g + r bit for bit. Returns the
    largest absolute difference of out and r' over their finite entries
    (0.0 when they agree)."""
    out, res, nnz = ef_topk.ef_topk(g, r, t)
    ro, rr, rn = ref.ref_ef_topk(g, r, torch.as_tensor(
        t, dtype=torch.float32, device=g.device))
    err = 0.0
    for a, b, name in ((out, ro, "out"), (res, rr, "residual")):
        if not bits_equal(a, b):
            raise CheckFailed(f"ef_topk {what}: {name} differs from the "
                              f"plain version")
        fin = torch.isfinite(a)
        if fin.any():
            err = max(err, (a.float() - b.float())[fin].abs().max().item())
    if nnz.dtype != torch.int32 or nnz.shape != () or int(nnz) != int(rn):
        raise CheckFailed(f"ef_topk {what}: nnz {nnz.dtype} "
                          f"{tuple(nnz.shape)} {int(nnz)} vs plain {int(rn)}")
    if g.dtype == r.dtype == torch.float32:
        acc = g + r
        if bool(torch.isfinite(acc).all()) and not bits_equal(out + res, acc):
            raise CheckFailed(f"ef_topk {what}: out + r' != g + r")
    return err
