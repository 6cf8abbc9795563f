"""Key convergence factor φ(k, δ) and the joint solver (paper Eq. 14/15).

    φ(k, δ) = ((k·α + δ·β)² · (2 − δ) + T̃²) / (T̃² · k · √δ)

k ∈ [k_min, k_max] (integer local updating frequency), δ ∈ [δ_min, δ_max]
(top-k density). The paper solves this "heuristic optimization problem" per
device; we provide an exact-enough solver: dense log-grid over δ × integer
range over k, followed by golden-section refinement in δ for the best k.
The solver is numpy (runs on the controller host, tiny).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np


def phi(k, delta, alpha, beta, round_period):
    """Key convergence factor, vectorized over k/delta (numpy)."""
    k = np.asarray(k, dtype=np.float64)
    d = np.asarray(delta, dtype=np.float64)
    T = float(round_period)
    num = (k * alpha + d * beta) ** 2 * (2.0 - d) + T * T
    return num / (T * T * k * np.sqrt(d))


def staleness(k, delta, alpha, beta, round_period):
    """τ = ceil(d_i / T̃)  with  d_i = k·α + δ·β  (paper Sec 2.2)."""
    return np.ceil((np.asarray(k) * alpha + np.asarray(delta) * beta)
                   / float(round_period))


@dataclasses.dataclass(frozen=True)
class Plan:
    """Per-device decision (k_i, δ_i) + diagnostics."""
    k: int
    delta: float
    phi: float
    round_time: float     # d_i = kα + δβ seconds
    staleness: int        # ⌈d_i/T̃⌉


def solve_plan(alpha: float, beta: float, round_period: float,
               k_bounds: tuple[int, int] = (1, 200),
               delta_bounds: tuple[float, float] = (1e-4, 1.0),
               grid: int = 200) -> Plan:
    """Minimize φ over the box (Eq. 15). Exhaustive over k (integer),
    log-grid + golden-section over δ. Cost: O(k_range · grid) ~ 40k evals."""
    k_min, k_max = int(k_bounds[0]), int(k_bounds[1])
    d_min, d_max = float(delta_bounds[0]), float(delta_bounds[1])
    if not (0 < d_min <= d_max <= 1.0):
        raise ValueError(f"bad delta bounds {delta_bounds}")
    if not (1 <= k_min <= k_max):
        raise ValueError(f"bad k bounds {k_bounds}")

    ks = np.arange(k_min, k_max + 1)
    ds = np.geomspace(d_min, d_max, grid)
    K, D = np.meshgrid(ks, ds, indexing="ij")
    vals = phi(K, D, alpha, beta, round_period)
    i, j = np.unravel_index(np.argmin(vals), vals.shape)
    k_star = int(ks[i])

    # golden-section refine δ for k_star (φ is unimodal in δ on [d_min,d_max]
    # for fixed k in the regimes of interest; fall back to grid value if not)
    lo = ds[max(0, j - 1)]
    hi = ds[min(len(ds) - 1, j + 1)]
    gr = (math.sqrt(5) - 1) / 2
    a, b = lo, hi
    c, d_ = b - gr * (b - a), a + gr * (b - a)
    for _ in range(60):
        if phi(k_star, c, alpha, beta, round_period) < \
           phi(k_star, d_, alpha, beta, round_period):
            b = d_
        else:
            a = c
        c, d_ = b - gr * (b - a), a + gr * (b - a)
    d_star = float(np.clip(0.5 * (a + b), d_min, d_max))
    if phi(k_star, d_star, alpha, beta, round_period) > vals[i, j]:
        d_star = float(ds[j])

    p = float(phi(k_star, d_star, alpha, beta, round_period))
    rt = k_star * alpha + d_star * beta
    return Plan(k=k_star, delta=d_star, phi=p, round_time=rt,
                staleness=int(math.ceil(rt / round_period)))


def solve_plan_fixed_delta(alpha: float, beta: float, round_period: float,
                           delta: float,
                           k_bounds: tuple[int, int] = (1, 200)) -> Plan:
    """Baseline 'Opt. LF' (Tab. 2): δ fixed, optimize k only."""
    ks = np.arange(k_bounds[0], k_bounds[1] + 1)
    vals = phi(ks, delta, alpha, beta, round_period)
    i = int(np.argmin(vals))
    k = int(ks[i])
    rt = k * alpha + delta * beta
    return Plan(k, float(delta), float(vals[i]), rt,
                int(math.ceil(rt / round_period)))


def solve_plan_fixed_k(alpha: float, beta: float, round_period: float,
                       k: int,
                       delta_bounds: tuple[float, float] = (1e-4, 1.0),
                       grid: int = 400) -> Plan:
    """Baseline 'Opt. CR' (Tab. 2): k fixed, optimize δ only."""
    ds = np.geomspace(delta_bounds[0], delta_bounds[1], grid)
    vals = phi(k, ds, alpha, beta, round_period)
    j = int(np.argmin(vals))
    d = float(ds[j])
    rt = k * alpha + d * beta
    return Plan(int(k), d, float(vals[j]), rt,
                int(math.ceil(rt / round_period)))
