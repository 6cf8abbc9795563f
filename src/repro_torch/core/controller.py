"""FedLuck controller: profiles devices, solves Eq. 15, re-plans elastically.

Implements Alg. 1 lines 1–5 / 15–18: devices measure α_i (avg seconds per
local step) and β_i (seconds to ship a *full* gradient); the controller
minimizes the key convergence factor φ per device. It also owns the
*elastic* path: when membership changes (join/leave/failure) or measured
α/β drift beyond `replan_tolerance`, plans are recomputed — the datacenter
launcher and the AFL simulator both call into this.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np

from repro_torch.core.factor import Plan, solve_plan, solve_plan_fixed_delta, \
    solve_plan_fixed_k


@dataclasses.dataclass
class DeviceProfile:
    """Measured/derived capabilities of one device (or pod)."""
    device_id: int
    alpha: float            # seconds per local step
    beta: float             # seconds to transmit one FULL gradient (δ=1)
    bandwidth_bps: float = 0.0   # informational

    @staticmethod
    def from_bandwidth(device_id: int, alpha: float, model_bits: float,
                       bandwidth_bps: float) -> "DeviceProfile":
        return DeviceProfile(device_id, alpha, model_bits / bandwidth_bps,
                             bandwidth_bps)


def profile_alpha(step_fn: Callable[[], None], warmup: int = 2,
                  iters: int = 5, device: str = "cuda") -> float:
    """Measure seconds per local step by running the real step. On a CUDA
    device (the default, as for every entry point of the port) the step
    only enqueues work, so the clock reads are bracketed by
    `torch.cuda.synchronize()`; pass device="cpu" for a step on the CPU."""
    sync = _cuda_sync if str(device).startswith("cuda") else (lambda: None)
    for _ in range(warmup):
        step_fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        step_fn()
    sync()
    return (time.perf_counter() - t0) / iters


def _cuda_sync() -> None:
    import torch
    torch.cuda.synchronize()


def derive_alpha_from_roofline(flops_per_step: float, hbm_bytes: float,
                               peak_flops: float, hbm_bw: float) -> float:
    """Dry-run path: α from the compiled roofline (max of the two terms)."""
    return max(flops_per_step / peak_flops, hbm_bytes / hbm_bw)


@dataclasses.dataclass
class FedLuckController:
    round_period: float                     # T̃ seconds
    k_bounds: tuple[int, int] = (1, 60)
    delta_bounds: tuple[float, float] = (1e-3, 1.0)
    mode: str = "joint"                     # joint | fixed_delta | fixed_k
    fixed_delta: float = 0.01               # for 'Opt. LF' baseline
    fixed_k: int = 10                       # for 'Opt. CR' baseline
    replan_tolerance: float = 0.25          # re-plan if α/β drift > 25%

    def __post_init__(self):
        self._profiles: dict[int, DeviceProfile] = {}
        self._plans: dict[int, Plan] = {}
        self.replans = 0   # drift-triggered re-solves (not first registration)

    # ------------------------------------------------------------- membership
    def register(self, profile: DeviceProfile) -> Plan:
        self._profiles[profile.device_id] = profile
        plan = self._solve(profile)
        self._plans[profile.device_id] = plan
        return plan

    def deregister(self, device_id: int) -> None:
        """Device failure / scale-down: drop it; remaining plans are
        per-device so they stay valid (φ couples devices only through T̃)."""
        self._profiles.pop(device_id, None)
        self._plans.pop(device_id, None)

    def update_profile(self, profile: DeviceProfile) -> Plan:
        """Drift-aware re-plan (straggler turning slower, link congestion)."""
        old = self._profiles.get(profile.device_id)
        self._profiles[profile.device_id] = profile
        if old is not None:
            drift = max(abs(profile.alpha - old.alpha) / max(old.alpha, 1e-12),
                        abs(profile.beta - old.beta) / max(old.beta, 1e-12))
            if drift <= self.replan_tolerance and profile.device_id in self._plans:
                return self._plans[profile.device_id]
        if old is not None:
            self.replans += 1
        plan = self._solve(profile)
        self._plans[profile.device_id] = plan
        return plan

    # ------------------------------------------------------------------ solve
    def _solve(self, p: DeviceProfile) -> Plan:
        if self.mode == "joint":
            return solve_plan(p.alpha, p.beta, self.round_period,
                              self.k_bounds, self.delta_bounds)
        if self.mode == "fixed_delta":   # optimize LF only (Opt. LF)
            return solve_plan_fixed_delta(p.alpha, p.beta, self.round_period,
                                          self.fixed_delta, self.k_bounds)
        if self.mode == "fixed_k":       # optimize CR only (Opt. CR)
            return solve_plan_fixed_k(p.alpha, p.beta, self.round_period,
                                      self.fixed_k, self.delta_bounds)
        raise ValueError(f"unknown mode {self.mode}")

    def plan(self, device_id: int) -> Plan:
        return self._plans[device_id]

    def plans(self) -> dict[int, Plan]:
        return dict(self._plans)

    # ------------------------------------------------------------ diagnostics
    def max_staleness(self) -> int:
        return max((p.staleness for p in self._plans.values()), default=0)

    def summary(self) -> str:
        rows = [f"  dev {i}: k={p.k:3d} δ={p.delta:.4f} φ={p.phi:.3f} "
                f"τ={p.staleness}" for i, p in sorted(self._plans.items())]
        return "\n".join(rows)
