"""FedLuck's asynchronous FL round, plain NumPy and PyTorch: device
profiles and plans (Eq. 14-15), the event schedule with periodic
aggregation, each device's data order, the model's gradient (by the
configuration's model reference), the
momentum-SGD step and the Eq. 6 update (EF compression is in
`compress.py`). Frozen copies of the planner and the loaders' draw
order; events one at a time, in time order (ties in the order they were
made).

A device i has α_i ~ U[a, spread·a] seconds per local step and
β_i = 32·d / b_i seconds per full upload, b_i ~ U[b_lo, b_hi] bit/s; its
plan (k_i, δ_i) minimises φ(k, δ) = ((kα + δβ)²(2 − δ) + T²) / (T² k √δ).
All devices start at t = 0 on the initial model. A device that starts at
t on model round m trains k_i steps from the global model, compresses
the pseudo-gradient w0 − w_k with its EF residual at δ_i and lands at
t + k_i α_i + δ_i β_i. Every T seconds the server applies
w ← w − η_g / |S| · Σ_S kept to the arrivals S since the last boundary
(in arrival order) and hands them the new model at once.
"""
from __future__ import annotations

import heapq
import math

import numpy as np
import torch


# ---------------------------------------------------------------- planner
def phi(k, delta, alpha, beta, T):
    k = np.asarray(k, dtype=np.float64)
    d = np.asarray(delta, dtype=np.float64)
    return ((k * alpha + d * beta) ** 2 * (2.0 - d) + T * T) \
        / (T * T * k * np.sqrt(d))


def solve_plan(alpha, beta, T, k_bounds, delta_bounds, grid=200):
    """(k, δ): exhaustive over integer k, a log grid over δ, then a
    golden-section refinement of δ at the best k."""
    ks = np.arange(int(k_bounds[0]), int(k_bounds[1]) + 1)
    ds = np.geomspace(float(delta_bounds[0]), float(delta_bounds[1]), grid)
    K, D = np.meshgrid(ks, ds, indexing="ij")
    vals = phi(K, D, alpha, beta, T)
    i, j = np.unravel_index(np.argmin(vals), vals.shape)
    k = int(ks[i])
    a, b = ds[max(0, j - 1)], ds[min(len(ds) - 1, j + 1)]
    gr = (math.sqrt(5) - 1) / 2
    c, e = b - gr * (b - a), a + gr * (b - a)
    for _ in range(60):
        if phi(k, c, alpha, beta, T) < phi(k, e, alpha, beta, T):
            b = e
        else:
            a = c
        c, e = b - gr * (b - a), a + gr * (b - a)
    d = float(np.clip(0.5 * (a + b), delta_bounds[0], delta_bounds[1]))
    if phi(k, d, alpha, beta, T) > vals[i, j]:
        d = float(ds[j])
    return k, d


def devices(tr: dict, dim: int, order=None) -> list:
    """[(alpha, beta, k, delta)] per device: the fleet drawn from the
    traffic's `fleet_seed`, dealt to the device ids in `order`."""
    rng = np.random.RandomState(tr["fleet_seed"])
    a = tr["base_alpha"]
    out = []
    for _ in range(tr["devices"]):
        alpha = rng.uniform(a, a * tr["alpha_spread"])
        bw = rng.uniform(*tr["bandwidth_bps"])
        beta = dim * 32 / bw
        k, d = solve_plan(alpha, beta, tr["round_period"], tr["k_bounds"],
                          tr["delta_bounds"])
        out.append((alpha, beta, k, d))
    return out if order is None else [out[j] for j in order]


# ---------------------------------------------------------------- data
def iid_shares(n: int, parts: int, seed: int) -> list:
    perm = np.random.RandomState(seed).permutation(n)
    return [np.sort(s) for s in np.array_split(perm, parts)]


class Loader:
    """Endless batches over one device's share: a fresh permutation of
    the share each time the rest cannot fill a batch."""

    def __init__(self, share, batch: int, seed: int):
        self.share, self.batch = share, min(batch, len(share))
        self.rng = np.random.RandomState(seed)
        self.order, self.pos = self.rng.permutation(share), 0

    def next(self):
        if self.pos + self.batch > len(self.order):
            self.order, self.pos = self.rng.permutation(self.share), 0
        idx = self.order[self.pos:self.pos + self.batch]
        self.pos += self.batch
        return idx


# ---------------------------------------------------------------- rounds
def local_round(model, cfg, w0, sp, xs, ys, lr, momentum, prec):
    """w0 − w_k after one momentum-SGD step per (x, y) batch."""
    w, mu = w0.clone(), torch.zeros_like(w0)
    for x, y in zip(xs, ys):
        w, mu = momentum_step(w, mu, grad(model, cfg, w, sp, x, y, prec),
                              lr, momentum)
    return w0 - w


def schedule(tr: dict, dim: int, order, n_aggs: int) -> list:
    """The first `n_aggs` aggregations that change the model:
    [(round, sorted [(device, model round it trained on)])]. The
    schedule depends on the plans and the clock alone, not on the
    values trained."""
    devs = devices(tr, dim, order)
    T = tr["round_period"]
    rnd, heap, seq, buffer, out = 0, [], 0, [], []

    def push(t, kind, payload):
        nonlocal seq
        heapq.heappush(heap, (t, seq, kind, payload))
        seq += 1

    for i in range(len(devs)):
        push(0.0, "start", (i, 0))
    push(T, "boundary", None)
    while heap and len(out) < n_aggs:
        t, _, kind, payload = heapq.heappop(heap)
        if kind == "start":
            i, mr = payload
            _, beta, k, delta = devs[i]
            push(t + (k * devs[i][0] + delta * beta), "arrival", (i, mr))
        elif kind == "arrival":
            buffer.append(payload)
        else:
            rnd += 1
            if buffer:
                out.append((rnd, sorted(buffer)))
                for i, _ in buffer:
                    push(t, "start", (i, rnd))
                buffer = []
            push(t + T, "boundary", None)
    return out


def loaders(tr: dict, n: int, sim_seed: int) -> list:
    """Per device, its loader over its iid share of n samples."""
    shares = iid_shares(n, tr["devices"], sim_seed)
    return [Loader(s, tr["batch_size"], sim_seed + 17 * i)
            for i, s in enumerate(shares)]


def grad(model, cfg, w, sp, x, y, prec):
    """The gradient of the model's loss at w on one batch (`model` is
    the configuration's model reference)."""
    wt = w.detach().clone().requires_grad_(True)
    g, = torch.autograd.grad(model.loss(wt, sp, cfg, x, y, prec), wt)
    return g


def momentum_step(w, mu, g, lr, momentum):
    """(w', mu'): mu' = momentum·mu + g, w' = w − lr·mu'."""
    mu = mu * momentum + g
    return w - lr * mu, mu


def eq6(w: np.ndarray, payloads: list, eta_g: float) -> np.ndarray:
    """w − η_g/|S| · Σ payloads, summed in arrival order."""
    acc = np.zeros_like(w)
    for u in payloads:
        acc += u
    return w - np.float32(eta_g / len(payloads)) * acc

