"""How exactly the two engines' local rounds take cnn_fmnist's gradients.

    PYTHONPATH=src python -m repro_torch.launch.grad_accuracy \
        [--fleet-seeds 4] [--device cuda]

Prints one JSON object with the parts below.

`steps` (`first_step_check`): the local rounds of `rows` devices, `steps`
momentum-SGD steps from the task's initial model, each row on its own
seeded batches of 32. At every step both engines' gradient paths take
every row's gradient at the same weights (the sequential path's
trajectory): `dist.steps.batched_grad` over the rows, as the batched
engine does, and `torch.autograd.grad` row by row, as the sequential
engine does, both fp32, with row-by-row float64 as the truth. cnn_fmnist
routes each gradient through its ReLUs and the argmax of its 2x2
max-pools, decisions that fp32 rounding can flip where an input is
closer to a tie than the rounding: every row-step counts as flipped or
not, with the float64 gap of each flipped decision. Then the pseudo-
gradients of both engines' whole local rounds on the same batches.

`ways`: the first step's gradients of `rows × DRAWS` rows, taken as
autograd, as the engine does (`engine`), by a plain `vmap(grad)` and by
`grad` without vmap (`vmap_rows`), under cuDNN's default flags and with
`deterministic`, `benchmark` or cuDNN off (`nocudnn`: PyTorch's own
convolutions), each held against float64: per way, the median and worst
per-row relative error ‖g − g64‖ / ‖g64‖, the rows that decide some
ReLU or pool differently from float64, and the wall of one call (median
of 5 after a warm-up).

`convs`: cnn_fmnist's two convolutions alone, see `convs`.

`fleet` (with `--fleet-seeds N`): `chip_smoke.py`'s fedper fleet (10
devices, k 10, δ 0.1, round period 15, 3 rounds) with simulator seeds
0..N-1, run sequential, batched, sequential again and sequential with
cuDNN off (PyTorch's own convolutions, as exact as cuDNN's ungrouped
ones but summed in another order), with cuDNN's default flags and with
`deterministic`: per seed and round, each run's accuracy and loss minus
the first sequential run's.
"""
from __future__ import annotations

import argparse
import copy
import json
import statistics
import time

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.core import compression as C
from repro_torch.dist.steps import (batched_grad, batched_local_round,
                                    local_round)
from repro_torch.models import nn
from repro_torch.models.small import make_task
from repro_torch.optim import momentum_sgd

ROWS, STEPS, DRAWS = 8, 10, 8  # a chunk of 8 rows, k = 10, 64 rows in `ways`
TOL = 1e-5          # fp32-level relative tolerance of one step's gradient
TIE = 1e-5          # float64 relative gap below which a pool may flip
LR, MOMENTUM = 0.05, 0.9       # the simulator's eta_l and momentum


def activations(p: dict, image: torch.Tensor):
    """cnn_apply's inputs to its ReLUs and max-pools (mirrors
    `models.small.cnn_apply`): conv1's output, conv2's output (NCHW) and
    fc1's output. Each ReLU keeps the positive ones and each 2x2 pool
    routes its gradient to the largest of its window."""
    c1 = nn.conv2d(p["conv1"], image)
    c2 = nn.conv2d(p["conv2"], nn.max_pool(torch.relu(c1)))
    x = nn.max_pool(torch.relu(c2)).reshape(image.shape[0], -1)
    return c1.permute(0, 3, 1, 2), c2.permute(0, 3, 1, 2), \
        nn.linear(p["fc1"], x)


def _pool(a: torch.Tensor) -> torch.Tensor:
    """The input each 2x2 max-pool window of relu(a) routes its gradient
    to."""
    return F.max_pool2d(torch.relu(a), 2, 2, return_indices=True)[1]


def _window_gaps(a64: torch.Tensor, mask: torch.Tensor) -> list[float]:
    """Float64 relative gap between the two largest inputs of the masked
    windows of relu(a64) [N, C, H, W]."""
    n, c, h, w = a64.shape
    win = torch.relu(a64).reshape(n, c, h // 2, 2, w // 2, 2).permute(
        0, 1, 2, 4, 3, 5).reshape(n, c, h // 2, w // 2, 4)[mask]
    top = win.sort(dim=-1, descending=True).values
    return ((top[:, 0] - top[:, 1]) / top[:, 0].abs().clamp_min(1e-300)
            ).tolist()


def flips(acts, other, acts64) -> list[float]:
    """Float64 gaps of the decisions two paths' activations (one row's)
    take differently: a ReLU whose input's sign differs (gap |x| / max|x|
    of the layer) or a pool window whose argmax differs (gap between its
    two largest inputs, relative)."""
    gaps = []
    for a, b, a64 in zip(acts, other, acts64):
        sign = (a > 0) != (b > 0)
        if sign.any():
            gaps += (a64[sign].abs() / a64.abs().max()).tolist()
        if a.dim() == 4:
            mask = _pool(a) != _pool(b)
            if mask.any():
                gaps += _window_gaps(a64, mask)
    return gaps


def _rel(g: torch.Tensor, ref: torch.Tensor) -> float:
    g, ref = g.double(), ref.double().to(g.device)
    return float((g - ref).norm() / ref.norm().clamp_min(1e-300))


class Rows:
    """Seeded per-row batches of cnn_fmnist and the gradient paths."""

    def __init__(self, dev: torch.device, rows: int, seed: int = 0):
        self.task = make_task("cnn_fmnist", num_samples=4000,
                              test_samples=100, batch_size=32)
        self.spec, self.dev, self.rows = self.task.spec, dev, rows
        self.w0 = self.task.init_fn(torch.Generator().manual_seed(seed)
                                    ).to(dev)
        self.rng = np.random.default_rng(seed)
        loss = self.task.loss_fn
        self.grad1 = torch.func.grad(
            lambda wr, b: loss(C.unflatten_pytree(wr, self.spec), b))
        self.batched = batched_grad(loss, self.spec)

    def draw(self) -> dict:
        """One step's batches, [rows, 32, ...] numpy."""
        ds = self.task.dataset
        bs = [ds.batch(self.rng.choice(len(ds), 32, replace=False))
              for _ in range(self.rows)]
        return {key: np.stack([b[key] for b in bs]) for key in bs[0]}

    def on(self, host: dict, dtype=torch.float32) -> dict:
        out = {}
        for key, v in host.items():
            t = torch.from_numpy(np.asarray(v))
            out[key] = t.to(self.dev, dtype if t.is_floating_point()
                            else None)
        return out

    def autograd(self, W: torch.Tensor, b: dict) -> torch.Tensor:
        """Row by row, as `dist.steps.local_round` takes them."""
        out = []
        for r in range(W.shape[0]):
            w = W[r].clone().requires_grad_(True)
            loss = self.task.loss_fn(C.unflatten_pytree(w, self.spec),
                                     {k: v[r] for k, v in b.items()})
            out.append(torch.autograd.grad(loss, w)[0])
        return torch.stack(out)

    def engine(self, W: torch.Tensor, b: dict) -> torch.Tensor:
        """All rows at once, as `dist.steps.batched_local_round` takes
        them (`dist.steps.batched_grad`)."""
        return self.batched(W, b)

    def vmap(self, W: torch.Tensor, b: dict) -> torch.Tensor:
        """All rows at once by a plain `vmap(grad(loss))`, under whatever
        cuDNN flags are set."""
        return torch.func.vmap(self.grad1)(W, b)

    def grad_rows(self, W: torch.Tensor, b: dict) -> torch.Tensor:
        return torch.stack([self.grad1(W[r], {k: v[r] for k, v in b.items()})
                            for r in range(W.shape[0])])

    def acts_vmap(self, W, b, cudnn: bool = True):
        """The activations as a vmapped forward computes them (with
        cuDNN off when `cudnn` is False, as `batched_grad` runs)."""
        fwd = torch.func.vmap(lambda w, img: activations(
            C.unflatten_pytree(w, self.spec), img))
        with torch.backends.cudnn.flags(
                enabled=cudnn, benchmark=False, deterministic=False,
                allow_tf32=False):
            return fwd(W, b["image"])

    def acts_rows(self, W, b):
        outs = [activations(C.unflatten_pytree(W[r], self.spec),
                            b["image"][r]) for r in range(W.shape[0])]
        return tuple(torch.stack(x) for x in zip(*outs))


def _row(acts, r: int):
    return tuple(a[r] for a in acts)


def first_step_check(dev: torch.device, rows: int = ROWS,
                     steps: int = STEPS, seed: int = 0) -> dict:
    """The batched engine's gradients against the sequential engine's,
    step by step over a local round of `rows` devices at full cnn width.

    At every step both engines' gradient paths (`dist.steps.batched_grad`
    and row-by-row autograd) take every row's gradient at the same
    weights, and the sequential path's update moves them on. A row-step
    whose ReLU and max-pool decisions agree between the paths must agree
    to `TOL`; one whose decisions differ ("flipped") may differ only at
    decisions whose float64 inputs are within `TIE` of a tie. Both paths
    are also held against float64 at `TOL` on the row-steps where neither
    decides differently from it. Then both engines' local rounds
    (`batched_local_round` over all rows, `local_round` row by row) run
    on the same batches: the relative gap between their pseudo-gradients
    is reported, not held (a flipped decision moves a round's later
    steps). Returns the counts and worst errors; `ok` is False when a
    rule is broken."""
    R = Rows(dev, rows, seed)
    W = R.w0.repeat(rows, 1)
    mu = torch.zeros_like(W)
    rec = dict(row_steps=0, flipped=0, flip_decisions=0,
               worst_gap_unflipped=0.0, worst_gap_flipped=0.0,
               worst_flip_gap64=0.0, worst_err64_engine=0.0,
               worst_err64_autograd=0.0)
    hosts = []
    for _ in range(steps):
        hosts.append(R.draw())
        b, b64 = R.on(hosts[-1]), R.on(hosts[-1], torch.float64)
        gv, ga = R.engine(W, b), R.autograd(W, b)
        g64 = R.autograd(W.double(), b64)
        av, aa = R.acts_vmap(W, b, cudnn=False), R.acts_rows(W, b)
        a64 = R.acts_rows(W.double(), b64)
        for r in range(rows):
            gap = _rel(gv[r], ga[r])
            gaps = flips(_row(av, r), _row(aa, r), _row(a64, r))
            rec["row_steps"] += 1
            if gaps:
                rec["flipped"] += 1
                rec["flip_decisions"] += len(gaps)
                rec["worst_gap_flipped"] = max(rec["worst_gap_flipped"], gap)
                rec["worst_flip_gap64"] = max(rec["worst_flip_gap64"],
                                              max(gaps))
                continue
            rec["worst_gap_unflipped"] = max(rec["worst_gap_unflipped"], gap)
            if not flips(_row(aa, r), _row(a64, r), _row(a64, r)):
                rec["worst_err64_engine"] = max(rec["worst_err64_engine"],
                                                _rel(gv[r], g64[r]))
                rec["worst_err64_autograd"] = max(
                    rec["worst_err64_autograd"], _rel(ga[r], g64[r]))
        mu = MOMENTUM * mu + ga
        W = W - LR * mu
    rec["ok"] = (rec["worst_gap_unflipped"] <= TOL
                 and rec["worst_flip_gap64"] <= TIE
                 and rec["worst_err64_engine"] <= TOL
                 and rec["worst_err64_autograd"] <= TOL
                 and 2 * rec["flipped"] < rec["row_steps"])

    opt = momentum_sgd(LR, MOMENTUM)
    batches = [R.on(h) for h in hosts]
    g_b = batched_local_round(R.task.loss_fn, opt, R.w0, R.spec, batches)
    gaps = []
    for r in range(rows):
        _, _, g_s, _ = local_round(
            R.task.loss_fn, opt, R.w0, R.spec, opt.init(R.w0),
            [{k: v[r] for k, v in bt.items()} for bt in batches])
        gaps.append(_rel(g_b[r], g_s))
    rec["round_gap_median"], rec["round_gap_worst"] = \
        statistics.median(gaps), max(gaps)
    return rec


def ways(dev: torch.device, rows: int, draws: int) -> dict:
    """The first step's gradients taken every way, against float64."""
    R = Rows(dev, rows)
    W = R.w0.repeat(rows, 1)
    hosts = [R.draw() for _ in range(draws)]
    truth = []
    for host in hosts:
        b64 = R.on(host, torch.float64)
        truth.append((R.autograd(W.double(), b64),
                      R.acts_rows(W.double(), b64)))
    flags = {"": {}, "_det": {"deterministic": True},
             "_bench": {"benchmark": True}, "_nocudnn": {"enabled": False}}
    paths = {"autograd": (R.autograd, R.acts_rows),
             "engine": (R.engine, lambda W, b: R.acts_vmap(W, b, False)),
             "vmap": (R.vmap, R.acts_vmap),
             "vmap_rows": (R.grad_rows, R.acts_rows)}
    out = {}
    for suffix, kw in flags.items():
        if suffix and dev.type != "cuda":
            continue
        for name, (grad, acts) in paths.items():
            errs, flipped = [], 0
            with torch.backends.cudnn.flags(**{
                    "enabled": True, "benchmark": False,
                    "deterministic": False, "allow_tf32": False, **kw}):
                for host, (g64, a64) in zip(hosts, truth):
                    b = R.on(host)
                    g = grad(W, b)
                    a = (acts(W, b) if name != "vmap" else
                         R.acts_vmap(W, b, torch.backends.cudnn.enabled))
                    for r in range(rows):
                        errs.append(_rel(g[r], g64[r]))
                        flipped += bool(flips(_row(a, r), _row(a64, r),
                                              _row(a64, r)))
                b = R.on(hosts[0])
                wall = _wall(lambda: grad(W, b), dev)
            out[name + suffix] = {
                "median_err": statistics.median(errs), "worst_err": max(errs),
                "rows": len(errs), "rows_flipped_vs_f64": flipped,
                "wall_s": wall}
    return out


def _wall(fn, dev: torch.device, reps: int = 5) -> float:
    fn()
    times = []
    for _ in range(reps):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def convs(dev: torch.device, rows: int) -> dict:
    """cnn_fmnist's two convolutions alone, over `rows` rows of 32 images
    with a weight per row: forward output y, input gradient dx and weight
    gradient dw of sum(y · R) for a seeded R, taken under vmap (a grouped
    convolution) and row by row, with the model's layouts (NHWC input and
    HWIO kernel, permuted as `nn.conv2d` does) or contiguous NCHW / OIHW,
    with cuDNN on or off. Per variant: the worst row's relative error of
    each against float64, and the wall of one forward and backward."""
    gen = torch.Generator().manual_seed(0)
    out = {}
    for name, hw, cin, cout in (("conv1", 28, 1, 32), ("conv2", 14, 32, 64)):
        x = torch.randn(rows, 32, hw, hw, cin, generator=gen)
        w = torch.randn(rows, 5, 5, cin, cout, generator=gen) * 0.1
        R = torch.randn(rows, 32, cout, hw, hw, generator=gen)

        def f(xr, wr, rr, contiguous):
            xi, wk = xr.permute(0, 3, 1, 2), wr.permute(3, 2, 0, 1)
            if contiguous:
                xi, wk = xi.contiguous(), wk.contiguous()
            y = F.conv2d(xi, wk, padding="same")
            return (y * rr).sum(), y

        def grads(xs, ws, rs, contiguous, batched):
            def one(xr, wr, rr):
                (dx, dw), y = torch.func.grad(
                    lambda a, b: f(a, b, rr, contiguous), argnums=(0, 1),
                    has_aux=True)(xr, wr)
                return y, dx, dw
            if batched:
                return torch.func.vmap(one)(xs, ws, rs)
            return tuple(torch.stack(t) for t in zip(*[
                one(xs[r], ws[r], rs[r]) for r in range(rows)]))

        ref = grads(x.double(), w.double(), R.double(), False, False)
        xs, ws, rs = x.to(dev), w.to(dev), R.to(dev)
        for layout in ("model", "contiguous"):
            for batched in (True, False):
                for cudnn in (True, False):
                    if not cudnn and dev.type != "cuda":
                        continue
                    with torch.backends.cudnn.flags(
                            enabled=cudnn, benchmark=False,
                            deterministic=False, allow_tf32=False):
                        def call():
                            return grads(xs, ws, rs, layout != "model",
                                         batched)
                        got = call()
                        wall = _wall(call, dev)
                    key = (f"{name}/{layout}/"
                           f"{'vmap' if batched else 'rows'}/"
                           f"{'cudnn' if cudnn else 'nocudnn'}")
                    out[key] = {
                        part: max(_rel(a[r], b[r]) for r in range(rows))
                        for part, a, b in zip(("y", "dx", "dw"), got, ref)}
                    out[key]["wall_s"] = wall
    return out


# the fleet's runs: name, engine, cuDNN on
RUNS = (("sequential", "sequential", True), ("batched", "batched", True),
        ("sequential_again", "sequential", True),
        ("sequential_nocudnn", "sequential", False))


def fleet(dev: torch.device, seeds: int) -> dict:
    """Round by round (Δacc, Δloss) of the fedper fleet's runs (`RUNS`)
    against its first sequential run, per seed and cuDNN mode."""
    from repro_torch.core.simulator import (AFLSimulator,
                                            make_heterogeneous_devices,
                                            plan_devices)
    task = make_task("cnn_fmnist", num_samples=4000, test_samples=800,
                     batch_size=32)
    flat = task.init_fn(torch.Generator().manual_seed(0))
    profiles = make_heterogeneous_devices(10, flat.numel() * 32, seed=0)
    specs = plan_devices(profiles, "fedper", 1.0, k_bounds=(1, 30),
                         error_feedback=True)
    out = {}
    for mode, det in (("default", False), ("deterministic", True)):
        for seed in range(seeds):
            hists = {}
            for name, engine, cudnn in RUNS:
                with torch.backends.cudnn.flags(
                        enabled=cudnn, benchmark=False, deterministic=det,
                        allow_tf32=False):
                    sim = AFLSimulator(task, copy.deepcopy(specs), "periodic",
                                       engine=engine, device=dev, seed=seed,
                                       round_period=15.0)
                    hists[name] = sim.run(total_rounds=3, eval_every=1)
                    sim.close()
            ref = hists["sequential"].records
            out[f"{mode}/seed{seed}"] = {
                name: [(x.round, x.accuracy - y.accuracy, x.loss - y.loss)
                       for x, y in zip(h.records, ref)]
                for name, h in hists.items() if name != "sequential"}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fleet-seeds", type=int, default=0,
                    help="seeds of the `fleet` part (0: leave it out)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    res = {"device": (torch.cuda.get_device_name(0) if dev.type == "cuda"
                      else "cpu"), "torch": torch.__version__,
           "tol": TOL, "tie": TIE,
           "steps": first_step_check(dev, ROWS, STEPS),
           "ways": ways(dev, ROWS, DRAWS), "convs": convs(dev, ROWS)}
    if args.fleet_seeds:
        res["fleet"] = fleet(dev, args.fleet_seeds)
    print(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
