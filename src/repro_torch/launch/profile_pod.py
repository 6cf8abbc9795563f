"""Wall and device-time breakdown of the multi-pod datacenter round on one
GPU.

    PYTHONPATH=src python -m repro_torch.launch.profile_pod --rounds 5 \
        [--rate 0.01]

Builds FedLuck's datacenter round (`dist.steps.make_pod_round_step` over
`dist.collectives.make_pod_sync`) with `build_pod_round`, the builder
`chip_smoke.py` checks the same round with: cnn_fmnist at full width,
4 pods × 2 in-pod shards on one card, blocks of 1024, k = 5 momentum-SGD
steps (lr 0.05) at batch 32 per pod, each pod on an iid share of 4000
samples; `--rate` is δ (0.01 resolves to the compact wire, above 0.25 to
the dense one). Runs one warm-up round, `--rounds` timed rounds (host
wall, split into local rounds and sync by `SplitSync`) and one round
under `torch.profiler`, then prints one JSON
object: per-round walls and splits, their medians, the profiled round's
device-busy seconds (sum of CUDA kernel and copy times, one stream) and
idle share, and the top device entries by time with their call counts.
Profiling adds host overhead, so the profiled idle share is an upper
bound.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.data.partition import iid_partition
from repro_torch.data.pipeline import DataLoader
from repro_torch.obs.profiling import device_breakdown, device_profile


def pod_blocks(dim: int, blk: int, n_shards: int) -> int:
    """Blocks of `blk` covering `dim`, rounded up to a multiple of the
    in-pod shard count."""
    nb = -(-dim // blk)
    return nb + (-nb % n_shards)


def pod_batches(task, n_pods: int, k: int, batch: int, seed: int, device):
    """A draw() giving one round's batches: dict of [n_pods, k, B, ...]
    tensors on `device`, each pod from its own iid share of the task's
    dataset (floating arrays as f32)."""
    shares = iid_partition(len(task.dataset), n_pods, seed=seed)
    loaders = [DataLoader(task.dataset, idx, batch_size=batch,
                          seed=seed + 17 * p) for p, idx in enumerate(shares)]

    def draw():
        steps = [[ld.next() for _ in range(k)] for ld in loaders]
        out = {}
        for key in steps[0][0]:
            a = np.stack([np.stack([b[key] for b in pod]) for pod in steps])
            if np.issubdtype(a.dtype, np.floating):
                a = a.astype(np.float32)
            out[key] = torch.as_tensor(a).to(device)
        return out
    return draw


class SplitSync:
    """A pod sync that times itself: it synchronises the card on entry and
    on exit and keeps each call's (entry, exit) host times, so a round's
    local rounds end at entry and its sync takes exit − entry."""

    def __init__(self, sync, device):
        self.sync, self.device = sync, torch.device(device)
        self.payload_bits_per_pod = sync.payload_bits_per_pod
        self.spans: list[tuple[float, float]] = []
        self.last_deltas = None     # the deltas of the latest call

    def _wait(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __call__(self, params, deltas, residuals):
        self._wait()
        t0 = time.perf_counter()
        out = self.sync(params, deltas, residuals)
        self._wait()
        self.last_deltas = deltas
        self.spans.append((t0, time.perf_counter()))
        return out


class TaskLM:
    """The `lm` the step builders take: a task's loss over a params dict."""

    def __init__(self, task):
        self.loss = task.loss_fn


TASK, SAMPLES, BATCH, LOCAL_K, LR, RATE = "cnn_fmnist", 4000, 32, 5, 0.05, 0.01
MESH, BLK, TOP = {"pod": 4, "data": 2, "model": 1}, 1024, 15


@dataclasses.dataclass
class PodRound:
    """A pod round from `build_pod_round` and the state it starts from."""
    task: Any
    sync: Callable          # make_pod_sync's function
    split: SplitSync        # `sync`, timed; the one `step` calls
    step: Callable          # make_pod_round_step's function
    draw: Callable          # () -> one round's [P, k, B, ...] batches
    dim: int
    n_blocks: int
    params: torch.Tensor    # [n_blocks, blk], the task's init zero-padded
    opt_states: list        # one momentum-SGD state per pod
    residuals: torch.Tensor     # [P, n_blocks, blk] zeros


def build_pod_round(device, rate: float = RATE, *, task=None, mesh=MESH,
                    blk: int = BLK, k: int = LOCAL_K, batch: int = BATCH
                    ) -> PodRound:
    """FedLuck's datacenter round: per pod, k momentum-SGD(LR) steps at
    `batch` from an iid share of `task`'s data, then the `auto` sync at
    δ = `rate` over `mesh`'s pods and in-pod shards, all on `device`, in
    blocks of `blk`. `task` defaults to cnn_fmnist at full width over
    SAMPLES samples; params and batches come from seed 0."""
    from repro_torch.dist import collectives as col, steps
    from repro_torch.models.small import make_task
    from repro_torch.optim import momentum_sgd

    dev = resolve_device(device)
    if task is None:
        task = make_task(TASK, num_samples=SAMPLES, test_samples=16,
                         batch_size=batch)
    n_pods, n_shards = mesh["pod"], mesh["data"] * mesh["model"]
    flat = task.init_fn(torch.Generator().manual_seed(0)).to(dev)
    dim = flat.numel()
    nb = pod_blocks(dim, blk, n_shards)
    sync = col.make_pod_sync(mesh, nb * blk, rate=rate, n_blocks=nb)
    opt = momentum_sgd(LR)
    split = SplitSync(sync, dev)
    step = steps.make_pod_round_step(TaskLM(task), opt, k, split,
                                     spec=task.spec, dim=dim, n_blocks=nb)
    params = torch.zeros(nb * blk, device=dev)
    params[:dim] = flat
    return PodRound(task, sync, split, step,
                    pod_batches(task, n_pods, k, batch, 0, dev), dim, nb,
                    params.view(nb, blk),
                    [opt.init(flat) for _ in range(n_pods)],
                    torch.zeros((n_pods, nb, blk), device=dev))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rate", type=float, default=RATE, help="δ")
    ap.add_argument("--rounds", type=int, default=5, help="timed rounds")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    pr = build_pod_round("cuda", args.rate)
    state = [pr.params, pr.opt_states, pr.residuals]

    def round_():
        """(wall, local rounds, sync) seconds and the loss of one round."""
        batches = pr.draw()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pb, states, res, loss = pr.step(*state[:2], batches, state[2])
        loss = float(loss)      # waits for the round
        state[:] = [pb, states, res]
        s0, s1 = pr.split.spans[-1]
        return time.perf_counter() - t0, s0 - t0, s1 - s0, loss

    round_()                                                # warm-up
    rounds = [round_() for _ in range(args.rounds)]
    walls, local_s, sync_s, _ = map(list, zip(*rounds))
    with device_profile() as prof:
        wall_prof = round_()[0]
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "task": TASK,
        "dim": pr.dim, "n_blocks": pr.n_blocks, "mesh": MESH,
        "path": pr.sync.path,
        "budget": pr.sync.wire.budget if pr.sync.wire else None,
        "local_k": LOCAL_K, "batch": BATCH, "rounds": args.rounds,
        "last_loss": rounds[-1][3], "wall_s": walls,
        "local_rounds_s": local_s, "sync_s": sync_s,
        "median_wall_s": statistics.median(walls),
        "median_local_rounds_s": statistics.median(local_s),
        "median_sync_s": statistics.median(sync_s),
        "profiled_wall_s": wall_prof,
        **device_breakdown(prof, wall_prof, TOP),
    }, indent=1))


if __name__ == "__main__":
    main()
