"""Paper reproduction (Figs. 2–3 shape) on the PyTorch port: FedLuck vs the
four baselines on one task — elapsed simulated time and communication to
target accuracy.

Run:  PYTHONPATH=src python examples/torch_fedluck_vs_baselines.py \\
          [task] [--device cpu]
      task ∈ {mlp_fmnist (fast, default), cnn_fmnist, lstm_sc}
"""
import argparse

import torch

from repro_torch.core.simulator import (AFLSimulator, STRATEGY_FOR_METHOD,
                                        make_heterogeneous_devices,
                                        plan_devices)
from repro_torch.models.small import make_task

ap = argparse.ArgumentParser()
ap.add_argument("task", nargs="?", default="mlp_fmnist")
ap.add_argument("--device", default="cuda",
                help="torch device (cuda | cpu); cuda without a card raises")
args = ap.parse_args()
task_name = args.task
task = make_task(task_name, num_samples=2000, test_samples=400, noise=1.2)
flat = task.init_fn(torch.Generator().manual_seed(0))
profiles = make_heterogeneous_devices(5, flat.numel() * 32, base_alpha=0.02,
                                      seed=0)
TARGET = 0.85

print(f"task={task_name}  d={flat.numel():,}  target_acc={TARGET}")
print(f"{'method':14s} {'time-to-acc(s)':>15s} {'comm(Gbit)':>12s} "
      f"{'final acc':>10s}")
results = {}
for method in ("fedluck", "fedper", "fedbuff", "fedasync", "fedavg_topk"):
    specs = plan_devices(profiles, method, 1.0, k_bounds=(1, 20),
                         fixed_k=5, fixed_delta=0.1)
    kw = {"strategy_kwargs": {"buffer_size": 3}} if method == "fedbuff" \
        else {}
    sim = AFLSimulator(task, specs, STRATEGY_FOR_METHOD[method],
                       round_period=1.0, eta_l=0.05, seed=0,
                       device=args.device, **kw)
    h = sim.run(total_rounds=30, eval_every=2)
    t = h.time_to_accuracy(TARGET)
    b = h.bits_to_accuracy(TARGET)
    results[method] = (t, b)
    print(f"{method:14s} {t if t else float('nan'):15.2f} "
          f"{b if b else float('nan'):12.4f} {h.final_accuracy():10.3f}")

t_luck, b_luck = results["fedluck"]
others_t = [v[0] for k, v in results.items() if k != "fedluck" and v[0]]
others_b = [v[1] for k, v in results.items() if k != "fedluck" and v[1]]
if t_luck and others_t:
    print(f"\nFedLuck time saving vs baseline mean: "
          f"{1 - t_luck / (sum(others_t)/len(others_t)):.0%} "
          f"(paper reports 55% on real datasets)")
if b_luck and others_b:
    print(f"FedLuck comm saving vs baseline mean: "
          f"{1 - b_luck / (sum(others_b)/len(others_b)):.0%} "
          f"(paper reports 56%)")
