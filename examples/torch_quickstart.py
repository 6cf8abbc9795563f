"""Quickstart on the PyTorch port (`repro_torch`): FedLuck in ~40 lines.

1. Profile each device (α = s/local-step, β = s/full-gradient-upload).
2. The controller minimizes the key convergence factor φ(k, δ) (Eq. 14/15)
   to pick each device's local-update count k_i and top-k density δ_i.
3. Run asynchronous federated training with periodic aggregation (Alg. 1).

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import torch

from repro_torch.core.controller import FedLuckController
from repro_torch.core.simulator import (AFLSimulator, DeviceSpec,
                                        make_heterogeneous_devices)
from repro_torch.models.small import make_task

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda",
                help="torch device (cuda | cpu); cuda without a card raises")
device = ap.parse_args().device

# ---- task: the paper's CNN@FMNIST (synthetic stand-in data offline).
# (swap to "cnn_fmnist" + larger k_max for the full-size run; the MLP keeps
# this quickstart under a minute on one CPU core)
task = make_task("mlp_fmnist", num_samples=2000, test_samples=400)
flat = task.init_fn(torch.Generator().manual_seed(0))
print(f"model: d = {flat.numel():,} parameters")

# ---- heterogeneous devices: α ~ U[a, 4a], bandwidth 0.25–2 Mb/s (Sec 4.3)
profiles = make_heterogeneous_devices(num=5, model_bits=flat.numel() * 32,
                                      base_alpha=0.02, seed=0)

# ---- FedLuck controller: solve Eq. 15 per device
controller = FedLuckController(round_period=1.0, k_bounds=(1, 20),
                               delta_bounds=(1e-3, 1.0))
devices = []
for p in profiles:
    plan = controller.register(p)
    devices.append(DeviceSpec(p, plan, compressor="topk"))
print("per-device plans (k_i, δ_i) from minimizing φ:")
print(controller.summary())

# ---- asynchronous training with periodic aggregation
sim = AFLSimulator(task, devices, "periodic", round_period=1.0,
                   eta_l=0.05, seed=0, device=device)
history = sim.run(total_rounds=20, eval_every=4)

for r in history.records:
    print(f"  t={r.time:5.1f}s  round={r.round:3d}  acc={r.accuracy:.3f}  "
          f"comm={r.gbits:.3f} Gbit")
print(f"final accuracy: {history.final_accuracy():.3f}")
