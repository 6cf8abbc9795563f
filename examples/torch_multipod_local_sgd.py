"""Datacenter mapping of FedLuck on the PyTorch port: each "pod" runs k
local steps on its own shard of the batch, EF-top-k-compresses the
pseudo-gradient at the controller-chosen δ, and the deltas are aggregated
with the Eq. 6 server rule. Here pods run serially on one device with a
smoke-size LM; across processes the aggregation is `make_pod_sync` in
repro_torch.dist.collectives.

Run:  PYTHONPATH=src python examples/torch_multipod_local_sgd.py \\
          [--device cpu]
"""
import argparse
import os
import subprocess
import sys

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda",
                help="torch device (cuda | cpu); cuda without a card raises")
device = ap.parse_args().device
os.environ.setdefault("PYTHONPATH", "src")
subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                "--mode", "datacenter", "--arch", "mamba2-780m",
                "--steps", "15", "--pods", "2", "--local-k-max", "8",
                "--dcn-bps", "1e11", "--device", device],
               env=dict(os.environ), check=True)
