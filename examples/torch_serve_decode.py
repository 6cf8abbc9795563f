"""Batched serving on the PyTorch port: prefill + greedy decode with KV/SSM
caches on two architecture families (GQA transformer and attention-free
mamba2), smoke configs.

Run:  PYTHONPATH=src python examples/torch_serve_decode.py [--device cpu]
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
for arch in ("gemma3-4b", "mamba2-780m"):
    print(f"=== serving {arch} (reduced config) ===", flush=True)
    subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                    "--arch", arch, "--requests", "4", "--batch", "2",
                    "--prompt-len", "12", "--gen", "12", "--device", device],
                   env=dict(os.environ), check=True)
