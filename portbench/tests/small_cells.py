"""The benchmark's cells cut to a size a CPU test run holds: the CNN at
its published width on a fleet of 2 devices, 64 images and batches of
8, the Mamba-2 LM at width 64 over 2 layers and 64-token sequences.
Widths and shapes of the timed cells are the configuration files'; only
these copies are small. `one_thread` runs a test on one CPU thread, so
the test workers do not oversubscribe the cores."""
from __future__ import annotations

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
for p in (ROOT, os.path.join(ROOT, "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from portbench.harness import spec  # noqa: E402

FL = ("cnn_fmnist.fl_fedluck", "cnn_fmnist.fl_threshold")
POD = ("mamba2-780m.pod_compact", "mamba2-780m.pod_dense")


def small(workload: str) -> dict:
    cell = spec.resolve(spec.load_benchmark(), workload)
    if cell["traffic"]["driver"] == "fl":
        cell["config"]["data"].update(train_samples=64, test_samples=32)
        cell["traffic"].update(devices=2, k_bounds=[1, 3], batch_size=8,
                               segment_rounds=2, check_aggregations=2)
    else:
        cell["config"].update(d_model=64, n_layer=2, vocab_size=512)
        cell["config"]["ssm_cfg"].update(d_state=16, headdim=16,
                                         chunk_size=32)
        cell["traffic"].update(seq_len=64, token_rows=64, blk=64)
    return cell


@pytest.fixture
def one_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
