"""Classification data for the FL cells: class prototype + low-rank
distortion + pixel noise, a copy of the port's
`repro_torch.data.synthetic.SyntheticClassification` draw, seeded from
the run's seed. A configuration names it as `"data": {"generator":
"images", ...}` with `image_shape`, `classes`, `noise` and `signal`.

A generator of the FL driver is a module of this package with
`make(data, n, task_seed, sample_seed)`, which returns a dataset with
`len`, `.x` (the inputs, one row per sample), `.labels` and
`.batch(idx)` (the batch as the program's task reads it).
"""
from __future__ import annotations

import numpy as np


class Dataset:
    """Images x [N, H, W, C] f32 and labels [N]."""

    def __init__(self, x: np.ndarray, labels: np.ndarray):
        self.x, self.labels = x, labels

    def __len__(self) -> int:
        return len(self.labels)

    def batch(self, idx):
        return {"image": self.x[idx], "label": self.labels[idx]}


def make(data: dict, n: int, task_seed: int, sample_seed: int) -> Dataset:
    shape = tuple(data["image_shape"])
    classes = int(data["classes"])
    rng = np.random.RandomState(task_seed)
    srng = np.random.RandomState(sample_seed)
    d = int(np.prod(shape))
    protos = rng.randn(classes, d).astype(np.float32)
    protos *= data["signal"] / np.linalg.norm(protos, axis=1, keepdims=True)
    mix = rng.randn(8, d).astype(np.float32) / np.sqrt(d)
    labels = srng.randint(0, classes, n)
    coeff = srng.randn(n, 8).astype(np.float32)
    noise = srng.randn(n, d).astype(np.float32) * np.float32(data["noise"])
    x = protos[labels] + coeff @ mix * np.float32(0.5) + noise
    return Dataset(x.reshape((n,) + shape).astype(np.float32),
                   labels.astype(np.int64))
