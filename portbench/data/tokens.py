"""Token streams for the LM cells: a Zipfian unigram stream in which
token t copies token t−8 with probability 1/4, a copy of the port's
`repro_torch.data.synthetic.SyntheticTokens` draw, seeded from the run's
seed. A configuration names it as `"data": {"generator": "tokens"}`.

A generator of the pod driver is a module of this package with
`make(data, vocab, rows, length, seed)`, which returns int64 token ids
[rows, length].
"""
from __future__ import annotations

import numpy as np


def make(data: dict, vocab: int, rows: int, length: int,
         seed: int) -> np.ndarray:
    rng = np.random.RandomState(seed)
    p = 1.0 / np.arange(1, vocab + 1) ** 1.1
    cdf = np.cumsum(p / p.sum())
    flat = np.searchsorted(cdf, rng.random_sample(rows * length) * cdf[-1])
    toks = np.minimum(flat, vocab - 1).reshape(rows, length)
    for t in range(8, length):
        m = rng.random_sample(rows) < 0.25
        toks[m, t] = toks[m, t - 8]
    return toks.astype(np.int64)
