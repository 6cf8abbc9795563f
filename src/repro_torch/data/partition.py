"""Client data partitioners: IID and Dirichlet non-IID (paper Sec 4.3, α=1.0)."""
from __future__ import annotations

import numpy as np


def iid_partition(num_samples: int, num_clients: int, seed: int = 0) -> list[np.ndarray]:
    rng = np.random.RandomState(seed)
    perm = rng.permutation(num_samples)
    return [np.sort(s) for s in np.array_split(perm, num_clients)]


def dirichlet_partition(labels: np.ndarray, num_clients: int,
                        alpha: float = 1.0, seed: int = 0,
                        min_per_client: int = 8) -> list[np.ndarray]:
    """Assign samples to clients with per-class Dirichlet(alpha) proportions.

    Matches Hsu et al. 2019 as cited by the paper (concentration α=1.0).
    Retries until every client has at least `min_per_client` samples.
    """
    rng = np.random.RandomState(seed)
    classes = np.unique(labels)
    for _attempt in range(100):
        buckets: list[list[int]] = [[] for _ in range(num_clients)]
        for c in classes:
            idx = np.where(labels == c)[0]
            rng.shuffle(idx)
            props = rng.dirichlet([alpha] * num_clients)
            cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
            for b, part in zip(buckets, np.split(idx, cuts)):
                b.extend(part.tolist())
        sizes = [len(b) for b in buckets]
        if min(sizes) >= min_per_client:
            return [np.sort(np.asarray(b)) for b in buckets]
    raise RuntimeError("dirichlet_partition failed to satisfy min_per_client")
