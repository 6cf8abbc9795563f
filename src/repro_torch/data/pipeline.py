"""Batching pipeline: per-client infinite loaders and stacked-batch
prefetch (numpy on the host; the simulator moves each batch to its
device), and `sharded_batches`, which lays host batches out on a
`DeviceMesh` for the mesh layer's steps."""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np


class DataLoader:
    """Infinite shuffled batches over a subset of a dataset (one FL client)."""

    def __init__(self, dataset, indices: np.ndarray | None = None,
                 batch_size: int = 64, seed: int = 0, drop_last: bool = True):
        self.ds = dataset
        self.indices = np.arange(len(dataset)) if indices is None else indices
        self.batch_size = min(batch_size, len(self.indices))
        self.rng = np.random.RandomState(seed)
        self._order = self.rng.permutation(self.indices)
        self._pos = 0

    def next(self) -> dict:
        if self._pos + self.batch_size > len(self._order):
            self._order = self.rng.permutation(self.indices)
            self._pos = 0
        idx = self._order[self._pos:self._pos + self.batch_size]
        self._pos += self.batch_size
        return self.ds.batch(idx)

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.next()


class StackedLoader:
    """Stacked-batch iterator over a `DataLoader` for k-step local rounds.

    Each `next()` groups `k` consecutive loader batches into one host batch
    of shape [k, B, ...] — the layout `lax.scan`-based local rounds consume.
    With `prefetch > 0` a background thread draws *individual* loader
    batches ahead into a bounded queue and `next()` stacks `k` of them,
    overlapping host-side batching with device compute. The queue holds
    per-step batches, not stacked rounds, so draws are k-agnostic: a
    mid-run `set_k` (controller re-plan) only changes how many are popped
    per round, and the underlying draw sequence — hence every batch a run
    sees — is bitwise identical to `prefetch=0`, re-plans included (the
    single producer preserves the loader's RNG order).
    """

    def __init__(self, loader: DataLoader, k: int, prefetch: int = 1):
        self.loader = loader
        self.k = int(k)
        self._depth = int(prefetch)
        self._q: queue.Queue | None = None
        self._thread: threading.Thread | None = None
        self._stop = False

    def set_k(self, k: int) -> None:
        """Adopt a new local-round length from the next `next()` on.
        Prefetched per-step batches stay valid — nothing is flushed."""
        self.k = int(k)

    def _next_batch(self) -> dict:
        if self._depth <= 0:
            return self.loader.next()
        if self._thread is None:
            # depth is in units of stacked rounds at the initial k
            self._q = queue.Queue(maxsize=max(2, self._depth * self.k))
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()
        return self._q.get()

    def _worker(self) -> None:
        while not self._stop:
            item = self.loader.next()
            while not self._stop:
                try:
                    self._q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def next(self) -> dict:
        batches = [self._next_batch() for _ in range(self.k)]
        return {kk: np.stack([b[kk] for b in batches]) for kk in batches[0]}

    def close(self) -> None:
        """Stop the prefetch thread (safe to call more than once)."""
        self._stop = True
        if self._q is not None:
            try:
                self._q.get_nowait()
            except queue.Empty:
                pass

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.next()


def sharded_batches(loader, mesh, batch_axes: tuple[str, ...] = ("data",)
                    ) -> Iterator[dict]:
    """Host batches placed on `mesh` (a `DeviceMesh`) as DTensors: the
    batch (leading) dim of every leaf sharded over `batch_axes` (nested
    in mesh order), 0-d leaves replicated. Every rank draws the same host
    batch from its loader, as every process of the reference does, and
    keeps its own rows; a batch dim the axes do not divide is refused."""
    import torch

    from repro_torch.dist import sharding as shl
    n = shl._axis_size(tuple(batch_axes), mesh)
    if n is None:
        raise ValueError(f"batch axes {batch_axes} are not all in the mesh "
                         f"{mesh.mesh_dim_names}")
    while True:
        out = {}
        for k, v in loader.next().items():
            t = torch.as_tensor(np.asarray(v), device=mesh.device_type)
            if t.ndim and t.shape[0] % n:
                raise ValueError(f"batch leaf {k!r}: {t.shape[0]} rows do "
                                 f"not split over {batch_axes} ({n})")
            spec = shl.P(tuple(batch_axes), *[None] * (t.ndim - 1)) \
                if t.ndim else shl.P()
            out[k] = shl.distribute({k: t}, {k: spec}, mesh)[k]
        yield out
