"""Sharded-execution layer: maps FedLuck's joint (k, δ) scheme onto a
(pod, data, model) device mesh (PyTorch port of `repro.dist`).

  sharding     FSDP/TP partition rules for every tree the launchers move
               (params, optimizer state, batches, KV caches) and their
               DTensor layouts
  steps        train / local-round / pod-round / prefill / decode step
               builders
  collectives  the Eq. 6 cross-pod sync (EF top-k sparse reduce), on one
               card or across processes, and the δ-adaptive sparse/dense
               wire-cost model
  spmd         the explicit collectives of the LM's shard-local regions

The step functions run on plain tensors (one device) or on DTensors laid
out by `sharding.distribute` on a `DeviceMesh` (one process per rank), so
the same code runs on one card, on the 8-process gloo test mesh and on
the fake 512-rank mesh of the dry run.
"""
from repro_torch.dist import collectives, sharding, spmd, steps

__all__ = ["collectives", "sharding", "spmd", "steps"]
