"""Multi-pod layer: FedLuck's datacenter round with the Eq. 6 cross-pod
sync (PyTorch port of the `collectives` and `steps` parts of `repro.dist`).

  collectives  the Eq. 6 cross-pod sync (EF top-k sparse reduce over the
               compact wire) and the δ-adaptive sparse/dense wire-cost model
  steps        the local-round and pod-round step builders

Every pod and in-pod shard lives on one card and the sync runs over them
in order; the multi-process gather (one process per card) and the
FSDP/TP `sharding` rules are still to be ported.
"""
from repro_torch.dist import collectives, steps

__all__ = ["collectives", "steps"]
