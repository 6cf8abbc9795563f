"""Production mesh builders (PyTorch port of `repro.launch.mesh`).

Functions, not module constants: importing this module starts no process
group and touches no device. Each builder returns a
`torch.distributed.device_mesh.DeviceMesh` made by `init_device_mesh`
over the default process group, which the caller starts first (NCCL on
cards, gloo on the CPU, the `fake` backend for the dry run).
"""
from __future__ import annotations

# the shape helpers live with the rules that read them; exported here too,
# where the reference keeps `batch_axes_for`
from repro_torch.dist.sharding import batch_axes_for, mesh_shape

__all__ = ["make_production_mesh", "make_local_mesh", "batch_axes_for",
           "mesh_shape"]


def _mesh(shape: tuple, names: tuple, device_type: str):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """Single pod: 16×16 = 256 ranks (data, model).
    Multi-pod: 2×16×16 = 512 ranks (pod, data, model) — the `pod` axis is
    the FedLuck aggregation axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_local_mesh(data: int = 1, model: int = 1, *,
                    device_type: str = "cuda"):
    """A small (data, model) mesh over the default group's ranks (tests,
    one card)."""
    return _mesh((data, model), ("data", "model"), device_type)
