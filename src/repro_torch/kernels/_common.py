"""Input checks shared by the kernel wrappers."""
from __future__ import annotations

import torch

FLOAT_TYPES = (torch.float32, torch.bfloat16)


def check_vector(what: str, t: torch.Tensor, dtypes=FLOAT_TYPES,
                 n: int | None = None, device: torch.device | None = None
                 ) -> None:
    """Raise unless `t` is a contiguous 1-D tensor of an accepted dtype (and
    of length `n` / on `device` when given)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{what}: expected a torch.Tensor, got {type(t)}")
    if t.dim() != 1:
        raise ValueError(f"{what}: expected a flat [d] tensor, got shape "
                         f"{tuple(t.shape)}")
    if t.dtype not in dtypes:
        raise TypeError(f"{what}: dtype {t.dtype} not in {dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: tensor must be contiguous")
    if n is not None and t.numel() != n:
        raise ValueError(f"{what}: length {t.numel()} != {n}")
    if device is not None and t.device != device:
        raise ValueError(f"{what}: on {t.device}, expected {device}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {t.device}")
