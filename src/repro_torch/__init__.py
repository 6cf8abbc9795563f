"""FedLuck in PyTorch: the port of `repro` to CUDA on an NVIDIA H100.

Same sub-packages as `repro` (configs, core, data, dist, ft, obs,
kernels, models, optim, checkpoint, launch). Parameters live as views of
one flat fp32 buffer in JAX dict-flatten order, so payload indices mean
the same coordinates as in the reference. Entry points run on `cuda`
unless the caller passes `device="cpu"`; asking for `cuda` without a card
raises.

Importing the package turns TF32 off for cuDNN convolutions and CUDA
matrix products: the reference computes in full fp32, and cuDNN would
otherwise run fp32 convolutions in TF32.
"""
from __future__ import annotations

import torch

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """`device` as a torch.device; raises when a CUDA device is asked for
    and no card is present (never carries on quietly on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            f"is False; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev
