"""The precision the plain references compute in.

"fp32": float32 with TF32 off for matrix products and convolutions, the
precision the configurations state. "tf32": the next precision below,
the correctness control: on a card the TF32 switches are turned on; on
the CPU, which has no TF32, each operand of a matrix product or
convolution is rounded to TF32's 10-bit mantissa (products still
accumulate in float32), so the control runs in the tests too.
"""
from __future__ import annotations

import torch


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    i = x.detach().contiguous().view(torch.int32)
    r = ((i + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (r - x).detach()          # straight-through for autograd


class Precision:
    """A context that sets the TF32 switches for the block; `r(x)` is the
    operand rounding (identity unless TF32 is emulated)."""

    def __init__(self, mode: str, device):
        if mode not in ("fp32", "tf32"):
            raise ValueError(f"unknown precision {mode!r}")
        self.mode = mode
        self.emulate = mode == "tf32" and torch.device(device).type != "cuda"

    def __enter__(self):
        self._saved = (torch.backends.cuda.matmul.allow_tf32,
                       torch.backends.cudnn.allow_tf32)
        on = self.mode == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on
        return self

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self._saved
        return False

    def r(self, x: torch.Tensor) -> torch.Tensor:
        return _round_tf32(x) if self.emulate else x
