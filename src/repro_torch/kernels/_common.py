"""Input checks and per-stream workspaces shared by the kernel wrappers."""
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


class StreamWorkspaces:
    """Zeroed int32 workspaces of `words` words, one per (device, stream),
    for kernels whose last CTA finishes a cross-CTA reduction and zeroes
    the workspace again (`magnitude_hist`, `ef_topk`). So a call needs no
    fill kernel, and calls on different streams never share one. A
    workspace is made zeroed on first use, with its stream current, so the
    fill is ordered before the first launch on it; a launch that returns
    an error `discard`s it rather than trust it."""

    def __init__(self, words: int):
        self.words = words
        self._ws: dict[tuple, torch.Tensor] = {}

    @staticmethod
    def key(device: torch.device, stream) -> tuple:
        return device.index, stream.cuda_stream

    def get(self, device: torch.device, stream) -> torch.Tensor:
        key = self.key(device, stream)
        ws = self._ws.get(key)
        if ws is None:
            ws = self._ws[key] = torch.zeros(self.words, dtype=torch.int32,
                                             device=device)
        return ws

    def discard(self, device: torch.device, stream) -> None:
        self._ws.pop(self.key(device, stream), None)

    def keys(self) -> list[tuple]:
        return list(self._ws)


def kernel_op(name: str, impl, fake, *, mutates_args=()):
    """`impl` (a wrapper's device dispatch: the plain version on the CPU,
    the kernel on a card) as the custom op `repro_torch::<name>`, with
    `fake` as its fake implementation. Under `FakeTensorMode` (the dry
    run) the op then allocates only what `fake` returns, the kernel's own
    outputs, and never runs the plain version's temporaries. Raises if
    the name is taken: some torch versions let `custom_op` replace a
    registered op's implementation without an error."""
    if hasattr(torch.ops.repro_torch, name):
        raise RuntimeError(f"kernel_op: repro_torch::{name} is already "
                           f"registered")
    op = torch.library.custom_op(f"repro_torch::{name}", impl,
                                 mutates_args=mutates_args)
    op.register_fake(fake)
    return op
