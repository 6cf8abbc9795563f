"""Fixed-budget block compaction (the compact pod-sync wire format).

Replaces the Pallas TPU kernel `compact_blocks` in
repro/kernels/compact_topk.py. For a blocked EF accumulator acc [nb, blk]
and a threshold t, each block's |acc| >= t survivors are front-packed in
index order into `budget` slots:

    values   f32[nb, budget]   kept entries
    indices  i32[nb, budget]   shard-flat coordinates b·blk + offset
    counts   i32[nb]           kept-count header (<= budget)
    residual f32[nb, blk]      acc − shipped (EF carry, bitwise)

Padding slots carry (0.0, 0); survivors past the budget stay in the
residual and ship next round.

Route: CUDA C++ (`csrc/compact_blocks.cu`, built for sm_90a by `_build`,
bound with ctypes). One CTA of 128 threads per block, walked in
super-chunks of 1024 elements (one at the pod path's blk 1024); each
thread owns a contiguous run of 8 elements, loads it as two float4s,
counts its survivors, and one block-wide exclusive scan in thread order
(warp shuffles plus a scan of the warp totals, one barrier) gives each
survivor its slot (the TPU version's one-hot MXU dot has no place here);
a running count carries from one super-chunk to the next. A length that
is not a multiple of 4 or a row that is not 16-byte aligned takes the
same kernel with scalar loads. t is a device tensor, as in `ef_topk`.

Bound on an H100: one read of acc and one write of the residual plus the
payload — 6,728,388 bytes at the pod path's shard [813, 1024], budget 10
(2.0 us at 3.35 TB/s).

A CPU tensor goes through `ref.ref_compact_blocks`; a CUDA tensor launches
the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import kernel_op
from repro_torch.kernels.ref import ref_compact_blocks

_MAX_ELEMS = 2 ** 31   # indices are int32


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load_library("compact_blocks")
    lib.repro_compact_blocks.restype = ctypes.c_int
    lib.repro_compact_blocks.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p]
    return lib


def compact_blocks(acc: torch.Tensor, threshold: torch.Tensor | float, *,
                   budget: int):
    """Returns (values, indices, counts, residual) for acc [nb, blk] (cast
    to f32). `threshold` is a one-element f32 tensor on acc's device (or a
    Python float). `zeros(nb·blk).index_add_(0, indices.flatten(),
    values.flatten())` equals the shipped selection acc − residual."""
    if not isinstance(acc, torch.Tensor) or acc.dim() != 2:
        raise ValueError("compact_blocks acc: expected a [n_blocks, blk] "
                         f"tensor, got {getattr(acc, 'shape', type(acc))}")
    nb, blk = acc.shape
    if not 1 <= budget <= blk:
        raise ValueError(f"budget={budget} outside [1, blk={blk}]")
    if nb * blk >= _MAX_ELEMS:
        raise ValueError(f"compact_blocks: {nb}·{blk} elements, indices are "
                         f"int32 (need < 2^31)")
    if acc.device.type not in ("cpu", "cuda"):
        raise ValueError(f"compact_blocks: unsupported device {acc.device}")
    if not isinstance(threshold, torch.Tensor):
        threshold = torch.tensor(float(threshold), dtype=torch.float32,
                                 device=acc.device)
    if threshold.numel() != 1 or threshold.dtype != torch.float32 \
            or threshold.device != acc.device:
        raise ValueError("compact_blocks threshold: need one f32 value on "
                         f"{acc.device}, got {threshold.dtype} "
                         f"{tuple(threshold.shape)} on {threshold.device}")
    return _compact_blocks_op(acc.to(torch.float32).contiguous(), threshold,
                              budget)


def _compact_blocks_impl(acc: torch.Tensor, threshold: torch.Tensor,
                         budget: int) -> tuple[torch.Tensor, torch.Tensor,
                                               torch.Tensor, torch.Tensor]:
    if acc.device.type == "cpu":
        return ref_compact_blocks(acc, threshold, budget)
    nb, blk = acc.shape
    dev = acc.device
    vals = torch.empty((nb, budget), dtype=torch.float32, device=dev)
    idx = torch.empty((nb, budget), dtype=torch.int32, device=dev)
    cnt = torch.empty((nb,), dtype=torch.int32, device=dev)
    res = torch.empty_like(acc)
    if nb == 0:
        return vals, idx, cnt, res
    with torch.cuda.device(dev):
        _launch(acc, threshold, budget, (vals, idx, cnt, res),
                torch.cuda.current_stream(dev))
    return vals, idx, cnt, res


def _compact_blocks_fake(acc, threshold, budget):
    nb = acc.shape[0]
    return (acc.new_empty((nb, budget)),
            acc.new_empty((nb, budget), dtype=torch.int32),
            acc.new_empty((nb,), dtype=torch.int32), torch.empty_like(acc))


_compact_blocks_op = kernel_op("compact_blocks", _compact_blocks_impl,
                               _compact_blocks_fake)


def _launch(acc, threshold, budget: int, outs, stream) -> None:
    """One kernel launch on `stream` into outs = (vals, idx, cnt, res)."""
    lib = _lib()
    nb, blk = acc.shape
    vals, idx, cnt, res = outs
    err = lib.repro_compact_blocks(
        acc.data_ptr(), nb, blk, threshold.data_ptr(), budget,
        vals.data_ptr(), idx.data_ptr(), cnt.data_ptr(), res.data_ptr(),
        stream.cuda_stream)
    _build.check_cuda(lib, err, "compact_blocks launch")
    compact_blocks.launches += 1


compact_blocks.launches = 0
