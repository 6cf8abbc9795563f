"""Fused error-feedback threshold select (threshold top-k pass 3).

Replaces the Pallas TPU kernel `ef_topk` in repro/kernels/ef_topk.py:

    acc  = g + residual
    keep = |acc| >= t
    out  = acc · keep           (what ships to the server)
    r'   = acc − out            (what stays on the device)
    nnz  = #keep                (int32)

Route: CUDA C++ (`csrc/ef_topk.cu`, built for sm_90a by `_build`, bound
with ctypes). One launch per call and no fill: each CTA adds its keep
count (register, warp reduction, shared memory) and a ticket to a zeroed
8-byte workspace in one 64-bit atomic, and the CTA that takes the last
ticket writes nnz and zeroes the workspace again. Each warp walks the
vector in quads of 4 elements (16 bytes of f32, 8 of bf16), every thread
loading all of its quads of g and r (evict-first: they are read once)
before it computes; the library sizes the grid from the card's SM count,
so the cnn vector is in flight in one wave. `t` is read from a device
tensor, so the threshold from `ops.solve_threshold` never visits the
host. out + r' equals g + r bitwise in f32.

Bound on an H100: 2 reads + 2 writes, 16 bytes per element in f32
(26,613,920 B, 7.94 us at 3.35 TB/s at the cnn width d = 1,663,370).

The wrapper keeps one workspace per (device, stream) in a
`_common.StreamWorkspaces`; a launch that returns an error discards it
before the wrapper raises. `quad_split` puts the scalars the quads cannot
take (a head up to the common quad boundary of g, r, out and r', and a
tail) around them; pointers whose phases differ make the whole vector
scalars, in the same kernel.

A CPU tensor goes through `ref.ref_ef_topk`; a CUDA tensor launches the
kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import (StreamWorkspaces, check_vector,
                                         kernel_op)
from repro_torch.kernels.ref import ref_ef_topk

QUAD = 4               # elements per quad (one vector access)
_MAX_ELEMS = 2 ** 31   # nnz is int32
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# one 64-bit word (keep count, done ticket), zero between calls
_WORKSPACES = StreamWorkspaces(2)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The kernel's library."""
    lib = _build.load_library("ef_topk")
    lib.repro_ef_topk.restype = ctypes.c_int
    lib.repro_ef_topk.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    return lib


def quad_split(ptrs, itemsizes, n: int) -> tuple[int, int, int]:
    """(head, nquad, tail) for n elements at each of the addresses `ptrs`
    (elements of `itemsizes` bytes): `head` scalars until every pointer is
    at a quad boundary (4 elements: 16 bytes of f32, 8 of bf16), `nquad`
    quads, then `tail` scalars (head, tail < 4). Where the pointers reach
    that boundary after different numbers of elements, no quad serves them
    all: (n, 0, 0), the whole vector as scalars."""
    heads = {(-p % (QUAD * s)) // s for p, s in zip(ptrs, itemsizes)}
    if len(heads) != 1:
        return n, 0, 0
    head = min(n, heads.pop())
    nquad = (n - head) // QUAD
    return head, nquad, n - head - nquad * QUAD


def _launch(g: torch.Tensor, residual: torch.Tensor,
            threshold: torch.Tensor, stream) -> tuple:
    """One kernel launch on `stream` (current on g's device); returns
    (out, new_residual, nnz)."""
    lib = _lib()
    n = g.numel()
    out = torch.empty_like(g)
    res = torch.empty_like(residual)
    nnz = torch.empty((), dtype=torch.int32, device=g.device)
    ws = _WORKSPACES.get(g.device, stream)
    tensors = (g, residual, out, res)
    head, nquad, _ = quad_split([x.data_ptr() for x in tensors],
                                [x.element_size() for x in tensors], n)
    err = lib.repro_ef_topk(
        g.data_ptr(), _DTYPE_CODE[g.dtype], residual.data_ptr(),
        _DTYPE_CODE[residual.dtype], threshold.data_ptr(), out.data_ptr(),
        res.data_ptr(), nnz.data_ptr(), n, head, nquad, ws.data_ptr(),
        g.device.index or 0, stream.cuda_stream)
    if err:
        # the launch never ran; drop the workspace rather than trust it
        _WORKSPACES.discard(g.device, stream)
    _build.check_cuda(lib, err, "ef_topk launch")
    ef_topk.launches += 1
    return out, res, nnz


def ef_topk(g: torch.Tensor, residual: torch.Tensor,
            threshold: torch.Tensor | float):
    """Returns (out [d] g.dtype, new_residual [d] residual.dtype,
    nnz int32 scalar tensor). g and residual are each f32 or bf16;
    `threshold` is a one-element f32 tensor on g's device (or a Python
    float)."""
    check_vector("ef_topk g", g)
    check_vector("ef_topk residual", residual, n=g.numel(), device=g.device)
    if g.numel() >= _MAX_ELEMS:
        raise ValueError(f"ef_topk: {g.numel()} elements, nnz is int32 "
                         f"(need < 2^31)")
    if not isinstance(threshold, torch.Tensor):
        threshold = torch.tensor(float(threshold), dtype=torch.float32,
                                 device=g.device)
    if threshold.numel() != 1 or threshold.dtype != torch.float32 \
            or threshold.device != g.device:
        raise ValueError("ef_topk threshold: need one f32 value on "
                         f"{g.device}, got {threshold.dtype} "
                         f"{tuple(threshold.shape)} on {threshold.device}")
    return _ef_topk_op(g, residual, threshold)


def _ef_topk_impl(g: torch.Tensor, residual: torch.Tensor,
                  threshold: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    if g.device.type == "cpu":
        return ref_ef_topk(g, residual, threshold)
    with torch.cuda.device(g.device):
        return _launch(g, residual, threshold,
                       torch.cuda.current_stream(g.device))


def _ef_topk_fake(g, residual, threshold):
    return (torch.empty_like(g), torch.empty_like(residual),
            g.new_empty((), dtype=torch.int32))


_ef_topk_op = kernel_op("ef_topk", _ef_topk_impl, _ef_topk_fake)


ef_topk.launches = 0
