"""Streaming magnitude histogram (threshold top-k passes 1 and 2).

Replaces the Pallas TPU kernel `magnitude_hist` in
repro/kernels/magnitude_hist.py: counts_ge[j] = #{ |g| >= edges[j] } for
strictly positive, non-increasing edges. Route: CUDA C++
(`csrc/magnitude_hist.cu`, built for sm_90a by `_build`, bound with
ctypes).

Bound on an H100: one read of g — 4·d bytes in f32 (6.65 MB, 1.99 us at
3.35 TB/s, at the cnn width d = 1,663,370; 0.99 us at a pod shard,
d = 832,512). One launch per call: the kernel binary-searches each element
into the edges held in shared memory, adds it to its lane's copy of the
CTA's bins (one conflict-free shared atomic per element), flushes each
CTA's bins to a zeroed int32 workspace with global atomics, and the CTA
that finishes last scans the bins into counts_ge and zeroes the workspace
again. g is read as 16-byte vectors (several in flight per thread) between
a scalar head and tail (`vector_split`); the library sizes the grid from
the card's SM count. Counts are int32; NaN never counts.

The wrapper keeps one workspace (MAX_EDGES + 1 int32, zeroed when it is
made) per (device, stream) in a `_common.StreamWorkspaces`, so calls on
different streams never share one. A launch that returns an error
discards its workspace before the wrapper raises.

A CPU tensor goes through `ref.ref_magnitude_hist`; a CUDA tensor launches
the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import (StreamWorkspaces, check_vector,
                                         kernel_op)
from repro_torch.kernels.ref import ref_magnitude_hist

MAX_EDGES = 1024
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
VEC_BYTES = 16          # bytes per vector load

# bins [0, MAX_EDGES) and a done counter, zero between calls
_WORKSPACES = StreamWorkspaces(MAX_EDGES + 1)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The kernel's library."""
    lib = _build.load_library("magnitude_hist")
    lib.repro_magnitude_hist.restype = ctypes.c_int
    lib.repro_magnitude_hist.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    return lib


def vector_split(ptr: int, n: int, itemsize: int) -> tuple[int, int, int]:
    """(head, nvec, tail) for n elements of `itemsize` bytes at address
    `ptr`: `head` scalars up to the first 16-byte boundary, `nvec` 16-byte
    vectors, then `tail` scalars (head, tail < 16 / itemsize)."""
    head = min(n, (-ptr % VEC_BYTES) // itemsize)
    nvec = (n - head) // (VEC_BYTES // itemsize)
    return head, nvec, n - head - nvec * (VEC_BYTES // itemsize)


def _launch(g: torch.Tensor, edges: torch.Tensor, stream) -> torch.Tensor:
    """One kernel launch on `stream` (current on g's device)."""
    lib = _lib()
    n_edges = edges.numel()
    ws = _WORKSPACES.get(g.device, stream)
    counts = torch.empty(n_edges, dtype=torch.int32, device=g.device)
    head, nvec, tail = vector_split(g.data_ptr(), g.numel(), g.element_size())
    err = lib.repro_magnitude_hist(
        g.data_ptr(), head, nvec, tail, _DTYPE_CODE[g.dtype],
        edges.data_ptr(), n_edges, ws.data_ptr(), counts.data_ptr(),
        g.device.index or 0, stream.cuda_stream)
    if err:
        # the launch never ran; drop the workspace rather than trust it
        _WORKSPACES.discard(g.device, stream)
    _build.check_cuda(lib, err, "magnitude_hist launch")
    magnitude_hist.launches += 1
    return counts


def magnitude_hist(g: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """counts_ge: int32[n_edges]; g flat [d] f32/bf16, edges flat f32
    non-increasing and positive, on the same device as g."""
    check_vector("magnitude_hist g", g)
    check_vector("magnitude_hist edges", edges, (torch.float32,),
                 device=g.device)
    n_edges = edges.numel()
    if not 1 <= n_edges <= MAX_EDGES:
        raise ValueError(f"magnitude_hist: {n_edges} edges, need 1..{MAX_EDGES}")
    return _magnitude_hist_op(g, edges)


def _magnitude_hist_impl(g: torch.Tensor, edges: torch.Tensor
                         ) -> torch.Tensor:
    if g.device.type == "cpu":
        return ref_magnitude_hist(g, edges)
    with torch.cuda.device(g.device):
        return _launch(g, edges, torch.cuda.current_stream(g.device))


def _magnitude_hist_fake(g, edges):
    return edges.new_empty(edges.shape, dtype=torch.int32)


_magnitude_hist_op = kernel_op("magnitude_hist", _magnitude_hist_impl,
                               _magnitude_hist_fake)


magnitude_hist.launches = 0
