"""Streaming magnitude histogram (threshold top-k passes 1 and 2).

Replaces the Pallas TPU kernel `magnitude_hist` in
repro/kernels/magnitude_hist.py: counts_ge[j] = #{ |g| >= edges[j] } for
strictly positive, non-increasing edges. Route: CUDA C++
(`csrc/magnitude_hist.cu`, built for sm_90a by `_build`, bound with
ctypes).

Bound on an H100: one read of g — 4·d bytes in f32 (6.65 MB, about 2 us
at 3.35 TB/s, at the cnn width d = 1,663,370). The design places each
element once (a binary search into the edges held in shared memory, one
shared-memory atomicAdd into a per-block int32 histogram), flushes each
block's bins with one global atomicAdd per bin, and scans the bins into
counts_ge in a second one-warp kernel; it never builds the reference's
[block x n_edges] compare matrix. Counts are int32.

A CPU tensor goes through `ref.ref_magnitude_hist`; a CUDA tensor launches
the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import check_vector
from repro_torch.kernels.ref import ref_magnitude_hist

MAX_EDGES = 1024
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load_library("magnitude_hist")
    lib.repro_magnitude_hist.restype = ctypes.c_int
    lib.repro_magnitude_hist.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p]
    return lib


@functools.lru_cache(maxsize=None)
def _max_blocks(index: int) -> int:
    # a few resident 256-thread blocks per SM; the grid-stride loop covers
    # the rest of the vector
    return 8 * torch.cuda.get_device_properties(index).multi_processor_count


def magnitude_hist(g: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """counts_ge: int32[n_edges]; g flat [d] f32/bf16, edges flat f32
    non-increasing and positive, on the same device as g."""
    check_vector("magnitude_hist g", g)
    check_vector("magnitude_hist edges", edges, (torch.float32,),
                 device=g.device)
    n_edges = edges.numel()
    if not 1 <= n_edges <= MAX_EDGES:
        raise ValueError(f"magnitude_hist: {n_edges} edges, need 1..{MAX_EDGES}")
    if g.device.type == "cpu":
        return ref_magnitude_hist(g, edges)
    lib = _lib()
    bins = torch.zeros(n_edges, dtype=torch.int32, device=g.device)
    counts = torch.empty(n_edges, dtype=torch.int32, device=g.device)
    with torch.cuda.device(g.device):
        err = lib.repro_magnitude_hist(
            g.data_ptr(), g.numel(), _DTYPE_CODE[g.dtype], edges.data_ptr(),
            n_edges, bins.data_ptr(), counts.data_ptr(),
            _max_blocks(g.device.index or 0),
            torch.cuda.current_stream(g.device).cuda_stream)
    _build.check_cuda(lib, err, "magnitude_hist launch")
    magnitude_hist.launches += 1
    return counts


magnitude_hist.launches = 0
