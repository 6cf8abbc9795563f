"""Fused error-feedback threshold select (threshold top-k pass 3).

Replaces the Pallas TPU kernel `ef_topk` in repro/kernels/ef_topk.py:

    acc  = g + residual
    keep = |acc| >= t
    out  = acc · keep           (what ships to the server)
    r'   = acc − out            (what stays on the device)
    nnz  = #keep                (int32)

Route: Triton (an elementwise pass plus one count reduction). The TPU
kernel carries nnz across its sequential grid; blocks on the card run in
no order, so each program reduces its own block's count and adds it to one
int32 with `tl.atomic_add`. `t` is read from a device tensor, so the
threshold from `ops.solve_threshold` never visits the host. out + r' equals
g + r bitwise in f32.

Bound on an H100: 2 reads + 2 writes, 4·4·d bytes in f32 (26.6 MB, about
8 us at 3.35 TB/s at the cnn width d = 1,663,370). Each program streams
one contiguous block once; the count costs one atomic per program.

A CPU tensor goes through `ref.ref_ef_topk`; a CUDA tensor launches the
kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._common import check_vector
from repro_torch.kernels.ref import ref_ef_topk

BLOCK = 2048
_KERNEL = None


def _kernel():
    """Compile-on-first-use Triton kernel (triton is imported only here)."""
    global _KERNEL, tl
    if _KERNEL is None:
        import triton
        import triton.language as tl

        @triton.jit
        def ef_topk_kernel(g_ptr, r_ptr, t_ptr, out_ptr, res_ptr, nnz_ptr, n,
                           BLOCK: tl.constexpr):
            offs = tl.program_id(0).to(tl.int64) * BLOCK \
                + tl.arange(0, BLOCK)
            mask = offs < n
            acc = tl.load(g_ptr + offs, mask=mask, other=0.0).to(tl.float32) \
                + tl.load(r_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            t = tl.load(t_ptr)
            keep = (tl.abs(acc) >= t) & mask
            out = tl.where(keep, acc, 0.0)
            tl.store(out_ptr + offs, out.to(out_ptr.dtype.element_ty),
                     mask=mask)
            tl.store(res_ptr + offs, (acc - out).to(res_ptr.dtype.element_ty),
                     mask=mask)
            tl.atomic_add(nnz_ptr, tl.sum(keep.to(tl.int32), axis=0))

        _KERNEL = ef_topk_kernel
    return _KERNEL


def ef_topk(g: torch.Tensor, residual: torch.Tensor,
            threshold: torch.Tensor | float):
    """Returns (out [d] g.dtype, new_residual [d] residual.dtype,
    nnz int32 scalar tensor). `threshold` is a one-element f32 tensor on
    g's device (or a Python float)."""
    check_vector("ef_topk g", g)
    check_vector("ef_topk residual", residual, n=g.numel(), device=g.device)
    if not isinstance(threshold, torch.Tensor):
        threshold = torch.tensor(float(threshold), dtype=torch.float32,
                                 device=g.device)
    if threshold.numel() != 1 or threshold.dtype != torch.float32 \
            or threshold.device != g.device:
        raise ValueError("ef_topk threshold: need one f32 value on "
                         f"{g.device}, got {threshold.dtype} "
                         f"{tuple(threshold.shape)} on {threshold.device}")
    if g.device.type == "cpu":
        return ref_ef_topk(g, residual, threshold)
    n = g.numel()
    out = torch.empty_like(g)
    res = torch.empty_like(residual)
    nnz = torch.zeros((), dtype=torch.int32, device=g.device)
    if n:
        with torch.cuda.device(g.device):
            _kernel()[((n + BLOCK - 1) // BLOCK,)](
                g, residual, threshold.reshape(1).contiguous(), out, res, nnz,
                n, BLOCK=BLOCK, num_warps=4)
    ef_topk.launches += 1
    return out, res, nnz


ef_topk.launches = 0
