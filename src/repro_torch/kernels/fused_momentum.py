"""Fused momentum-SGD update, in place on a flat parameter buffer.

Replaces the Pallas TPU kernel `fused_momentum` in
repro/kernels/fused_momentum.py:

    mu' = momentum · mu + g
    w'  = w − lr · mu'

Route: Triton (one elementwise streaming pass). Unlike the TPU kernel,
which returns new arrays, this one updates `w` and `mu` in place — they
are its outputs as well as inputs — so a local step allocates nothing and
the flat buffer the model's parameters view stays the same tensor.

Floating-point contraction is off for this kernel (`enable_fp_fusion=
False`): each multiply and add rounds on its own, as in the reference and
the plain version, so the kernel matches the plain version bitwise — in
bf16 as well, where one f32 ulp could flip a rounding.

Bound on an H100: 3 reads + 2 writes, 5·4·d bytes in f32 (33.3 MB, about
10 us at 3.35 TB/s at the cnn width d = 1,663,370). Each program streams
one contiguous block of all three vectors once and writes both results;
nothing else touches memory.

A CPU tensor goes through `ref.ref_fused_momentum` (then copied into the
inputs, to keep the in-place contract); a CUDA tensor launches the kernel
or raises. The dispatch is the custom op `repro_torch::fused_momentum`
(`_common.kernel_op`), whose fake implementation writes nothing and
allocates nothing: the dry run's `FakeTensorMode` counts the kernel's
memory, not the plain version's temporaries.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._common import check_vector, kernel_op
from repro_torch.kernels.ref import ref_fused_momentum

BLOCK = 2048
_KERNEL = None


def _kernel():
    """Compile-on-first-use Triton kernel (triton is imported only here, so
    the module imports on machines without it)."""
    global _KERNEL, tl
    if _KERNEL is None:
        import triton
        import triton.language as tl

        @triton.jit
        def fused_momentum_kernel(w_ptr, mu_ptr, g_ptr, n, lr, momentum,
                                  BLOCK: tl.constexpr):
            offs = tl.program_id(0).to(tl.int64) * BLOCK \
                + tl.arange(0, BLOCK)
            mask = offs < n
            w = tl.load(w_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            mu = tl.load(mu_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            g = tl.load(g_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            mu = momentum * mu + g
            w = w - lr * mu
            tl.store(mu_ptr + offs, mu.to(mu_ptr.dtype.element_ty), mask=mask)
            tl.store(w_ptr + offs, w.to(w_ptr.dtype.element_ty), mask=mask)

        _KERNEL = fused_momentum_kernel
    return _KERNEL


def _fused_momentum_impl(w: torch.Tensor, mu: torch.Tensor,
                         g: torch.Tensor, lr: float, momentum: float) -> None:
    if w.device.type == "cpu":
        w_new, mu_new = ref_fused_momentum(w, mu, g, lr=lr, momentum=momentum)
        w.copy_(w_new)
        mu.copy_(mu_new)
        return
    n = w.numel()
    if n:
        with torch.cuda.device(w.device):
            _kernel()[((n + BLOCK - 1) // BLOCK,)](
                w, mu, g, n, lr, momentum, BLOCK=BLOCK,
                num_warps=4, enable_fp_fusion=False)
    fused_momentum.launches += 1


def _fused_momentum_fake(w, mu, g, lr, momentum) -> None:
    return None


_fused_momentum_op = kernel_op("fused_momentum", _fused_momentum_impl,
                               _fused_momentum_fake, mutates_args=("w", "mu"))


def fused_momentum(w: torch.Tensor, mu: torch.Tensor, g: torch.Tensor, *,
                   lr: float, momentum: float = 0.9):
    """Update flat [d] `w` and `mu` in place; returns (w, mu)."""
    check_vector("fused_momentum w", w)
    check_vector("fused_momentum mu", mu, n=w.numel(), device=w.device)
    check_vector("fused_momentum g", g, n=w.numel(), device=w.device)
    with torch.no_grad():
        _fused_momentum_op(w, mu, g, float(lr), float(momentum))
    return w, mu


fused_momentum.launches = 0
