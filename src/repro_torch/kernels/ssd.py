"""Chunked SSD (Mamba-2's state-space duality, arXiv:2405.21060 §6):
forward and backward kernels behind one `torch.autograd.Function`.

Replaces no TPU kernel: the reference's `repro.models.mamba2.ssd_chunked`
is plain `jnp`, left to XLA's fusion. Added because its eager port
(`models.mamba2.ssd_einsum`) set much of the pace of the mamba2-780m pod
round on the H100: ~50 launches a layer's forward, [b, nc, H, Q, Q] fp32
decay matrices and their products in device memory (100 MB each at 2048
tokens, every layer, again in the backward), and several times these
kernels' device time for a layer's forward and backward (PERF.md §6).

Route: CUDA C++ (`csrc/ssd.cu`, built for sm_90a by `_build`, bound with
ctypes): 5 launches forward and 10 backward, two C calls. The source's
head has the algebra, the bound (fp32 FMA throughput, not bytes: every
product is plain fp32 `fmaf`, as the configurations run fp32 with TF32
off) and what the design does about it (64 x 64 register tiles, decays
made as operands are staged, the causal tile skip, no Q x Q matrix per
head in device memory, head splits for long inner dimensions).

Notation, per chunk of Q steps and head h: u_s = dt_s·x_s, A_q the
cumulative sum of dtA inside the chunk, G_qs = C_q·B_s, S_c the state
entering chunk c.

  y_q    = Σ_{s≤q} G_qs·exp(A_q − A_s)·u_s + exp(A_q)·S_c C_q
  S_c+1  = exp(A_last)·S_c + Σ_s exp(A_last − A_s)·u_s ⊗ B_s

The backward takes dA_q = dy_q·y_q − u_q·du_q (+ ⟨dS_c+1, S_c+1⟩ at the
chunk's last step), with y saved by the forward, and d(dtA) is the
reverse cumulative sum of dA inside each chunk. Saved for the backward:
the inputs, y, A ([b, H, S]) and the states entering each chunk ([b, nc,
H, P, N]); the rest is recomputed.

A CPU tensor takes the plain versions below (`*_plain`, one per kernel,
but dB's and dC's two kernels share one, and ⟨dS, S⟩, which the card's
ssd_bwd_da computes, comes from the reverse state pass's; their forward
and hand-derived backward are what the CPU tests hold against autograd
and `jax.vjp`); a CUDA tensor
launches the kernels or raises. The dispatch is the custom ops
`repro_torch::ssd_fwd` / `ssd_bwd` (`_common.kernel_op`), whose fake
versions allocate the outputs only. `ssd.launches` counts kernel launches
on the card.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import kernel_op

F32 = torch.float32


# ------------------------------------------------------------ plain versions
def _chunks(t: torch.Tensor, Q: int) -> torch.Tensor:
    """[b, S, ...] -> [b, nc, Q, ...]."""
    return t.reshape(t.shape[0], t.shape[1] // Q, Q, *t.shape[2:])


def _a(A: torch.Tensor, Q: int) -> torch.Tensor:
    """A [b, H, S] -> [b, nc, Q, H]."""
    b, H, S = A.shape
    return A.reshape(b, H, S // Q, Q).permute(0, 2, 3, 1)


def _decay(A: torch.Tensor, Q: int) -> torch.Tensor:
    """exp(A_q − A_s) for s ≤ q, else 0: [b, nc, H, Q, Q] (the plain
    versions' only; the kernels never write it)."""
    a = _a(A, Q).permute(0, 1, 3, 2)                       # [b,nc,H,Q]
    d = a[..., :, None] - a[..., None, :]
    keep = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=A.device))
    return torch.exp(d.masked_fill(~keep, -math.inf))


def _from_last(A: torch.Tensor, Q: int) -> torch.Tensor:
    """exp(A_last − A_s): [b, nc, Q, H]."""
    a = _a(A, Q)
    return torch.exp(a[:, :, -1:, :] - a)


def ssd_cumsum_plain(dtA: torch.Tensor, Q: int) -> torch.Tensor:
    """A: the cumulative sum of dtA [b, S, H] inside each chunk, [b, H, S]."""
    b, S, H = dtA.shape
    return torch.cumsum(_chunks(dtA.to(F32), Q), 2).permute(0, 3, 1, 2) \
        .reshape(b, H, S)


def ssd_bmm_plain(C: torch.Tensor, B: torch.Tensor, Q: int) -> torch.Tensor:
    """G = C_q·B_s per chunk: [b, nc, Q, Q]."""
    return torch.einsum("bcqn,bcsn->bcqs", _chunks(C, Q), _chunks(B, Q))


def ssd_chunk_state_plain(v: torch.Tensor, w: torch.Tensor, m: torch.Tensor,
                          Q: int) -> torch.Tensor:
    """Σ_s w_s·v_s ⊗ m_s per chunk and head: v [b, S, H, P], w [b, nc, Q,
    H], m [b, S, N] -> [b, nc, H, P, N]. Forward: v = x, w = dt·exp(A_last
    − A_s), m = B (the chunk's own state); backward: v = dy, w = exp(A_q),
    m = C (dS from the chunk's y_off)."""
    return torch.einsum("bcsh,bcshp,bcsn->bchpn", w, _chunks(v, Q),
                        _chunks(m, Q))


def ssd_state_pass_plain(states: torch.Tensor, A: torch.Tensor,
                         init: torch.Tensor | None, Q: int):
    """(the state entering each chunk [b, nc, H, P, N], the final state)."""
    b, nc, H, P, N = states.shape
    decay = torch.exp(_a(A, Q)[:, :, -1, :])                # [b,nc,H]
    carry = torch.zeros((b, H, P, N), dtype=F32, device=states.device) \
        if init is None else init.to(F32)
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * decay[:, c, :, None, None] + states[:, c]
    return torch.stack(prev, 1), carry


def ssd_chunk_scan_plain(x, dt, A, C, G, prev, Q: int) -> torch.Tensor:
    """y [b, S, H, P]: the causal G∘decay product plus exp(A_q)·S_c C_q."""
    b, S, H, P = x.shape
    u = _chunks(x * dt[..., None], Q)
    y = torch.einsum("bcqs,bchqs,bcshp->bcqhp", G, _decay(A, Q), u)
    y = y + torch.einsum("bcqn,bchpn->bcqhp", _chunks(C, Q), prev) \
        * torch.exp(_a(A, Q))[..., None]
    return y.reshape(b, S, H, P)


def ssd_state_pass_bwd_plain(dyoff, prev, final, A, dfinal, Q: int):
    """Reverse recurrence: (dS_c+1 per chunk [b, nc, H, P, N], ⟨dS_c+1,
    S_c+1⟩ [b, nc, H] (ssd_bwd_da's on the card), the initial state's
    gradient dS_0)."""
    b, nc, H, P, N = prev.shape
    decay = torch.exp(_a(A, Q)[:, :, -1, :])
    nxt = torch.cat([prev[:, 1:], final[:, None]], 1)
    g = torch.zeros_like(final) if dfinal is None else dfinal.to(F32)
    dstates, dd = [None] * nc, [None] * nc
    for c in reversed(range(nc)):
        dstates[c] = g
        dd[c] = (g * nxt[:, c]).sum((-1, -2))
        g = dyoff[:, c] + decay[:, c, :, None, None] * g
    return torch.stack(dstates, 1), torch.stack(dd, 1), g


def ssd_chunk_scan_bwd_dx_plain(x, dt, A, B, G, dy, y, dstates, Q: int):
    """(dx, d(dt), dA before the ⟨dS, S⟩ term and the cumulative sum [b, S,
    H]) from du = (G∘decay)ᵀ dy + exp(A_last − A_s)·B_s dS_c+1ᵀ: dA_q =
    dy_q·y_q − dt_q·d(dt)_q."""
    b, S, H, P = x.shape
    M = G[:, :, None] * _decay(A, Q)                        # [b,nc,H,Q,Q]
    du = torch.einsum("bchqs,bcqhp->bcshp", M, _chunks(dy, Q))
    du = du + torch.einsum("bcsn,bchpn->bcshp", _chunks(B, Q), dstates) \
        * _from_last(A, Q)[..., None]
    du = du.reshape(b, S, H, P)
    ddt = (du * x).sum(-1)
    return du * dt[..., None], ddt, (dy * y).sum(-1) - dt * ddt


def ssd_bwd_dcb_plain(x, dt, A, dy, Q: int) -> torch.Tensor:
    """dG [b, nc, Q, Q] = Σ_h decay^h ∘ (dy_q·u_s)."""
    u = _chunks(x * dt[..., None], Q)
    return (torch.einsum("bcqhp,bcshp->bchqs", _chunks(dy, Q), u)
            * _decay(A, Q)).sum(2)


def ssd_bwd_dbc_plain(x, dt, A, B, C, dG, dy, prev, dstates, Q: int):
    """(dB, dC [b, S, N]): the states' parts, split over heads on the card,
    plus dG's."""
    b, S, N = B.shape
    a = _a(A, Q)
    t = torch.einsum("bcqhp,bchpn->bcqhn", _chunks(dy, Q), prev) \
        * torch.exp(a)[..., None]
    dC = t.sum(3) + torch.einsum("bcqs,bcsn->bcqn", dG, _chunks(B, Q))
    tb = torch.einsum("bcshp,bchpn->bcshn", _chunks(x * dt[..., None], Q),
                      dstates) * _from_last(A, Q)[..., None]
    dB = tb.sum(3) + torch.einsum("bcqs,bcqn->bcsn", dG, _chunks(C, Q))
    return dB.reshape(b, S, N), dC.reshape(b, S, N)


def ssd_bwd_da_plain(da, dd, Q: int) -> torch.Tensor:
    """d(dtA) [b, S, H]: the reverse cumulative sum inside each chunk of
    dA (`da`, [b, S, H]) with ⟨dS, S⟩ added at the chunk's last step."""
    b, S, H = da.shape
    dA = _chunks(da, Q).clone()
    dA[:, :, -1, :] += dd
    return dA.flip(2).cumsum(2).flip(2).reshape(b, S, H)


def ssd_fwd_plain(x, dtA, dt, B, C, init, Q: int):
    """(y, final state, A, the state entering each chunk)."""
    x, dt, B, C = (t.to(F32) for t in (x, dt, B, C))
    A = ssd_cumsum_plain(dtA, Q)
    G = ssd_bmm_plain(C, B, Q)
    st = ssd_chunk_state_plain(x, _chunks(dt, Q) * _from_last(A, Q), B, Q)
    prev, final = ssd_state_pass_plain(st, A, init, Q)
    return ssd_chunk_scan_plain(x, dt, A, C, G, prev, Q), final, A, prev


def ssd_bwd_plain(x, dt, B, C, A, prev, final, y, dy, dfinal, Q: int):
    """(dx, d(dtA), d(dt), dB, dC, d(initial state))."""
    x, dt, B, C, y, dy = (t.to(F32) for t in (x, dt, B, C, y, dy))
    G = ssd_bmm_plain(C, B, Q)
    dyoff = ssd_chunk_state_plain(dy, torch.exp(_a(A, Q)), C, Q)
    dstates, dd, dinit = ssd_state_pass_bwd_plain(dyoff, prev, final, A,
                                                  dfinal, Q)
    dx, ddt, da = ssd_chunk_scan_bwd_dx_plain(x, dt, A, B, G, dy, y,
                                              dstates, Q)
    dG = ssd_bwd_dcb_plain(x, dt, A, dy, Q)
    dB, dC = ssd_bwd_dbc_plain(x, dt, A, B, C, dG, dy, prev, dstates, Q)
    return dx, ssd_bwd_da_plain(da, dd, Q), ddt, dB, dC, dinit


# -------------------------------------------------------------------- kernels
# csrc/ssd.cu's settings: the side of a block's output tile (T), the state
# elements of a state pass's block (NE), the longest chunk (QMAX), the most
# heads of a split (MAXH) and the int32s of `Dims`
TILE, STATE_BLOCK, MAX_CHUNK, MAX_SPLIT_HEADS, N_DIMS = 64, 256, 256, 16, 33
# blocks per SM that the head splits of ssd_bwd_dcb and ssd_bwd_dbc aim
# at (one wave of either at mamba2-780m's and granite's shapes)
SPLIT_BLOCKS_PER_SM = 4


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The kernels' library. The first call builds every CUDA source of
    the package that has no library yet, all together (a pod round uses
    the sync's kernels too), so a cold checkout waits for one nvcc."""
    _build.build()
    lib = _build.load_library("ssd")
    dims = ctypes.POINTER(ctypes.c_int)
    for fn, n_ptrs in ((lib.repro_ssd_fwd, 12), (lib.repro_ssd_bwd, 21)):
        fn.restype = ctypes.c_int
        fn.argtypes = [dims] + [ctypes.c_void_p] * n_ptrs
    return lib


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _split(target: int, work: int, H: int) -> tuple[int, int]:
    """(splits, heads per split) of H heads, so that `work` blocks per
    split make about `target` blocks, at most MAX_SPLIT_HEADS heads each."""
    want = min(H, max(1, _cdiv(target, work)))
    per = min(_cdiv(H, want), MAX_SPLIT_HEADS)
    return _cdiv(H, per), per


def _dims(x, dy, dt, dtA, B, C, Q: int, splits=(0, 0, 0, 0)):
    """csrc/ssd.cu's `Dims`: shapes, element strides, the backward's head
    splits and the state passes' blocks per (b, h). The kernels index in
    int32: raises where a tensor they touch holds 2**31 elements or more,
    or a stride reaches 2**31."""
    b, S, H, P = x.shape
    N = B.shape[-1]
    vals = (b, S, H, P, N, Q, S // Q, _cdiv(Q, TILE), *x.stride(),
            *dy.stride(), *dt.stride(), *dtA.stride(), *B.stride(),
            *C.stride(), *splits, _cdiv(P * N, STATE_BLOCK))
    assert len(vals) == N_DIMS
    big = max(b * S * H * P, b * H * S // Q * P * N,
              (max(splits[0], splits[2]) + 1) * b * S * max(Q, N), *vals)
    if big >= 2 ** 31:
        raise ValueError(f"ssd: {big} elements or a stride over int32")
    return (ctypes.c_int * N_DIMS)(*vals)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _fwd_cuda(x, dtA, dt, B, C, init, Q: int, stream: int, lib=None):
    """The forward's 5 launches on `stream`: (y, final, A, the state
    entering each chunk)."""
    lib = _lib() if lib is None else lib
    b, S, H, P = x.shape
    N, nc = B.shape[-1], S // Q
    new = lambda *shape: torch.empty(shape, dtype=F32, device=x.device)
    A, G, st = new(b, H, S), new(b, nc, Q, Q), new(b, nc, H, P, N)
    final, y = new(b, H, P, N), new(b, S, H, P)
    err = lib.repro_ssd_fwd(
        _dims(x, x, dt, dtA, B, C, Q), *map(_ptr, (
            x, dtA, dt, B, C, init, A, G, st, final, y)), stream)
    _build.check_cuda(lib, err, "ssd forward launch")
    ssd.launches += 5
    return y, final, A, st


def _bwd_cuda(x, dt, B, C, A, prev, final, y, dy, dfinal, Q: int,
              stream: int, sms: int, lib=None):
    """The backward's 10 launches on `stream` (`sms` SMs): (dx, d(dtA),
    d(dt), dB, dC, d(initial state))."""
    lib = _lib() if lib is None else lib
    b, S, H, P = x.shape
    N, nc, nt = B.shape[-1], S // Q, _cdiv(Q, TILE)
    target = SPLIT_BLOCKS_PER_SM * sms
    hs, hps = _split(target, b * nc * nt * (nt + 1) // 2, H)
    ks, kps = _split(target, b * nc * nt * _cdiv(N, TILE), H)
    new = lambda *shape: torch.empty(shape, dtype=F32, device=x.device)
    scratch = (new(b, nc, Q, Q), new(b, nc, H, P, N), new(hs, b, nc, Q, Q),
               new(ks + 1, b, nc, Q, N))
    dx, ddtA, ddt = new(b, S, H, P), new(b, S, H), new(b, S, H)
    dB, dC, dinit = new(b, S, N), new(b, S, N), new(b, H, P, N)
    err = lib.repro_ssd_bwd(
        _dims(x, dy, dt, dt, B, C, Q, (hs, hps, ks, kps)), *map(_ptr, (
            x, dt, B, C, A, prev, final, y, dy, dfinal, *scratch, dx, ddtA,
            ddt, dB, dC, dinit)), stream)
    _build.check_cuda(lib, err, "ssd backward launch")
    ssd.launches += 10
    return dx, ddtA, ddt, dB, dC, dinit


# ---------------------------------------------------------------- dispatch
def _ssd_fwd_impl(x: torch.Tensor, dtA: torch.Tensor, dt: torch.Tensor,
                  B: torch.Tensor, C: torch.Tensor,
                  init: Optional[torch.Tensor], chunk: int
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    if x.device.type == "cpu":
        y, final, A, prev = ssd_fwd_plain(x, dtA, dt, B, C, init, chunk)
        return y, final, A.contiguous(), prev
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        return _fwd_cuda(x, dtA, dt, B, C, init, chunk, stream)


def _ssd_fwd_fake(x, dtA, dt, B, C, init, chunk):
    b, S, H, P = x.shape
    N = B.shape[-1]
    new = lambda *shape: x.new_empty(shape, dtype=F32)
    return (new(b, S, H, P), new(b, H, P, N), new(b, H, S),
            new(b, S // chunk, H, P, N))


def _ssd_bwd_impl(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
                  C: torch.Tensor, A: torch.Tensor, prev: torch.Tensor,
                  final: torch.Tensor, y: torch.Tensor, dy: torch.Tensor,
                  dfinal: Optional[torch.Tensor], chunk: int
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor, torch.Tensor, torch.Tensor]:
    if x.device.type == "cpu":
        return ssd_bwd_plain(x, dt, B, C, A, prev, final, y, dy, dfinal,
                             chunk)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        return _bwd_cuda(x, dt, B, C, A, prev, final, y, dy, dfinal, chunk,
                         stream, sms)


def _ssd_bwd_fake(x, dt, B, C, A, prev, final, y, dy, dfinal, chunk):
    b, S, H, P = x.shape
    N = B.shape[-1]
    new = lambda *shape: x.new_empty(shape, dtype=F32)
    return (new(b, S, H, P), new(b, S, H), new(b, S, H), new(b, S, N),
            new(b, S, N), new(b, H, P, N))


_ssd_fwd_op = kernel_op("ssd_fwd", _ssd_fwd_impl, _ssd_fwd_fake)
_ssd_bwd_op = kernel_op("ssd_bwd", _ssd_bwd_impl, _ssd_bwd_fake)


class _SSD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dtA, dt, B, C, init, chunk):
        y, final, A, prev = _ssd_fwd_op(x, dtA, dt, B, C, init, chunk)
        ctx.save_for_backward(x, dt, B, C, A, prev, final, y)
        ctx.chunk, ctx.has_init = chunk, init is not None
        ctx.set_materialize_grads(False)
        return y, final

    @staticmethod
    def backward(ctx, dy, dfinal):
        x, dt, B, C, A, prev, final, y = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        dx, ddtA, ddt, dB, dC, dinit = _ssd_bwd_op(
            x, dt, B, C, A, prev, final, y, dy,
            None if dfinal is None else dfinal.contiguous(), ctx.chunk)
        return dx, ddtA, ddt, dB, dC, dinit if ctx.has_init else None, None


def ssd(xh: torch.Tensor, dtA: torch.Tensor, dtx_scale: torch.Tensor,
        Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int,
        initial_state: torch.Tensor | None = None):
    """`models.mamba2.ssd_chunked`'s function (same arguments and
    results: y [b, S, H, P], final state [b, H, P, N], both fp32) through
    the kernels on a card and their plain versions on the CPU; its
    gradients are the hand-derived backward's. Raises on shapes that
    disagree, a sequence that is no multiple of the chunk, or on a card a
    chunk over MAX_CHUNK."""
    b, S, H, P = xh.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"sequence {S} is not a multiple of chunk {Q}")
    if Q > MAX_CHUNK and xh.is_cuda:
        raise ValueError(f"ssd: chunk {Q} > {MAX_CHUNK}, which the kernels "
                         f"hold in shared memory")
    if dtA.shape != (b, S, H) or dtx_scale.shape != (b, S, H) \
            or Bm.shape != (b, S, N) or Cm.shape != (b, S, N):
        raise ValueError(f"ssd: shapes {tuple(xh.shape)}, "
                         f"{tuple(dtA.shape)}, {tuple(dtx_scale.shape)}, "
                         f"{tuple(Bm.shape)}, {tuple(Cm.shape)} disagree")
    init = None if initial_state is None \
        else initial_state.to(F32).contiguous()
    if init is not None and init.shape != (b, H, P, N):
        raise ValueError(f"ssd: initial state {tuple(init.shape)}")
    return _SSD.apply(xh.to(F32), dtA.to(F32), dtx_scale.to(F32),
                      Bm.to(F32), Cm.to(F32), init, Q)


ssd.launches = 0
