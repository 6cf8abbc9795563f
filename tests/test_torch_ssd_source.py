"""`kernels/csrc/ssd.cu` built for the CPU and held to the plain versions.

No CUDA compiler runs here, so the source is compiled with g++ against a
small stand-in for CUDA's launch model: a launch runs its blocks one after
another, a block's threads as std::threads that meet at a std::barrier in
`__syncthreads`, `__shared__` variables are function statics (one block at
a time shares them), and `kernel<<<grid, block, smem, stream>>>(args)` is
rewritten into a call of `stub_launch`. The source uses no warp intrinsics
for that reason. The C entry points are then driven through `ssd.py`'s own
wrappers (`_fwd_cuda`, `_bwd_cuda`) with CPU tensors, so the kernels'
indexing, masking, tiling, head splits and shared-memory staging are
checked on every run; only the card can check speed, registers and what
nvcc itself refuses (`tests/test_torch_ssd.py`, chip_smoke's `ssd` phase).
"""
import ctypes
import re
import shutil
import subprocess

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ssd as K  # noqa: E402
from repro_torch.models import mamba2 as M  # noqa: E402

STUB = r"""
#pragma once
#include <barrier>
#include <cmath>
#include <cstring>
#include <thread>
#include <vector>
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct float4 { float x, y, z, w; };
inline thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;
inline std::barrier<>* stub_barrier;
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
#define __shared__ static
#define __align__(n) alignas(n)
inline void __syncthreads() { stub_barrier->arrive_and_wait(); }
typedef void* cudaStream_t;
typedef int cudaError_t;
constexpr int cudaErrorInvalidValue = 1;
inline int cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(int) { return "stub"; }
template <class F>
void stub_launch(dim3 g, dim3 b, F f) {
  const unsigned nt = b.x * b.y * b.z;
  std::barrier<> bar(nt);
  stub_barrier = &bar;
  std::vector<std::thread> threads;
  for (unsigned t = 0; t < nt; ++t)
    threads.emplace_back([&, t] {
      blockDim = b;
      gridDim = g;
      threadIdx = dim3(t % b.x, (t / b.x) % b.y, t / (b.x * b.y));
      for (unsigned z = 0; z < g.z; ++z)
        for (unsigned y = 0; y < g.y; ++y)
          for (unsigned x = 0; x < g.x; ++x) {
            blockIdx = dim3(x, y, z);
            f();
            bar.arrive_and_wait();
          }
    });
  for (auto& th : threads) th.join();
}
"""


def _closing(text: str, i: int, open_: str, close: str) -> int:
    """The index of the bracket closing the one at text[i]."""
    depth = 0
    for j in range(i, len(text)):
        depth += (text[j] == open_) - (text[j] == close)
        if depth == 0:
            return j
    raise ValueError("unbalanced brackets")


def _top_level_split(text: str) -> list[str]:
    parts, depth, cur = [], 0, ""
    for ch in text:
        depth += (ch in "(<[{") - (ch in ")>]}")
        if ch == "," and depth == 0:
            parts.append(cur)
            cur = ""
        else:
            cur += ch
    return parts + [cur]


def for_cpu(src: str) -> str:
    """csrc/ssd.cu with the stand-in header and every launch rewritten."""
    src = src.replace("#include <cuda_runtime.h>", '#include "stub.h"')
    out, i = "", 0
    while (j := src.find("<<<", i)) >= 0:
        k = j
        while src[k - 1].isspace():
            k -= 1
        if src[k - 1] == ">":                  # a template's arguments
            depth = 0
            while True:
                k -= 1
                depth += (src[k] == ">") - (src[k] == "<")
                if depth == 0:
                    break
        name_at = re.search(r"[\w:]+\s*$", src[:k]).start()
        name = src[name_at:j].strip()
        e = src.index(">>>", j)
        grid, block = _top_level_split(src[j + 3:e])[:2]
        args_end = _closing(src, e + 3, "(", ")")
        out += (src[i:name_at] + f"stub_launch(dim3({grid}), dim3({block}), "
                f"[&] {{ {name}({src[e + 4:args_end]}); }})")
        i = args_end + 1
    return out + src[i:]


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the CUDA source for the CPU")
    d = tmp_path_factory.mktemp("ssd_cpu")
    (d / "stub.h").write_text(STUB)
    (d / "ssd.cpp").write_text(for_cpu((_build.CSRC / "ssd.cu").read_text()))
    so = d / "libssd_cpu.so"
    subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
                    f"-I{d}", "-o", str(so), str(d / "ssd.cpp")],
                   check=True, capture_output=True, timeout=300)
    out = ctypes.CDLL(str(so))
    for fn, n_ptrs in ((out.repro_ssd_fwd, 12), (out.repro_ssd_bwd, 21)):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.POINTER(ctypes.c_int)] + \
            [ctypes.c_void_p] * n_ptrs
    return out


def _rel(a, b):
    return ((a.double() - b.double()).norm()
            / b.double().norm().clamp_min(1e-30)).item()


# (b, S, H, P, N, chunk, initial state, SMs): several chunks with partial
# 64-wide tiles, a ragged chunk (Q = S, no multiple of 16), P and N wider
# than one tile, and 20 heads on one SM, so the head splits hold 16 and 4
CASES = [(2, 96, 3, 8, 4, 32, True, 132), (1, 64, 2, 32, 16, 64, False, 132),
         (1, 30, 2, 8, 16, 30, False, 132),
         (1, 200, 2, 72, 70, 100, True, 132),
         (1, 64, 20, 8, 4, 32, True, 1)]


@pytest.mark.parametrize("case", CASES)
def test_source_matches_plain_versions(lib, case):
    """y, the final state, A, the states entering each chunk and every
    gradient against the plain versions, with x given through a strided
    view. Relative L2 1e-5: fp32 sums in another order (tiles, splits,
    block scans); the largest reading was 3.3e-6 (a final state)."""
    b, S, H, P, N, chunk, initial, sms = case
    Q = min(chunk, S)
    g = torch.Generator().manual_seed(0)
    rn = lambda *s: torch.randn(s, generator=g)
    dt = torch.nn.functional.softplus(rn(b, S, H) - 1.0)
    A = -torch.exp(rn(H) * 0.5)
    ins = [rn(b, S + 3, H, P)[:, 3:], dt * A, dt, rn(b, S, N), rn(b, S, N),
           rn(b, H, P, N) if initial else None]
    dy, dfin = rn(b, S, H, P), rn(b, H, P, N)
    fwd = K._fwd_cuda(*ins, Q, 0, lib=lib)
    want_fwd = K.ssd_fwd_plain(*ins, Q)
    for what, got, want in zip(("y", "final", "A", "prev"), fwd, want_fwd):
        assert _rel(got, want) < 1e-5, what
    y, fin, A_cum, prev = fwd
    grads = K._bwd_cuda(ins[0], ins[2], ins[3], ins[4], A_cum, prev, fin, y,
                        dy, dfin, Q, 0, sms, lib=lib)
    py, pfin, pA, pprev = want_fwd
    want = K.ssd_bwd_plain(ins[0], ins[2], ins[3], ins[4], pA, pprev, pfin,
                           py, dy, dfin, Q)
    names = ("dx", "d(dtA)", "d(dt)", "dB", "dC", "d(init)")
    for what, got, w in zip(names, grads, want):
        if what != "d(init)" or initial:
            assert _rel(got, w) < 1e-5, what


def test_source_gradients_match_float64_autograd(lib):
    """The same source's gradients against float64 autograd through the
    port's einsum chain: the hand-derived backward, not only its plain
    version, is the function's."""
    b, S, H, P, N, Q = 1, 96, 3, 16, 8, 32
    g = torch.Generator().manual_seed(1)
    rn = lambda *s: torch.randn(s, generator=g)
    dt = torch.nn.functional.softplus(rn(b, S, H) - 1.0)
    ins = [rn(b, S, H, P), dt * -torch.exp(rn(H) * 0.5), dt, rn(b, S, N),
           rn(b, S, N), rn(b, H, P, N)]
    dy, dfin = rn(b, S, H, P), rn(b, H, P, N)
    y, fin, A_cum, prev = K._fwd_cuda(*ins, Q, 0, lib=lib)
    grads = K._bwd_cuda(ins[0], ins[2], ins[3], ins[4], A_cum, prev, fin, y,
                        dy, dfin, Q, 0, 132, lib=lib)
    leaves = [t.double().requires_grad_(True) for t in ins]
    ey, efin = M.ssd_einsum(*leaves[:5], chunk=Q, initial_state=leaves[5])
    torch.autograd.backward([ey, efin], [dy.double(), dfin.double()])
    assert _rel(y, ey) < 1e-5 and _rel(fin, efin) < 1e-5
    for what, got, leaf in zip(("dx", "d(dtA)", "d(dt)", "dB", "dC",
                                "d(init)"), grads, leaves):
        assert _rel(got, leaf.grad) < 1e-5, what
