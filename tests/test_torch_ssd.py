"""The chunked SSD kernels (`kernels/csrc/ssd.cu`, behind `kernels/ssd.py`)
against their plain versions on a CUDA card: the forward (y, final state)
and the gradients of xh, dtA, dt, B and C (and of the initial state where
one is given), fp32 with TF32 off, at mamba2-780m's and
granite-4.0-h-micro's widths, hymba's state of 16 and a ragged chunk (S <
chunk, so Q = S is no power of two), in exactly 5 + 9 launches; and nvcc's
report of the source: no kernel spills a register.

Marked `card`: skipped without a card (this file imports no JAX, so it
runs on the card as `python -m pytest -m card tests/test_torch_ssd.py`). The plain versions' algebra is held on the CPU
in `test_torch_lm_modules.py`.
"""
import re
import subprocess

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ssd as K  # noqa: E402

# (b, S, H, P, N, chunk, initial state)
CASES = {"mamba2-780m": (1, 2048, 48, 64, 128, 256, False),
         "granite-4.0-h-micro": (1, 4096, 64, 64, 128, 256, False),
         "hymba N 16": (1, 512, 50, 64, 16, 256, True),
         "ragged S 100": (2, 100, 3, 64, 128, 256, True)}
# relative L2 against the plain version, both fp32 on the card: the
# kernels sum in another order (products over up to H·P = 4096 terms for
# dB and dC, split over heads) and A's cumulative sum rounds otherwise
# than torch.cumsum, which every exp(A_q − A_s) carries; ~1e-6 is typical
TOL = 1e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


@pytest.mark.card
@pytest.mark.parametrize("name", list(CASES))
def test_kernels_match_plain_version(card, name):
    b, S, H, P, N, chunk, initial = CASES[name]
    Q = min(chunk, S)
    g = torch.Generator(device=card).manual_seed(0)
    rn = lambda *s: torch.randn(s, generator=g, device=card)
    dt = torch.nn.functional.softplus(rn(b, S, H) - 1.0)
    A = -torch.exp(rn(H) * 0.5)
    ins = [rn(b, S, H, P), dt * A, dt, rn(b, S, N), rn(b, S, N),
           rn(b, H, P, N) if initial else None]
    dy, dfin = rn(b, S, H, P), rn(b, H, P, N)
    leaves = [None if t is None else t.clone().requires_grad_(True)
              for t in ins]
    launches = K.ssd.launches
    y, fin = K.ssd(*leaves[:5], chunk=chunk, initial_state=leaves[5])
    torch.autograd.backward([y, fin], [dy, dfin])
    assert K.ssd.launches - launches == 14
    py, pfin, pA, pprev = K.ssd_fwd_plain(*ins, Q)
    want = [py, pfin, *K.ssd_bwd_plain(ins[0], ins[2], ins[3], ins[4], pA,
                                       pprev, pfin, py, dy, dfin, Q)]
    got = [y, fin] + [t.grad for t in leaves[:5]] \
        + [leaves[5].grad if initial else want[-1]]
    names = ("y", "final", "dx", "d(dtA)", "d(dt)", "dB", "dC", "d(init)")
    for what, a, w in zip(names, got, want):
        err = ((a.double() - w.double()).norm() / w.double().norm()).item()
        assert err < TOL, (what, err)


def ptxas_report(tmp_path) -> dict[str, tuple[int, int, int]]:
    """{mangled name: (registers, spill stores, spill loads)} of every
    kernel in csrc/ssd.cu, from the build's ptxas report (nvcc's stderr
    under -Xptxas -v), or from a build of its own into tmp_path where this
    process loaded a library built before it."""
    K._lib()
    log = _build.BUILD_LOG.get("ssd")
    if log is None:
        log = subprocess.run(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o",
             str(tmp_path / "ssd.so"), str(_build.CSRC / "ssd.cu")],
            capture_output=True, text=True, check=True).stderr
    out = {}
    for part in log.split("Compiling entry function '")[1:]:
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", part)
        regs = re.search(r"Used (\d+) registers", part)
        out[part.split("'")[0]] = (int(regs.group(1)), int(spill.group(1)),
                                   int(spill.group(2)))
    return out


@pytest.mark.card
def test_no_kernel_spills(card, tmp_path):
    """ptxas places every ssd_* kernel's values in registers: 0 bytes of
    spill stores and loads, for each of the source's 13 kernels."""
    rep = {k: v for k, v in ptxas_report(tmp_path).items() if "ssd_" in k}
    assert len(rep) == 13, sorted(rep)
    spills = {k: v for k, v in rep.items() if v[1] or v[2]}
    assert not spills, spills
