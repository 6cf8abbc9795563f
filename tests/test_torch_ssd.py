"""The chunked SSD kernels (`kernels/csrc/ssd.cu`, behind `kernels/ssd.py`)
against their plain versions on a CUDA card: the forward (y, final state)
and the gradients of xh, dtA, dt, B and C (and of the initial state where
one is given), fp32 with TF32 off, at mamba2-780m's and
granite-4.0-h-micro's widths, hymba's state of 16 and a ragged chunk (S <
chunk, so Q = S is no power of two).

Marked `card`: skipped without a card (this file imports no JAX, so it
runs on the card as `python -m pytest -m card tests/test_torch_ssd.py`). The plain versions' algebra is held on the CPU
in `test_torch_lm_modules.py`.
"""
import pytest

torch = pytest.importorskip("torch")

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
    assert K.ssd.launches - launches == 15
    py, pfin, pA, pprev = K.ssd_fwd_plain(*ins, Q)
    want = [py, pfin, *K.ssd_bwd_plain(ins[0], ins[2], ins[3], ins[4], pA,
                                       pprev, pfin, py, dy, dfin, Q)]
    got = [y, fin] + [t.grad for t in leaves[:5]] \
        + [leaves[5].grad if initial else want[-1]]
    names = ("y", "final", "dx", "d(dtA)", "d(dt)", "dB", "dC", "d(init)")
    for what, a, w in zip(names, got, want):
        err = ((a.double() - w.double()).norm() / w.double().norm()).item()
        assert err < TOL, (what, err)
