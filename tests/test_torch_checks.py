"""The kernel checks of `chip_smoke.py`: `repro_torch.kernels.checks`
against the JAX package's threshold solve and Pallas histogram (interpret
mode), and that each check fails when the package's wrapper is wrong; and
`_build`'s library names. No card is needed."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.magnitude_hist import magnitude_hist as j_hist  # noqa: E402

from repro_torch.kernels import _build, checks, ref  # noqa: E402
from repro_torch.kernels import compact_topk as ct_mod  # noqa: E402
from repro_torch.kernels import ef_topk as ef_mod  # noqa: E402
from repro_torch.kernels import magnitude_hist as mh_mod  # noqa: E402
from repro_torch.kernels.compact_topk import compact_blocks  # noqa: E402
from repro_torch.kernels.ef_topk import ef_topk  # noqa: E402
from repro_torch.kernels.magnitude_hist import magnitude_hist  # noqa: E402


def _ulps(a: float, b: float) -> int:
    ia = np.array(a, dtype=np.float32).view(np.int32)
    ib = np.array(b, dtype=np.float32).view(np.int32)
    return abs(int(ia) - int(ib))


class TestVec:
    @pytest.mark.parametrize("d", [1, 127, 4097])
    def test_seeded_heavy_tailed_f32(self, d):
        a, b = checks.vec(d, 3, "cpu"), checks.vec(d, 3, "cpu")
        assert a.dtype == torch.float32 and a.shape == (d,)
        assert torch.equal(a, b)
        assert not torch.equal(a, checks.vec(d, 4, "cpu")) or d == 1

    def test_is_the_numpy_recipe(self):
        rng = np.random.RandomState(9)
        x = rng.randn(50).astype(np.float32) * np.exp(rng.randn(50)).astype(
            np.float32)
        np.testing.assert_array_equal(checks.vec(50, 9, "cpu").numpy(), x)


class TestBitsEqual:
    @pytest.mark.parametrize("a,b,want", [
        ([1.0, 2.0], [1.0, 2.0], True),
        ([0.0], [-0.0], False),                 # equal as floats, not bits
        ([float("nan")], [float("nan")], True),  # one canonical NaN
        ([1.0, 2.0], [1.0, 2.5], False),
        ([1.0, 2.0], [[1.0, 2.0]], False),      # shapes differ
    ])
    def test_cases(self, a, b, want):
        assert checks.bits_equal(torch.tensor(a), torch.tensor(b)) is want

    def test_non_contiguous(self):
        x = torch.arange(12, dtype=torch.float32).view(3, 4)
        assert checks.bits_equal(x.t(), x.t().contiguous())

    @pytest.mark.parametrize("a,b,want", [
        ([1.0, 2.0, 3.0], [1.0, 2.0, 3.0], True),   # odd length
        ([0.0], [-0.0], False),
        ([1.0, 2.0], [1.0, 2.015625], False),        # one bf16 ulp
    ])
    def test_bf16_by_its_16_bits(self, a, b, want):
        ta = torch.tensor(a, dtype=torch.bfloat16)
        tb = torch.tensor(b, dtype=torch.bfloat16)
        assert checks.bits_equal(ta, tb) is want

    def test_dtypes_differ(self):
        assert not checks.bits_equal(torch.ones(2),
                                     torch.ones(2, dtype=torch.bfloat16))

    @pytest.mark.parametrize("dtype,bits,nan_a,nan_b", [
        (torch.float32, torch.int32, 0x7FC00000, -0x400000),   # sign differs
        (torch.float32, torch.int32, 0x7FC00000, 0x7FFFFFFF),  # payload
        (torch.bfloat16, torch.int16, 0x7FC0, -1),             # 0xFFFF
    ])
    def test_any_nan(self, dtype, bits, nan_a, nan_b):
        """Two NaN patterns differ by bits and match with `any_nan`; the
        other entries are still compared by bits."""
        a = torch.tensor([1.0, 0.0, 0.0], dtype=dtype)
        b = a.clone()
        a.view(bits)[1], b.view(bits)[1] = nan_a, nan_b
        assert not checks.bits_equal(a, b)
        assert checks.bits_equal(a, b, any_nan=True)
        b[2] = -0.0
        assert not checks.bits_equal(a, b, any_nan=True)
        b[2], b[1] = 0.0, 1.0                     # NaN against a number
        assert not checks.bits_equal(a, b, any_nan=True)


class TestCheckHist:
    @pytest.mark.parametrize("d", [127, 40_000])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_edges_and_threshold_match_jax(self, d, dtype):
        """The check's edges are the JAX solve's, its counts the Pallas
        kernel's, and its threshold within one ulp of the JAX solve's."""
        g = checks.vec(d, d, "cpu").to(dtype)
        k = max(1, round(0.01 * d))
        coarse, fine, t = checks.check_hist(g, "cpu")
        assert coarse.shape == (49,) and fine.shape == (129,)
        jg = jnp.asarray(g.float().numpy())
        gmax = jnp.max(jnp.abs(jg)) + 1e-30
        jcoarse = gmax * 2.0 ** (-jnp.arange(49, dtype=jnp.float32))
        np.testing.assert_array_equal(coarse.numpy(), np.asarray(jcoarse))
        for e in (coarse, fine):
            want = j_hist(jg, jnp.asarray(e.numpy()), block=2048,
                          interpret=True)
            np.testing.assert_array_equal(
                magnitude_hist(g, e).numpy(),
                np.asarray(want).astype(np.int64))
        tj = float(jops.solve_threshold(jg, k, interpret=True))
        assert _ulps(float(t), tj) <= 1

    @pytest.mark.parametrize("broken", [0, 1])
    def test_fails_on_a_wrong_pass(self, broken, monkeypatch):
        """A histogram off by one in either pass is caught."""
        seen = []

        def hist(g, e):
            c = ref.ref_magnitude_hist(g, e)
            seen.append(1)
            return c + 1 if len(seen) - 1 == broken else c
        monkeypatch.setattr(mh_mod, "magnitude_hist", hist)
        with pytest.raises(checks.CheckFailed,
                           match=("coarse", "fine")[broken]):
            checks.check_hist(checks.vec(1000, 1, "cpu"), "x")


class TestCheckCompact:
    def test_plain_version_agrees(self):
        acc = checks.vec(4 * 256, 5, "cpu").view(4, 256)
        t = acc.abs().median() * 2
        assert checks.check_compact(acc, t, 8, "cpu") == 0.0

    @pytest.mark.parametrize("which", [0, 1, 2, 3])
    def test_fails_on_a_wrong_output(self, which, monkeypatch):
        def compact(acc, t, *, budget):
            outs = list(compact_blocks(acc, t, budget=budget))
            outs[which] = outs[which].clone()
            outs[which].view(-1)[0] += 1
            return tuple(outs)
        monkeypatch.setattr(ct_mod, "compact_blocks", compact)
        acc = checks.vec(2 * 64, 6, "cpu").view(2, 64)
        with pytest.raises(checks.CheckFailed,
                           match=("vals", "idx", "cnt", "res")[which]):
            checks.check_compact(acc, 0.0, 4, "x")

    def test_fails_on_the_sign_of_zero(self, monkeypatch):
        """Bitwise, not by value: a residual of -0.0 where the plain
        version has +0.0 is a difference."""
        def compact(acc, t, *, budget):
            vals, idx, cnt, res = compact_blocks(acc, t, budget=budget)
            return vals, idx, cnt, torch.where(res == 0, -0.0, res)
        monkeypatch.setattr(ct_mod, "compact_blocks", compact)
        acc = checks.vec(2 * 64, 7, "cpu").view(2, 64)
        with pytest.raises(checks.CheckFailed, match="res"):
            checks.check_compact(acc, 0.0, 4, "x")


class TestCheckEf:
    @pytest.mark.parametrize("gd", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("rd", [torch.float32, torch.bfloat16])
    def test_plain_version_agrees(self, gd, rd):
        g = checks.vec(3001, 1, "cpu").to(gd)
        r = (checks.vec(3001, 2, "cpu") * 0.1).to(rd)
        g[[5, 6]], r[7] = float("nan"), float("inf")
        for t in (0.5, 0.0, float("inf"), torch.tensor(1.0)):
            assert checks.check_ef(g, r, t, "cpu") == 0.0

    @pytest.mark.parametrize("which", [0, 1, 2])
    def test_fails_on_a_wrong_output(self, which, monkeypatch):
        def ef(g, r, t):
            outs = list(ef_topk(g, r, t))
            outs[which] = outs[which].clone()
            outs[which].view(-1)[0] += 1
            return tuple(outs)
        monkeypatch.setattr(ef_mod, "ef_topk", ef)
        g = checks.vec(500, 3, "cpu")
        with pytest.raises(checks.CheckFailed,
                           match=("out", "residual", "nnz")[which]):
            checks.check_ef(g, g * 0.1, 0.5, "x")

    def test_fails_on_the_sign_of_zero(self, monkeypatch):
        """Bitwise, not by value: a residual of -0.0 where the plain
        version has +0.0 is a difference."""
        def ef(g, r, t):
            out, res, nnz = ef_topk(g, r, t)
            return out, torch.where(res == 0, -0.0, res), nnz
        monkeypatch.setattr(ef_mod, "ef_topk", ef)
        g = checks.vec(500, 4, "cpu")
        with pytest.raises(checks.CheckFailed, match="residual"):
            checks.check_ef(g, torch.zeros(500), 0.0, "x")

    def test_fails_on_a_nan_payload(self, monkeypatch):
        """NaN is compared by its bits: another NaN pattern in r' is a
        difference."""
        def ef(g, r, t):
            out, res, nnz = ef_topk(g, r, t)
            res = res.clone()
            res.view(torch.int32)[torch.isnan(res)] = 0x7FFFFFFF
            return out, res, nnz
        g = checks.vec(500, 5, "cpu")
        g[9] = float("nan")
        want = ref.ref_ef_topk(g, torch.zeros(500), torch.tensor(0.5))[1]
        assert want.view(torch.int32)[9] != 0x7FFFFFFF
        monkeypatch.setattr(ef_mod, "ef_topk", ef)
        with pytest.raises(checks.CheckFailed, match="residual"):
            checks.check_ef(g, torch.zeros(500), 0.5, "x")

    def test_fails_on_a_wrong_dtype(self, monkeypatch):
        def ef(g, r, t):
            out, res, nnz = ef_topk(g, r, t)
            return out, res, nnz.to(torch.int64)
        monkeypatch.setattr(ef_mod, "ef_topk", ef)
        g = checks.vec(100, 6, "cpu")
        with pytest.raises(checks.CheckFailed, match="nnz"):
            checks.check_ef(g, g, 0.5, "x")


def _hist_wrong(g, e):
    return magnitude_hist(g, e) + 1


def _compact_wrong(acc, t, *, budget):
    vals, idx, cnt, res = compact_blocks(acc, t, budget=budget)
    return vals, idx, cnt + 1, res


def _ef_wrong(g, r, t):
    out, res, nnz = ef_topk(g, r, t)
    return out, res, nnz + 1


# (module, wrapper, a wrong wrapper, the check's call)
WRONG = {
    "hist": (mh_mod, "magnitude_hist", _hist_wrong,
             lambda: checks.check_hist(checks.vec(500, 2, "cpu"), "x")),
    "compact": (ct_mod, "compact_blocks", _compact_wrong,
                lambda: checks.check_compact(
                    checks.vec(4 * 64, 3, "cpu").view(4, 64), 0.5, 4, "x")),
    "ef": (ef_mod, "ef_topk", _ef_wrong,
           lambda: checks.check_ef(checks.vec(77, 7, "cpu"),
                                   checks.vec(77, 8, "cpu"), 0.5, "x")),
}


@pytest.mark.parametrize("which", list(WRONG))
def test_checks_call_the_package_wrapper(which, monkeypatch):
    """Each check calls the package's wrapper, not the plain version on
    both sides: the check passes with the wrapper as it is and raises
    once the wrapper is replaced by a wrong one."""
    mod, name, wrong, check = WRONG[which]
    check()
    calls = []

    def spy(*a, **k):
        calls.append(1)
        return wrong(*a, **k)
    monkeypatch.setattr(mod, name, spy)
    with pytest.raises(checks.CheckFailed):
        check()
    assert calls


@pytest.mark.parametrize("name", _build.CUDA_SOURCES)
def test_library_named_by_a_hash_of_source_and_flags(name, tmp_path,
                                                     monkeypatch):
    """One library per source, in BUILD_DIR, named by a hash of the source
    and the flags: the same across calls, another once one byte of the
    source changes."""
    src, so = _build._target(name)
    assert src == _build.CSRC / f"{name}.cu" and src.is_file()
    assert so.parent == _build.BUILD_DIR and so.name.startswith(f"lib{name}_")
    assert _build._target(name) == (src, so)
    copy = tmp_path / src.name
    copy.write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert _build._target(name) == (copy, so)
    text = bytearray(copy.read_bytes())
    text[-1] ^= 1
    copy.write_bytes(bytes(text))
    other = _build._target(name)[1]
    assert other != so and other.parent == _build.BUILD_DIR
