"""The port's kernel wrappers (run through their plain versions on the CPU)
against the JAX package's Pallas kernels in interpret mode, on the
reference's sweep (tests/test_kernels.py): d in {127, 1024, 8192, 40000},
f32 and bf16 inputs."""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.ef_topk import ef_topk as j_ef_topk  # noqa: E402
from repro.kernels.fused_momentum import fused_momentum as j_fused  # noqa: E402
from repro.kernels.magnitude_hist import magnitude_hist as j_hist  # noqa: E402

from repro_torch import resolve_device  # noqa: E402
from repro_torch.kernels import checks  # noqa: E402
from repro_torch.kernels._common import StreamWorkspaces  # noqa: E402
from repro_torch.kernels import ef_topk as ef_mod  # noqa: E402
from repro_torch.kernels import fused_momentum as fm_mod  # noqa: E402
from repro_torch.kernels import magnitude_hist as mh_mod  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

SHAPES = [127, 1024, 8192, 40_000]
DTYPES = ["float32", "bfloat16"]


def _g(d, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randn(d).astype(np.float32) * np.exp(rng.randn(d)).astype(
        np.float32)


def _pair(x: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch CPU tensor of `dtype`
    (both round f32 -> bf16 to nearest even). Each side gets its own copy:
    a CPU JAX array may alias the numpy buffer, and JAX runs
    asynchronously, so an in-place torch update must not reach it."""
    return (jnp.asarray(x.copy()).astype(getattr(jnp, dtype)),
            torch.tensor(x).to(getattr(torch, dtype)))


def _np32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _ulps(a: float, b: float) -> int:
    ia = np.asarray(a, np.float32).view(np.int32)
    ib = np.asarray(b, np.float32).view(np.int32)
    return abs(int(ia) - int(ib))


class TestMagnitudeHist:
    @pytest.mark.parametrize("d", SHAPES)
    @pytest.mark.parametrize("dtype", DTYPES)
    def test_vs_jax_kernel(self, d, dtype):
        jg, tg = _pair(_g(d, d), dtype)
        gmax = float(np.abs(_np32(tg)).max()) + 1e-30
        edges = (np.float32(gmax) * 2.0 ** -np.arange(33)).astype(np.float32)
        want = j_hist(jg, jnp.asarray(edges), block=2048, interpret=True)
        got = mh_mod.magnitude_hist(tg, torch.from_numpy(edges))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(want).astype(np.int64))

    def test_padding_does_not_count(self):
        jg, tg = _pair(_g(100, 1), "float32")
        edges = np.asarray([1e-20], np.float32)
        want = j_hist(jg, jnp.asarray(edges), block=2048, interpret=True)
        got = mh_mod.magnitude_hist(tg, torch.from_numpy(edges))
        assert int(got[0]) == int(want[0]) == 100


class TestEfTopk:
    @pytest.mark.parametrize("d", SHAPES)
    @pytest.mark.parametrize("dtype", DTYPES)
    def test_vs_jax_kernel_bitwise(self, d, dtype):
        jg, tg = _pair(_g(d, d), dtype)
        jr, tr = _pair(_g(d, d + 1) * 0.1, dtype)
        j_out, j_res, j_nnz = j_ef_topk(jg, jr, jnp.float32(0.5), block=2048,
                                        interpret=True)
        out, res, nnz = ef_mod.ef_topk(tg, tr, torch.tensor(0.5))
        assert out.dtype == tg.dtype and res.dtype == tr.dtype
        assert nnz.dtype == torch.int32 and int(nnz) == int(j_nnz)
        np.testing.assert_array_equal(_np32(out), _np32(j_out))
        np.testing.assert_array_equal(_np32(res), _np32(j_res))

    def test_conservation_bitwise(self):
        g, r = torch.from_numpy(_g(5000, 2)), torch.from_numpy(_g(5000, 3))
        out, res, _ = ef_mod.ef_topk(g, r * 0.2, 1.0)
        assert torch.equal(out + res, g + r * 0.2)


class TestFusedMomentum:
    @pytest.mark.parametrize("d", SHAPES)
    @pytest.mark.parametrize("dtype", DTYPES)
    def test_vs_jax_kernel(self, d, dtype):
        jw, tw = _pair(_g(d, 5), dtype)
        jmu, tmu = _pair(_g(d, 6), "float32")
        jgg, tgg = _pair(_g(d, 7), dtype)
        w2, mu2 = j_fused(jw, jmu, jgg, lr=0.1, momentum=0.9, block=2048,
                          interpret=True)
        rw, rmu = fm_mod.fused_momentum(tw, tmu, tgg, lr=0.1, momentum=0.9)
        assert rw is tw and rmu is tmu          # updated in place
        np.testing.assert_allclose(_np32(rw), _np32(w2), rtol=2e-5, atol=1e-6)
        np.testing.assert_allclose(_np32(rmu), _np32(mu2), rtol=2e-5,
                                   atol=1e-6)

    def test_in_place_on_a_leaf_that_requires_grad(self):
        w = torch.from_numpy(_g(300, 8)).requires_grad_(True)
        mu, g = torch.zeros(300), torch.from_numpy(_g(300, 9))
        before = w.detach().clone()
        fm_mod.fused_momentum(w.detach(), mu, g, lr=0.05, momentum=0.9)
        assert torch.equal(mu, g)
        torch.testing.assert_close(w.detach(), before - 0.05 * g,
                                   rtol=2e-5, atol=1e-6)


class TestPipeline:
    @pytest.mark.parametrize("rate", [0.001, 0.01, 0.1])
    @pytest.mark.parametrize("d", [10_000, 40_000])
    def test_solve_threshold_within_one_ulp(self, rate, d):
        """The fine edges hi − (hi−lo)·frac may be FMA-contracted on the
        XLA side and not in torch: t may differ by one ulp."""
        acc = _g(d, d + 3)
        k = max(1, round(rate * d))
        tj = float(jops.solve_threshold(jnp.asarray(acc), k, interpret=True))
        tt = float(ops.solve_threshold(torch.from_numpy(acc), k))
        assert _ulps(tj, tt) <= 1

    @pytest.mark.parametrize("rate", [0.01, 0.1])
    def test_topk_compress_masks_agree(self, rate):
        d = 40_000
        g, r = _g(d, 11), _g(d, 12) * 0.1
        jo, jres, jn, jt = jops.topk_compress(jnp.asarray(g), jnp.asarray(r),
                                              rate=rate, interpret=True)
        to, tres, tn, tt = ops.topk_compress(torch.from_numpy(g),
                                             torch.from_numpy(r), rate=rate)
        jm, tm = np.asarray(jo) != 0, to.numpy() != 0
        lo, hi = sorted((float(jt), float(tt)))
        mag = np.abs(g + r)
        differ = jm != tm
        assert np.all((mag[differ] >= lo) & (mag[differ] < hi))
        assert abs(int(tn) - int(jn)) == int(differ.sum())
        assert torch.equal(to + tres, torch.from_numpy(g) + torch.from_numpy(r))

    def test_compact_topk_round_trip_and_tie_order(self):
        dense = np.zeros(500, np.float32)
        dense[[3, 7, 11, 40]] = [2.0, -2.0, 2.0, 1.0]   # ties at |2|
        vals, idx = ops.compact_topk(torch.from_numpy(dense), 6)
        jv, ji = jops.compact_topk(jnp.asarray(dense), 6)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
        rebuilt = np.zeros(500, np.float32)
        np.add.at(rebuilt, idx.numpy(), vals.numpy())
        np.testing.assert_array_equal(rebuilt, dense)

    def test_momentum_update_is_the_fused_kernel(self):
        w, mu, g = (torch.from_numpy(_g(64, s)) for s in (1, 2, 3))
        jw, jmu = j_fused(jnp.asarray(_g(64, 1)), jnp.asarray(_g(64, 2)),
                          jnp.asarray(_g(64, 3)), lr=0.05, interpret=True)
        ops.momentum_update(w, mu, g, lr=0.05)
        np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=2e-5,
                                   atol=1e-6)


class TestDispatch:
    """A CPU tensor runs the plain version (and counts no launch); a CUDA
    request without a card raises; bad inputs raise."""

    @pytest.mark.parametrize("mod,fn,ref_name,args", [
        (ef_mod, "ef_topk", "ref_ef_topk",
         lambda: (torch.ones(8), torch.zeros(8), torch.tensor(0.5))),
        (mh_mod, "magnitude_hist", "ref_magnitude_hist",
         lambda: (torch.ones(8), torch.tensor([2.0, 0.5]))),
        (fm_mod, "fused_momentum", "ref_fused_momentum",
         lambda: (torch.ones(8), torch.zeros(8), torch.ones(8))),
    ])
    def test_cpu_tensor_takes_the_plain_version(self, monkeypatch, mod, fn,
                                                ref_name, args):
        calls = []
        real = getattr(mod, ref_name)

        def spy(*a, **kw):
            calls.append(1)
            return real(*a, **kw)
        monkeypatch.setattr(mod, ref_name, spy)
        wrapper = getattr(mod, fn)
        before = wrapper.launches
        kw = {"lr": 0.1} if fn == "fused_momentum" else {}
        wrapper(*args(), **kw)
        assert calls == [1]
        assert wrapper.launches == before

    def test_cuda_request_without_a_card_raises(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device("cuda")

    @pytest.mark.parametrize("bad", [
        lambda: torch.ones(4, 2),                    # not flat
        lambda: torch.ones(8, dtype=torch.float64),  # dtype
        lambda: torch.ones(16)[::2],                 # not contiguous
        lambda: torch.ones(9),                       # length mismatch
    ])
    def test_bad_inputs_raise(self, bad):
        with pytest.raises((ValueError, TypeError)):
            ef_mod.ef_topk(bad(), torch.zeros(8), 0.5)
        with pytest.raises((ValueError, TypeError)):
            fm_mod.fused_momentum(torch.ones(8), torch.zeros(8), bad(),
                                  lr=0.1)

    def test_edge_count_limit(self):
        with pytest.raises(ValueError):
            mh_mod.magnitude_hist(torch.ones(8), torch.ones(mh_mod.MAX_EDGES
                                                           + 1))


class _Stream:
    """Stands in for a torch.cuda.Stream: only its handle is read."""

    def __init__(self, handle):
        self.cuda_stream = handle


def _fake_lib(entry: str, err: int, calls: list):
    """A stand-in for a kernel's ctypes library: records each launch's
    arguments and returns `err`."""
    def launch(*args):
        calls.append(args)
        return err
    return types.SimpleNamespace(**{entry: launch},
                                 repro_cuda_error_string=lambda e: b"fake")


class TestMagnitudeHistPaths:
    """The plain version against the Pallas kernel where the one-launch
    CUDA kernel has its own code paths (a scalar head on views at storage
    offsets 1-3, a scalar tail on odd lengths, non-finite entries), and
    the wrapper's pure-Python launch geometry and workspace cache."""

    @pytest.mark.parametrize("off", [1, 2, 3])
    @pytest.mark.parametrize("dtype", DTYPES)
    def test_offset_views_vs_jax_kernel(self, off, dtype):
        x = _g(4097 + off, 40 + off)
        jg, _ = _pair(x[off:], dtype)
        tg = torch.tensor(x).to(getattr(torch, dtype))[off:]
        assert tg.storage_offset() == off
        edges = (np.float32(8.0) * 2.0 ** -np.arange(49)).astype(np.float32)
        want = j_hist(jg, jnp.asarray(edges), block=2048, interpret=True)
        got = mh_mod.magnitude_hist(tg, torch.from_numpy(edges))
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(want).astype(np.int64))

    @pytest.mark.parametrize("d", [1, 3, 4097])
    @pytest.mark.parametrize("dtype", DTYPES)
    def test_odd_lengths_vs_jax_kernel(self, d, dtype):
        jg, tg = _pair(_g(d, d + 50), dtype)
        edges = np.linspace(4.0, 0.01, 129).astype(np.float32)
        want = j_hist(jg, jnp.asarray(edges), block=2048, interpret=True)
        got = mh_mod.magnitude_hist(tg, torch.from_numpy(edges))
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(want).astype(np.int64))

    @pytest.mark.parametrize("dtype", DTYPES)
    def test_non_finite_vs_jax_kernel(self, dtype):
        """NaN never counts; +-Inf counts at every edge."""
        x = _g(5000, 60)
        x[[0, 77, 4999]] = np.nan
        x[[1, 2500]] = np.inf
        x[[3, 4998]] = -np.inf
        jg, tg = _pair(x, dtype)
        edges = (np.float32(1e30) * 2.0 ** -np.arange(120)).astype(np.float32)
        want = j_hist(jg, jnp.asarray(edges), block=2048, interpret=True)
        got = mh_mod.magnitude_hist(tg, torch.from_numpy(edges))
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(want).astype(np.int64))
        assert int(got[0]) == 4 and int(got[-1]) <= 5000 - 3

    @pytest.mark.parametrize("ptr,n,itemsize,want", [
        (0, 10, 4, (0, 2, 2)),
        (4, 10, 4, (3, 1, 3)),
        (8, 1, 4, (1, 0, 0)),
        (12, 4, 4, (1, 0, 3)),
        (2, 20, 2, (7, 1, 5)),
        (16, 0, 4, (0, 0, 0)),
        (64, 1_663_370, 4, (0, 415_842, 2)),
    ])
    def test_vector_split(self, ptr, n, itemsize, want):
        assert mh_mod.vector_split(ptr, n, itemsize) == want

    def test_vector_split_covers_and_aligns(self):
        rng = np.random.RandomState(0)
        for _ in range(500):
            itemsize = int(rng.choice([2, 4]))
            ptr = int(rng.randint(0, 64)) * itemsize
            n = int(rng.randint(0, 100))
            head, nvec, tail = mh_mod.vector_split(ptr, n, itemsize)
            per = mh_mod.VEC_BYTES // itemsize
            assert head + nvec * per + tail == n
            assert 0 <= head < per and 0 <= tail < per
            if nvec:
                assert (ptr + head * itemsize) % mh_mod.VEC_BYTES == 0

    def test_workspace_is_kept_per_device_and_stream(self, monkeypatch):
        monkeypatch.setattr(mh_mod, "_WORKSPACES",
                            StreamWorkspaces(mh_mod.MAX_EDGES + 1))
        ws = mh_mod._WORKSPACES
        cpu = torch.device("cpu")
        a = ws.get(cpu, _Stream(1))
        assert a.dtype == torch.int32 and a.numel() == mh_mod.MAX_EDGES + 1
        assert not a.any()
        assert ws.get(cpu, _Stream(1)) is a
        assert ws.get(cpu, _Stream(2)) is not a
        assert len(ws.keys()) == 2
        key = StreamWorkspaces.key
        assert key(torch.device("cuda", 0), _Stream(0)) \
            != key(torch.device("cuda", 1), _Stream(0))
        ws.discard(cpu, _Stream(1))
        assert ws.keys() == [(None, 2)]
        assert ws.get(cpu, _Stream(1)) is not a

    @pytest.mark.parametrize("err", [0, 700])
    def test_launch_arguments_and_failed_launch(self, monkeypatch, err):
        """What the wrapper hands the kernel (a view at offset 1: a 3-float
        head), and that a launch error discards the workspace and raises."""
        calls = []
        monkeypatch.setattr(mh_mod, "_WORKSPACES",
                            StreamWorkspaces(mh_mod.MAX_EDGES + 1))
        monkeypatch.setattr(mh_mod, "_lib", lambda: _fake_lib(
            "repro_magnitude_hist", err, calls))
        g = torch.ones(1000)[1:]
        edges = torch.tensor([2.0, 0.5])
        before = mh_mod.magnitude_hist.launches
        if err:
            with pytest.raises(RuntimeError, match="CUDA error 700"):
                mh_mod._launch(g, edges, _Stream(9))
            assert mh_mod._WORKSPACES.keys() == []
            assert mh_mod.magnitude_hist.launches == before
        else:
            counts = mh_mod._launch(g, edges, _Stream(9))
            assert counts.dtype == torch.int32 and counts.numel() == 2
            assert mh_mod._WORKSPACES.keys() == [(None, 9)]
            assert mh_mod.magnitude_hist.launches == before + 1
        (args,) = calls
        head, nvec, tail = mh_mod.vector_split(g.data_ptr(), 999, 4)
        assert args[1:5] == (head, nvec, tail, 0) and head == 3
        # edges, then the device index (the library sizes the grid from
        # its SM count) and the stream
        assert args[6] == 2 and args[9:] == (0, 9)



def _torch_of(x, dtype: str) -> torch.Tensor:
    """A JAX array as a torch CPU tensor of `dtype`, bit for bit."""
    a = np.asarray(x)
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.astype(np.float32))


DTYPE_PAIRS = [(a, b) for a in DTYPES for b in DTYPES]


class TestEfTopkPaths:
    """The plain version against the Pallas kernel where the one-launch
    CUDA kernel has its own code paths (the whole vector as scalars on
    views at storage offsets 1-3, a scalar tail on odd lengths, non-finite
    and signed-zero entries, t in {0, inf}, every pairing of f32 and bf16
    g and r), compared by bits (`checks.bits_equal`; a NaN matches a NaN,
    whose payload differs between the frameworks); and the wrapper's
    pure-Python split, argument packing and workspace."""

    @staticmethod
    def _vs_jax(xg, xr, gd, rd, t, tg=None, tr=None):
        """Both sides on the same values; JAX with one block of the whole
        vector when t = 0 (its zero padding would count as kept)."""
        jg, tg0 = _pair(xg, gd)
        jr, tr0 = _pair(xr, rd)
        tg = tg0 if tg is None else tg
        tr = tr0 if tr is None else tr
        block = xg.size if t == 0 else 2048
        j_out, j_res, j_nnz = j_ef_topk(jg, jr, jnp.float32(t), block=block,
                                        interpret=True)
        out, res, nnz = ef_mod.ef_topk(tg, tr, t)
        assert out.dtype == tg.dtype and res.dtype == tr.dtype
        assert nnz.dtype == torch.int32 and nnz.shape == ()
        assert int(nnz) == int(j_nnz)
        assert checks.bits_equal(out, _torch_of(j_out, gd), any_nan=True)
        assert checks.bits_equal(res, _torch_of(j_res, rd), any_nan=True)
        return out, res, nnz

    @pytest.mark.parametrize("off", [1, 2, 3])
    @pytest.mark.parametrize("gd,rd", DTYPE_PAIRS)
    def test_offset_views_vs_jax_kernel(self, off, gd, rd):
        xg, xr = _g(4097 + off, 70 + off), _g(4097 + off, 80 + off) * 0.1
        tg = torch.tensor(xg).to(getattr(torch, gd))[off:]
        tr = torch.tensor(xr).to(getattr(torch, rd))[off:]
        assert tg.storage_offset() == tr.storage_offset() == off
        self._vs_jax(xg[off:], xr[off:], gd, rd, 0.5, tg, tr)

    @pytest.mark.parametrize("d", [1, 3, 4097])
    @pytest.mark.parametrize("gd,rd", DTYPE_PAIRS)
    def test_odd_lengths_vs_jax_kernel(self, d, gd, rd):
        self._vs_jax(_g(d, d + 90), _g(d, d + 91) * 0.1, gd, rd, 0.5)

    @pytest.mark.parametrize("t", [0.5, 0.0, float("inf")])
    @pytest.mark.parametrize("gd,rd", DTYPE_PAIRS)
    def test_non_finite_vs_jax_kernel(self, t, gd, rd):
        """NaN is never kept; +-Inf is kept at a finite t and at t = inf,
        leaving r' = Inf - Inf = NaN; t = 0 keeps +-0 with its sign."""
        xg, xr = _g(5000, 95), _g(5000, 96) * 0.1
        xg[[0, 77, 4999]] = np.nan
        xg[[1, 2500]] = np.inf
        xg[[3, 4998]] = -np.inf
        xr[[5, 2500]] = -np.inf          # at 2500 Inf + -Inf: NaN
        xr[[6]] = np.nan
        xg[[10, 11]] = xr[[10, 11]] = 0.0
        xg[11] = xr[11] = -0.0
        out, res, nnz = self._vs_jax(xg, xr, gd, rd, t)
        o32, r32 = out.float(), res.float()
        for i in (0, 6, 77, 2500, 4999):     # NaN accumulators
            assert o32[i] == 0 and torch.isnan(r32[i])
        for i, sign in ((1, 1), (3, -1), (4998, -1), (5, -1)):
            assert o32[i] == sign * np.inf and torch.isnan(r32[i])
        kept_zero = 1 if t == 0 else 0
        assert int((o32[[10, 11]] == 0).sum()) == 2
        assert bool(torch.signbit(o32[11])) == bool(kept_zero)
        if t == np.inf:
            assert int(nnz) == 4

    @pytest.mark.parametrize("ptrs,sizes,n,want", [
        ((0, 0, 0, 0), (4, 4, 4, 4), 10, (0, 2, 2)),
        ((4, 4, 4, 4), (4, 4, 4, 4), 10, (3, 1, 3)),
        ((4, 4, 0, 0), (4, 4, 4, 4), 10, (10, 0, 0)),     # phases differ
        ((8, 8, 8, 8), (4, 4, 4, 4), 1, (1, 0, 0)),
        ((2, 4, 2, 4), (2, 4, 2, 4), 20, (3, 4, 1)),      # bf16 g, f32 r
        ((2, 4, 0, 0), (2, 4, 2, 4), 20, (20, 0, 0)),
        ((6, 6, 6, 6), (2, 2, 2, 2), 7, (1, 1, 2)),
        ((0, 0, 0, 0), (4, 4, 4, 4), 0, (0, 0, 0)),
        ((512, 1024, 0, 512), (4, 4, 4, 4), 1_663_370, (0, 415_842, 2)),
    ])
    def test_quad_split(self, ptrs, sizes, n, want):
        assert ef_mod.quad_split(ptrs, sizes, n) == want

    def test_quad_split_covers_and_aligns(self):
        rng = np.random.RandomState(0)
        for _ in range(1000):
            sizes = [int(rng.choice([2, 4])) for _ in range(4)]
            # aligned allocations, some at a shared element offset
            off = int(rng.randint(0, 8))
            ptrs = [int(rng.randint(0, 64)) * 64 + (off if rng.rand() < 0.8
                                                    else int(rng.randint(8)))
                    * s for s in sizes]
            n = int(rng.randint(0, 100))
            head, nquad, tail = ef_mod.quad_split(ptrs, sizes, n)
            assert head + nquad * ef_mod.QUAD + tail == n
            assert min(head, nquad, tail) >= 0
            phases = {(-p % (4 * s)) // s for p, s in zip(ptrs, sizes)}
            if len(phases) == 1:
                assert head < ef_mod.QUAD and tail < ef_mod.QUAD
                if nquad:
                    for p, s in zip(ptrs, sizes):
                        assert (p + head * s) % (ef_mod.QUAD * s) == 0
            else:
                assert (head, nquad, tail) == (n, 0, 0)

    @pytest.mark.parametrize("err", [0, 700])
    def test_launch_arguments_and_failed_launch(self, monkeypatch, err):
        """What the wrapper hands the kernel (bf16 g at offset 1 and f32
        r at offset 1: a 3-element head in both, but fresh outputs, so the
        whole vector as scalars), and that a launch error discards the
        workspace and raises."""
        calls = []
        monkeypatch.setattr(ef_mod, "_WORKSPACES", StreamWorkspaces(2))
        monkeypatch.setattr(ef_mod, "_lib", lambda: _fake_lib(
            "repro_ef_topk", err, calls))
        g = torch.ones(1000, dtype=torch.bfloat16)[1:]
        r = torch.zeros(1000)[1:]
        t = torch.tensor(0.5)
        before = ef_mod.ef_topk.launches
        if err:
            with pytest.raises(RuntimeError, match="CUDA error 700"):
                ef_mod._launch(g, r, t, _Stream(9))
            assert ef_mod._WORKSPACES.keys() == []
            assert ef_mod.ef_topk.launches == before
        else:
            out, res, nnz = ef_mod._launch(g, r, t, _Stream(9))
            assert out.dtype == torch.bfloat16 and res.dtype == torch.float32
            assert out.shape == res.shape == (999,)
            assert nnz.dtype == torch.int32 and nnz.shape == ()
            assert ef_mod._WORKSPACES.keys() == [(None, 9)]
            assert ef_mod.ef_topk.launches == before + 1
        (args,) = calls
        assert args[0] == g.data_ptr() and args[1] == 1
        assert args[2] == r.data_ptr() and args[3] == 0
        assert args[4] == t.data_ptr()
        # n, head, nquad: out and r' are fresh, so the phases differ and
        # the head is the whole vector
        assert args[8:11] == (999, 999, 0)
        # the workspace, then the device index (the library sizes the grid
        # from its SM count) and the stream
        assert args[12:] == (0, 9)

    def test_aligned_launch_takes_quads(self, monkeypatch):
        """Fresh g and r share the outputs' phase: a quad body."""
        calls = []
        monkeypatch.setattr(ef_mod, "_WORKSPACES", StreamWorkspaces(2))
        monkeypatch.setattr(ef_mod, "_lib", lambda: _fake_lib(
            "repro_ef_topk", 0, calls))
        g, r = torch.ones(4099), torch.ones(4099, dtype=torch.bfloat16)
        ef_mod._launch(g, r, torch.tensor(1.0), _Stream(1))
        (args,) = calls
        head, nquad, tail = ef_mod.quad_split(
            [g.data_ptr(), r.data_ptr(), args[5], args[6]], [4, 2, 4, 2],
            4099)
        assert args[8:11] == (4099, head, nquad) and nquad > 1000

    def test_too_long_raises(self, monkeypatch):
        """nnz is int32: the wrapper refuses 2^31 elements or more (here
        with the limit lowered to 8)."""
        monkeypatch.setattr(ef_mod, "_MAX_ELEMS", 8)
        ef_mod.ef_topk(torch.ones(7), torch.zeros(7), 0.5)
        with pytest.raises(ValueError, match="int32"):
            ef_mod.ef_topk(torch.ones(8), torch.zeros(8), 0.5)
