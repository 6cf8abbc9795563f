"""The port's `compact_blocks` (on the CPU, its plain version) and the ops
built on it against the JAX package: `compact_blocks(..., interpret=True)`
bit for bit on the reference's sweep (tests/test_kernels.py), the scatter
rebuild property, `compact_shard_topk` and `topk_compress_sparse`; and
`kernels._common.kernel_op`, which registers each wrapper's op once."""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.compact_topk import compact_blocks as j_compact  # noqa: E402

from repro_torch.kernels import compact_topk as ct_mod  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

NAMES = ("vals", "idx", "cnt", "res")


def _acc(nb, blk, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(nb, blk).astype(np.float32)
            * np.exp(rng.randn(nb, blk).astype(np.float32)))


def _assert_bitwise(got, want):
    for g_, w_, name in zip(got, want, NAMES):
        g_, w_ = g_.numpy(), np.asarray(w_)
        assert g_.dtype == w_.dtype and g_.shape == w_.shape, name
        np.testing.assert_array_equal(g_.view(np.uint32 if g_.dtype ==
                                              np.float32 else g_.dtype),
                                      w_.view(np.uint32 if w_.dtype ==
                                              np.float32 else w_.dtype),
                                      err_msg=name)


@pytest.mark.parametrize("nb,blk", [(1, 128), (8, 64), (12, 256)])
@pytest.mark.parametrize("budget", [1, 5, 32])
def test_vs_jax_kernel_bitwise(nb, blk, budget):
    acc = _acc(nb, blk, nb * blk + budget)
    t = np.float32(np.median(np.abs(acc)) * 2)
    want = j_compact(jnp.asarray(acc), jnp.float32(t), budget=budget,
                     interpret=True)
    got = ct_mod.compact_blocks(torch.from_numpy(acc), torch.tensor(t),
                                budget=budget)
    _assert_bitwise(got, want)
    # and the port's plain version against the JAX oracle
    _assert_bitwise(ref.ref_compact_blocks(torch.from_numpy(acc),
                                           torch.tensor(t), budget),
                    jref.ref_compact_blocks(jnp.asarray(acc), t, budget))


@pytest.mark.parametrize("threshold", [0.0, np.inf])
def test_degenerate_thresholds(threshold):
    nb, blk, budget = 4, 64, 8
    acc = _acc(nb, blk, 3)
    got = ct_mod.compact_blocks(torch.from_numpy(acc), threshold,
                                budget=budget)
    want = j_compact(jnp.asarray(acc), jnp.float32(threshold), budget=budget,
                     interpret=True)
    _assert_bitwise(got, want)
    vals, idx, cnt, res = got
    if threshold == 0.0:     # every block overflows: the first `budget`
        assert (cnt.numpy() == budget).all()
        np.testing.assert_array_equal(vals.numpy(), acc[:, :budget])
    else:                    # nothing ships, residual == acc
        assert (cnt.numpy() == 0).all()
        np.testing.assert_array_equal(res.numpy(), acc)
        assert not vals.any() and not idx.any()


def test_scatter_reconstructs_shipped_selection():
    """zeros.index_add_(idx, vals) == acc − residual (padding slots are
    (0.0, 0) no-ops), and indices are shard-flat."""
    nb, blk, budget = 8, 128, 6
    acc = torch.from_numpy(_acc(nb, blk, 17))
    t = float(np.quantile(np.abs(acc.numpy()), 0.95))
    vals, idx, cnt, res = ct_mod.compact_blocks(acc, t, budget=budget)
    rebuilt = torch.zeros(nb * blk).index_add_(0, idx.reshape(-1).long(),
                                               vals.reshape(-1))
    assert torch.equal(rebuilt.view(nb, blk), acc - res)
    live = torch.arange(budget)[None, :] < cnt[:, None]
    blocks = idx // blk
    assert torch.equal(blocks[live], live.nonzero()[:, 0].to(torch.int32))


def test_shard_pipeline_matches_jax():
    """compact_shard_topk == JAX's ops.compact_shard_topk bit for bit, and
    == solve_threshold + compact_blocks."""
    nb, blk, rate = 8, 256, 0.0625
    budget = max(1, min(blk, round(rate * blk)))
    acc = _acc(nb, blk, 29)
    want = jops.compact_shard_topk(jnp.asarray(acc), budget=budget,
                                   interpret=True)
    got = ops.compact_shard_topk(torch.from_numpy(acc), budget=budget)
    _assert_bitwise(got, want)
    t = ops.solve_threshold(torch.from_numpy(acc).reshape(-1), nb * budget)
    _assert_bitwise(got, ct_mod.compact_blocks(torch.from_numpy(acc), t,
                                               budget=budget))


@pytest.mark.parametrize("rate", [0.01, 0.1])
def test_topk_compress_sparse_matches_jax(rate):
    d = 20_000
    rng = np.random.RandomState(5)
    g = rng.randn(d).astype(np.float32)
    r = (rng.randn(d) * 0.1).astype(np.float32)
    jv, ji, jres, jnnz, jt = jops.topk_compress_sparse(
        jnp.asarray(g), jnp.asarray(r), rate=rate, interpret=True)
    tv, ti, tres, tnnz, tt = ops.topk_compress_sparse(
        torch.from_numpy(g), torch.from_numpy(r), rate=rate)
    assert tv.shape == jv.shape and ti.dtype == torch.int32
    # thresholds agree to one ulp (the reference's fine edges may be
    # FMA-contracted); with no value between them the payloads are equal
    lo, hi = sorted((float(jt), float(tt)))
    mag = np.abs(g + r)
    if not ((mag >= lo) & (mag < hi)).any():
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(tres.numpy(), np.asarray(jres))
        assert int(tnnz) == int(jnnz)
    rebuilt = torch.zeros(d).index_add_(0, ti.long(), tv)
    assert torch.equal(rebuilt + tres, torch.from_numpy(g)
                       + torch.from_numpy(r))


class TestChecks:
    @pytest.mark.parametrize("budget", [0, 65])
    def test_budget_outside_the_block_raises(self, budget):
        acc = torch.ones(4, 64)
        with pytest.raises(ValueError, match="budget"):
            ct_mod.compact_blocks(acc, 0.5, budget=budget)
        with pytest.raises(ValueError, match="budget"):
            j_compact(jnp.ones((4, 64)), jnp.float32(0.5), budget=budget,
                      interpret=True)

    def test_int32_index_range_raises(self):
        acc = torch.empty(2 ** 16, 2 ** 15, device="meta")
        with pytest.raises(ValueError, match="2\\^31"):
            ct_mod.compact_blocks(acc, 0.5, budget=4)

    def test_cpu_tensor_takes_the_plain_version(self, monkeypatch):
        calls = []
        real = ct_mod.ref_compact_blocks

        def spy(*a, **kw):
            calls.append(1)
            return real(*a, **kw)
        monkeypatch.setattr(ct_mod, "ref_compact_blocks", spy)
        before = ct_mod.compact_blocks.launches
        vals, *_ = ct_mod.compact_blocks(
            torch.ones(2, 8, dtype=torch.bfloat16), 0.5, budget=3)
        assert calls == [1] and ct_mod.compact_blocks.launches == before
        assert vals.dtype == torch.float32       # acc is cast to f32


class TestKernelPaths:
    """The plain version against the JAX package where the redesigned CUDA
    kernel has its own code paths: blocks shorter than one super-chunk of
    1024 and several super-chunks long (blk 100 to 4096), budget = blk,
    rows that are not 16-byte aligned (a view at a storage offset), and
    non-finite entries; plus what the wrapper hands the kernel."""

    @pytest.mark.parametrize("nb,blk,budget", [
        (3, 100, 10), (3, 100, 100), (2, 1000, 10), (2, 1000, 1000),
        (2, 2048, 10), (2, 2048, 64), (1, 4096, 10),
    ])
    def test_block_lengths_vs_jax_kernel_bitwise(self, nb, blk, budget):
        acc = _acc(nb, blk, blk + budget)
        t = np.float32(np.median(np.abs(acc)) * 2)
        want = j_compact(jnp.asarray(acc), jnp.float32(t), budget=budget,
                         interpret=True)
        got = ct_mod.compact_blocks(torch.from_numpy(acc), torch.tensor(t),
                                    budget=budget)
        _assert_bitwise(got, want)

    @pytest.mark.parametrize("nb,blk", [(3, 100), (2, 1024), (2, 2048)])
    def test_offset_view_vs_jax_kernel_bitwise(self, nb, blk):
        flat = _acc(1, 1 + nb * blk, nb + blk).reshape(-1)
        view = torch.from_numpy(flat)[1:].view(nb, blk)
        assert view.storage_offset() == 1
        t = np.float32(np.median(np.abs(flat)) * 2)
        want = j_compact(jnp.asarray(flat[1:].reshape(nb, blk)),
                         jnp.float32(t), budget=10, interpret=True)
        _assert_bitwise(ct_mod.compact_blocks(view, float(t), budget=10),
                        want)

    @pytest.mark.parametrize("threshold", [0.0, "2x median", np.inf])
    def test_non_finite_vs_jax(self, threshold):
        """All four outputs bitwise against the JAX oracle, which the port
        follows. Against the Pallas kernel only indices and counts: its
        one-hot MXU dot multiplies every entry of a block into every slot,
        so one +-Inf or NaN in the block makes every value slot NaN
        (Inf * 0), and its residual acc - acc * in_budget is NaN at +-Inf
        entries past the budget."""
        nb, blk, budget = 4, 256, 8
        acc = _acc(nb, blk, 71)
        t = np.float32(np.median(np.abs(acc)) * 2
                       if threshold == "2x median" else threshold)
        acc[:, 200], acc[:, 220], acc[:, 240] = np.inf, -np.inf, np.nan
        acc[0, 0], acc[1, 1], acc[2, 2] = np.nan, np.inf, -np.inf
        got = ct_mod.compact_blocks(torch.from_numpy(acc), torch.tensor(t),
                                    budget=budget)
        _assert_bitwise(got, jref.ref_compact_blocks(jnp.asarray(acc), t,
                                                     budget))
        pallas = j_compact(jnp.asarray(acc), jnp.float32(t), budget=budget,
                           interpret=True)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(pallas[1]))
        np.testing.assert_array_equal(got[2].numpy(),
                                      np.asarray(pallas[2]).reshape(-1))
        assert np.isnan(np.asarray(pallas[0])).all()

    @pytest.mark.parametrize("err", [0, 700])
    def test_launch_arguments(self, monkeypatch, err):
        calls = []

        def launch(*args):
            calls.append(args)
            return err
        monkeypatch.setattr(ct_mod, "_lib", lambda: types.SimpleNamespace(
            repro_compact_blocks=launch,
            repro_cuda_error_string=lambda e: b"fake"))
        acc = torch.ones(5, 2048)
        outs = (torch.empty(5, 10), torch.empty(5, 10, dtype=torch.int32),
                torch.empty(5, dtype=torch.int32), torch.empty(5, 2048))
        stream = types.SimpleNamespace(cuda_stream=11)
        before = ct_mod.compact_blocks.launches
        if err:
            with pytest.raises(RuntimeError, match="CUDA error 700"):
                ct_mod._launch(acc, torch.tensor(0.5), 10, outs, stream)
        else:
            ct_mod._launch(acc, torch.tensor(0.5), 10, outs, stream)
        (args,) = calls
        assert len(args) == 10
        assert args[1:3] == (5, 2048) and args[4] == 10 and args[-1] == 11
        assert args[5:9] == tuple(o.data_ptr() for o in outs)
        assert ct_mod.compact_blocks.launches == before + (0 if err else 1)


def test_kernel_op_raises_on_a_taken_name():
    """A second registration under a kernel's op name raises and leaves the
    first op's implementation in place."""
    from repro_torch.kernels._common import kernel_op

    def one(x: torch.Tensor) -> torch.Tensor:
        return x + 1

    def two(x: torch.Tensor) -> torch.Tensor:
        return x + 2

    a = kernel_op("kernel_op_twice", one, torch.empty_like)
    with pytest.raises(RuntimeError, match="kernel_op_twice"):
        kernel_op("kernel_op_twice", two, torch.empty_like)
    x = torch.zeros(3)
    assert torch.equal(a(x), x + 1)
    assert torch.equal(torch.ops.repro_torch.kernel_op_twice(x), x + 1)
