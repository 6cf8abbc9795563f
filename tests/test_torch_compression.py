"""The port's compressors against `repro.core.compression` on the same
numpy inputs. Inputs for the bitwise checks are tie-free and dyadic
(integers over 64 with distinct magnitudes), so every sum the
compressors take is exact in f32 whatever order either framework adds in.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import compression as JC  # noqa: E402
from repro.models import small as jsmall  # noqa: E402

from repro_torch.core import compression as C  # noqa: E402


def _dyadic(d, seed):
    """Distinct magnitudes 1/64 .. d/64 in random order and sign."""
    rng = np.random.RandomState(seed)
    mag = rng.permutation(np.arange(1, d + 1)).astype(np.float32) / 64.0
    return np.where(rng.rand(d) < 0.5, -mag, mag).astype(np.float32)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _same(jc: "JC.Compressed", tc: "C.Compressed"):
    np.testing.assert_array_equal(tc.dense().numpy(), np.asarray(jc.dense()))
    assert tc.wire_bits == float(jc.wire_bits)
    if jc.indices is None:
        assert tc.indices is None
    else:
        np.testing.assert_array_equal(tc.indices.numpy(),
                                      np.asarray(jc.indices))
        np.testing.assert_array_equal(tc.values.numpy(),
                                      np.asarray(jc.values))


class TestFlatten:
    @pytest.mark.parametrize("init", ["cnn", "lstm"])
    def test_flat_order_equals_jax(self, init):
        rng = np.random.RandomState(0)
        shapes = jax.eval_shape(jsmall.cnn_init if init == "cnn"
                                else jsmall.lstm_init, jax.random.PRNGKey(0))
        tree = jax.tree.map(lambda s: rng.randn(*s.shape).astype(np.float32),
                            shapes)
        jflat, _ = JC.flatten_pytree(tree)
        tflat, spec = C.flatten_pytree(_np_tree(tree))
        np.testing.assert_array_equal(tflat.numpy(), np.asarray(jflat))
        # views: every leaf of the unflattened tree is the JAX leaf, and
        # shares the flat buffer's storage
        views = C.unflatten_pytree(tflat, spec)
        for path, _ in spec:
            j, t = tree, views
            for p in path:
                j, t = j[p], t[p]
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
            assert t.untyped_storage().data_ptr() == \
                tflat.untyped_storage().data_ptr()

    def test_num_keep_and_wire_helpers(self):
        for d, rate in [(1000, 0.0), (1000, 0.0123), (10, 1.0), (7, 0.5)]:
            assert C.num_keep(d, rate) == JC.num_keep(d, rate)
            for name in ("topk", "randk", "qsgd", "none"):
                assert C.sparse_wire(name, d, rate) == \
                    JC.sparse_wire(name, d, rate)
        assert C.HEADER_BITS == JC.HEADER_BITS
        assert C.SPARSE_WIRE == JC.SPARSE_WIRE


class TestBitwise:
    @pytest.mark.parametrize("rate", [0.01, 0.05, 0.3, 1.0])
    def test_topk(self, rate):
        g = _dyadic(1000, 1)
        _same(JC.topk(jnp.asarray(g), rate), C.topk(torch.from_numpy(g), rate))
        cc = C.topk(torch.from_numpy(g), rate)
        assert C.payload_bits(cc) == float(JC.payload_bits(
            JC.topk(jnp.asarray(g), rate)))

    @pytest.mark.parametrize("k", [1, 7, 16])
    def test_topk_capped(self, k):
        g = _dyadic(500, 2)
        _same(JC.topk_capped(jnp.asarray(g), k, k_cap=16),
              C.topk_capped(torch.from_numpy(g), k, k_cap=16))

    def test_topk_ties_break_by_index(self):
        g = np.asarray([1.0, -3.0, 3.0, 2.0, -3.0, 0.5], np.float32)
        _same(JC.topk(jnp.asarray(g), 0.5), C.topk(torch.from_numpy(g), 0.5))

    @pytest.mark.parametrize("levels", [16, 256])
    def test_qsgd(self, levels):
        g = _dyadic(200, 3)
        _same(JC.qsgd(jnp.asarray(g), levels),
              C.qsgd(torch.from_numpy(g), levels))

    def test_signsgd_and_identity(self):
        g = _dyadic(200, 4)
        _same(JC.signsgd(jnp.asarray(g)), C.signsgd(torch.from_numpy(g)))
        _same(JC.identity(jnp.asarray(g)), C.identity(torch.from_numpy(g)))

    @pytest.mark.parametrize("name,rate", [("topk", 0.05), ("qsgd", 1.0),
                                           ("signsgd", 1.0), ("none", 1.0)])
    def test_ef_compress(self, name, rate):
        g, r = _dyadic(200, 5), _dyadic(200, 6) / 8
        jc, jres = JC.ef_compress(JC.make_compressor(name, rate),
                                  jnp.asarray(g), jnp.asarray(r))
        tc, tres = C.ef_compress(C.make_compressor(name, rate),
                                 torch.from_numpy(g), torch.from_numpy(r))
        _same(jc, tc)
        np.testing.assert_array_equal(tres.numpy(), np.asarray(jres))


class TestTopkThreshold:
    @pytest.mark.parametrize("rate", [0.005, 0.05, 0.2])
    @pytest.mark.parametrize("seed", [0, 1])
    def test_matches_reference_mask(self, rate, seed):
        rng = np.random.RandomState(seed)
        d = 8000
        g = (rng.randn(d) * np.exp(rng.randn(d))).astype(np.float32)
        jc = JC.topk_threshold(jnp.asarray(g), rate)
        tc = C.topk_threshold(torch.from_numpy(g), rate)
        k = C.num_keep(d, rate)
        jm, tm = np.asarray(jc.values) != 0, tc.values.numpy() != 0
        assert tm.sum() <= k and jm.sum() <= k
        lo, hi = sorted((float(jc.meta["threshold"]),
                         float(tc.meta["threshold"])))
        assert np.nextafter(np.float32(lo), np.float32(np.inf)) >= hi
        differ = jm != tm
        mag = np.abs(g)
        assert np.all((mag[differ] >= lo) & (mag[differ] <= hi))
        np.testing.assert_array_equal(tc.values.numpy()[tm], g[tm])
        assert tc.wire_bits == float(jc.wire_bits)

    def test_exact_k_correction_on_ties(self):
        """More than k coordinates tie at the largest magnitude, so the
        threshold is that magnitude: the count-based correction caps nnz at
        k, keeping lower indices first."""
        g = np.ones(1000, np.float32)
        g[:100:2] = 4.0
        g[1:100:2] = -4.0
        for exact in (True, None):
            jc = JC.topk_threshold(jnp.asarray(g), 0.05, exact_k=exact)
            tc = C.topk_threshold(torch.from_numpy(g), 0.05, exact_k=exact)
            np.testing.assert_array_equal(tc.values.numpy(),
                                          np.asarray(jc.values))
            assert int((tc.values != 0).sum()) == 50

    def test_ef_path_fires_correction_and_conserves(self):
        g = np.ones(1000, np.float32)
        r = np.zeros(1000, np.float32)
        r[:100] = 3.0
        comp = C.make_compressor("topk_threshold", 0.05)
        tc, tres = C.ef_compress(comp, torch.from_numpy(g),
                                 torch.from_numpy(r))
        jc, jres = JC.ef_compress(JC.make_compressor("topk_threshold", 0.05),
                                  jnp.asarray(g), jnp.asarray(r))
        np.testing.assert_array_equal(tc.dense().numpy(),
                                      np.asarray(jc.dense()))
        np.testing.assert_array_equal(tres.numpy(), np.asarray(jres))
        assert int((tc.dense() != 0).sum()) == 50
        assert torch.equal(tc.dense() + tres, torch.from_numpy(g + r))


class TestRandomCompressors:
    """randk and terngrad draw from torch.Generator streams, which cannot
    reproduce JAX's PRNG: checked by distribution only."""

    def test_randk_support_and_uniformity(self):
        d, rate = 200, 0.1
        g = torch.from_numpy(_dyadic(d, 7))
        hits = np.zeros(d)
        for s in range(300):
            cc = C.randk(g, rate, torch.Generator().manual_seed(s))
            idx = cc.indices.numpy()
            assert len(np.unique(idx)) == len(idx) == C.num_keep(d, rate)
            np.testing.assert_array_equal(cc.values.numpy(),
                                          g.numpy()[idx] * (d / len(idx)))
            assert cc.wire_bits == float(JC.randk(
                jnp.asarray(g.numpy()), rate, jax.random.PRNGKey(0)).wire_bits)
            hits[idx] += 1
        # each coordinate is picked with probability k/d = 0.1
        assert abs(hits.mean() / 300 - 0.1) < 1e-9
        assert hits.min() > 10 and hits.max() < 55

    def test_terngrad_unbiased(self):
        g = torch.from_numpy(_dyadic(100, 8))
        draws = torch.stack([C.terngrad(g, torch.Generator().manual_seed(s))
                             .values for s in range(2000)])
        s = float(g.abs().max()) + 1e-12
        assert set(np.unique(np.abs(draws.numpy()))) <= {0.0, np.float32(s)}
        np.testing.assert_allclose(draws.mean(0).numpy(), g.numpy(),
                                   atol=0.15 * s)
        cc = C.terngrad(g, torch.Generator().manual_seed(0))
        assert cc.wire_bits == float(JC.terngrad(
            jnp.asarray(g.numpy()), jax.random.PRNGKey(0)).wire_bits)
