"""The port's LM building blocks against `repro`'s, module by module, on the
same numpy inputs: configs, nn layers and initializers, RoPE, attention
(train/prefill over (window, prefix, causal), including a window that
bites; decode with fp32 and int8 caches), the chunked SSD scan (against
both packages' sequential oracles, with and without an initial state),
MoE routing (the same experts, the same dropped slots) and outputs, and
the int8 KV quantizer (codes bitwise equal)."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as JCfg  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import mamba2 as JM  # noqa: E402
from repro.models import moe as JMoE  # noqa: E402
from repro.models import nn as JN  # noqa: E402
from repro.models import transformer as JT  # noqa: E402

from repro_torch import configs as TCfg  # noqa: E402
from repro_torch.core import compression as C  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import mamba2 as TM  # noqa: E402
from repro_torch.models import moe as TMoE  # noqa: E402
from repro_torch.models import nn as TN  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

import torch_lm_util as U  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.array(x))


# --------------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", JCfg.ARCH_IDS)
def test_configs_match_reference(arch):
    """Every field of the reference's ArchConfig equal; the port's own
    fields (a stack of layer kinds and its multipliers, which no
    assigned arch sets) at their defaults."""
    j, t = JCfg.get_config(arch), TCfg.get_config(arch)
    defaults = {f.name: f.default for f in dataclasses.fields(t)}
    for c_t, c_j in ((t, j), (t.smoke(), j.smoke())):
        ours, ref = dataclasses.asdict(c_t), dataclasses.asdict(c_j)
        assert {k: ours.pop(k) for k in set(ours) - set(ref)} == \
            {k: defaults[k] for k in set(defaults) - set(ref)}
        assert ours == ref
    for c_t, c_j in ((t, j), (t.smoke(), j.smoke())):
        assert c_t.param_count() == c_j.param_count()
        assert c_t.active_param_count() == c_j.active_param_count()
        assert c_t.shapes() == c_j.shapes()
        np.testing.assert_array_equal(c_t.is_global_flags().numpy(),
                                      np.asarray(c_j.is_global_flags()))
    for shape in t.shapes():
        ts, js = t.input_specs(shape), j.input_specs(shape)
        assert sorted(ts) == sorted(js)
        for k in js:
            assert ts[k].device.type == "meta"
            assert tuple(ts[k].shape) == js[k].shape
            assert str(ts[k].dtype).split(".")[-1] == str(js[k].dtype)


def test_config_registry():
    assert TCfg.ARCH_IDS == JCfg.ARCH_IDS
    assert sorted(TCfg.all_configs()) == sorted(JCfg.ARCH_IDS)
    with pytest.raises(KeyError):
        TCfg.get_config("nope")


# ---------------------------------------------------------------------- nn
def test_norms_activations_and_embedding_match_reference():
    rng = np.random.RandomState(0)
    x = (rng.randn(3, 5, 16) * 3).astype(np.float32)
    scale = (1 + 0.1 * rng.randn(16)).astype(np.float32)
    bias = (0.1 * rng.randn(16)).astype(np.float32)
    np.testing.assert_allclose(
        TN.rmsnorm_apply({"scale": _t(scale)}, _t(x)).numpy(),
        np.asarray(JN.rmsnorm_apply({"scale": scale}, x)), rtol=1e-6,
        atol=1e-6)
    np.testing.assert_allclose(
        TN.layernorm_apply({"scale": _t(scale), "bias": _t(bias)},
                           _t(x)).numpy(),
        np.asarray(JN.layernorm_apply({"scale": scale, "bias": bias}, x)),
        rtol=1e-5, atol=1e-5)
    wide = np.linspace(-40, 40, 801).astype(np.float32)
    for tf, jf in ((TN.gelu, JN.gelu), (TN.silu, JN.silu),
                   (TN.softplus, jax.nn.softplus)):
        np.testing.assert_allclose(tf(_t(wide)).numpy(),
                                   np.asarray(jf(wide)), rtol=1e-6,
                                   atol=1e-6)
    emb = rng.randn(11, 16).astype(np.float32)
    ids = rng.randint(0, 11, (2, 7)).astype(np.int32)
    np.testing.assert_array_equal(
        TN.embedding_apply({"embedding": _t(emb)}, _t(ids)).numpy(),
        np.asarray(JN.embedding_apply({"embedding": emb}, ids)))
    np.testing.assert_allclose(
        TN.embedding_attend({"embedding": _t(emb)}, _t(x)).numpy(),
        np.asarray(JN.embedding_attend({"embedding": emb}, x)), **TOL)
    k = rng.randn(16, 4).astype(np.float32)
    np.testing.assert_allclose(
        TN.linear_apply({"kernel": _t(k), "bias": _t(bias[:4])}, _t(x),
                        dtype=torch.float32).numpy(),
        np.asarray(JN.linear_apply({"kernel": k, "bias": bias[:4]}, x,
                                   dtype=jnp.float32)), **TOL)
    assert TN.DTypePolicy.small() == TN.DTypePolicy(torch.float32,
                                                     torch.float32)
    assert TN.DTypePolicy.large().compute_dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ["gemma3-4b", "qwen3-moe-30b-a3b",
                                  "hymba-1.5b", "hubert-xlarge",
                                  "paligemma-3b"])
def test_lm_init_has_the_reference_tree(arch):
    jlm = JT.LM(JCfg.get_config(arch).smoke(), dtype=jnp.float32)
    tlm = TT.LM(TCfg.get_config(arch).smoke(), dtype=torch.float32)
    shapes = jax.eval_shape(jlm.init, jax.random.PRNGKey(0))
    params = tlm.init(torch.Generator().manual_seed(0))
    _, jspec = C.flatten_pytree(jax.tree.map(
        lambda s: np.zeros(s.shape, np.float32), shapes))
    flat, spec = C.flatten_pytree(params)
    assert spec == jspec == tlm.param_spec()
    assert TN.count_params(params) == flat.numel() == sum(
        int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    assert TN.param_bytes(params) == 4 * flat.numel()
    # the reference's initializers: ones/zeros/constants where it has them,
    # truncated normals within 2 standard deviations elsewhere
    lay = params["layers"]
    norm = lay.get("attn_norm", lay.get("ssm_norm"))
    assert torch.all(norm["scale"] == 1)
    if "ssm" in lay:
        assert torch.all(lay["ssm"]["A_log"] == 0)
        assert torch.allclose(lay["ssm"]["dt_bias"],
                              torch.tensor(math.log(math.e - 1)))
    if "wq" in lay:
        wq = lay["wq"]["kernel"]
        bound = 2.0 / math.sqrt(wq.shape[1])
        assert wq.abs().max() <= bound * (1 + 1e-6) and wq.std() > 0
        assert not torch.equal(wq[0], wq[1])      # each layer drawn apart


# ---------------------------------------------------------------- attention
def test_rope_matches_reference():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 12, 3, 16).astype(np.float32)
    for pos in (np.arange(12), np.stack([np.arange(12), np.arange(5, 17)])):
        np.testing.assert_allclose(
            TA.rope(_t(x), _t(pos), 1e6).numpy(),
            np.asarray(JA.rope(x, pos, 1e6)), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("window,prefix,causal", [
    (TA.FULL_WINDOW, 0, True), (32, 0, True), (TA.FULL_WINDOW, 17, True),
    (TA.FULL_WINDOW, 0, False), (8, 5, True)])
def test_flash_attention_matches_references(window, prefix, causal):
    rng = np.random.RandomState(0)
    q = rng.randn(2, 128, 4, 16).astype(np.float32)
    k = rng.randn(2, 128, 2, 16).astype(np.float32)
    v = rng.randn(2, 128, 2, 16).astype(np.float32)
    ref = np.asarray(JA.reference_attention(q, k, v, causal=causal,
                                            window=window, prefix_len=prefix))
    kw = dict(causal=causal, window=window, prefix_len=prefix)
    out = TA.flash_attention(_t(q), _t(k), _t(v), **kw).numpy()
    np.testing.assert_allclose(out, ref, **TOL)
    np.testing.assert_allclose(
        TA.reference_attention(_t(q), _t(k), _t(v), **kw).numpy(), ref,
        **TOL)
    if window < 128:   # the window must change the result
        full = TA.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                                  window=TA.FULL_WINDOW,
                                  prefix_len=prefix).numpy()
        assert np.abs(full - out).max() > 1e-2


@pytest.mark.parametrize("window,prefix", [(TA.FULL_WINDOW, 0), (16, 0),
                                           (TA.FULL_WINDOW, 24)])
def test_flash_attention_in_query_chunks_matches_reference(
        monkeypatch, window, prefix):
    """Past MASK_ELEMS mask entries the queries run in chunks (at 1/4 of
    the mask here: chunks of 32 of 128 queries), each at its offset."""
    rng = np.random.RandomState(2)
    q = rng.randn(2, 128, 4, 16).astype(np.float32)
    k = rng.randn(2, 128, 2, 16).astype(np.float32)
    v = rng.randn(2, 128, 2, 16).astype(np.float32)
    kw = dict(causal=True, window=window, prefix_len=prefix)
    whole = TA.flash_attention(_t(q), _t(k), _t(v), **kw).numpy()
    monkeypatch.setattr(TA, "MASK_ELEMS", 128 * 128 // 4)
    calls = []
    real = TA.F.scaled_dot_product_attention
    monkeypatch.setattr(TA.F, "scaled_dot_product_attention",
                        lambda qh, *a, **k: calls.append(qh.shape[2]) or
                        real(qh, *a, **k))
    out = TA.flash_attention(_t(q), _t(k), _t(v), **kw).numpy()
    assert calls == [32] * 4
    ref = np.asarray(JA.reference_attention(q, k, v, **kw))
    np.testing.assert_allclose(out, ref, **TOL)
    np.testing.assert_allclose(out, whole, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("window", [None, 16])
@pytest.mark.parametrize("cache", ["f32", "int8"])
def test_decode_attention_matches_reference(cache, window):
    rng = np.random.RandomState(1)
    S, cur = 64, 40
    q = rng.randn(2, 1, 4, 16).astype(np.float32)
    k = rng.randn(2, S, 2, 16).astype(np.float32)
    v = rng.randn(2, S, 2, 16).astype(np.float32)
    if cache == "int8":
        k8, ks = JT._quantize_kv(k)
        v8, vs = JT._quantize_kv(v)
        ref = JA.decode_attention(q, k8, v8, jnp.int32(cur), window=window,
                                  k_scale=ks, v_scale=vs)
        out = TA.decode_attention(_t(q), _t(k8), _t(v8), cur, window=window,
                                  k_scale=_t(ks), v_scale=_t(vs))
    else:
        ref = JA.decode_attention(q, k, v, jnp.int32(cur), window=window)
        out = TA.decode_attention(_t(q), _t(k), _t(v), cur, window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_quantize_kv_codes_bitwise():
    rng = np.random.RandomState(1)
    x = (rng.randn(2, 16, 4, 32) * 3.0).astype(np.float32)
    x[0, 0, 0] = 0.0                                  # the 1e-8 scale floor
    x[1, 2, 3, :4] = [0.5, -0.5, 1.5, 127.0]          # ties round to even
    jc, js = JT._quantize_kv(jnp.asarray(x))
    tc, ts = TT._quantize_kv(_t(x))
    assert tc.dtype == torch.int8
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-7, atol=0)


# ---------------------------------------------------------------------- SSD
def _ssd_inputs(b, S, H, P, N, seed):
    rng = np.random.RandomState(seed)
    xh = rng.randn(b, S, H, P).astype(np.float32)
    dt = (np.abs(rng.randn(b, S, H)) * 0.5).astype(np.float32)
    A = -np.abs(rng.randn(H)).astype(np.float32)
    Bm = rng.randn(b, S, N).astype(np.float32)
    Cm = rng.randn(b, S, N).astype(np.float32)
    st = rng.randn(b, H, P, N).astype(np.float32)
    return xh, dt * A, dt, Bm, Cm, st


@pytest.mark.parametrize("initial", [False, True])
def test_ssd_chunked_matches_references(initial):
    xh, dtA, dt, Bm, Cm, st0 = _ssd_inputs(2, 96, 3, 8, 4, seed=2)
    init = st0 if initial else None
    jin = [jnp.asarray(a) for a in (xh, dtA, dt, Bm, Cm)]
    jinit = None if init is None else jnp.asarray(init)
    jy, jst = JM.ssd_chunked(*jin, chunk=32, initial_state=jinit)
    ty, tst = TM.ssd_chunked(_t(xh), _t(dtA), _t(dt), _t(Bm), _t(Cm),
                             chunk=32,
                             initial_state=_t(init) if initial else None)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(tst.numpy(), np.asarray(jst), **TOL)
    ry, rst = TM.ssd_reference(_t(xh), _t(dtA), _t(dt), _t(Bm), _t(Cm),
                               initial_state=_t(init) if initial else None)
    jry, _ = JM.ssd_reference(*jin, initial_state=jinit)
    np.testing.assert_allclose(ry.numpy(), np.asarray(jry), **TOL)
    np.testing.assert_allclose(ty.numpy(), ry.numpy(), rtol=1e-3, atol=2e-3)
    np.testing.assert_allclose(tst.numpy(), rst.numpy(), rtol=1e-3, atol=2e-3)
    with pytest.raises(ValueError):
        TM.ssd_chunked(_t(xh[:, :90]), _t(dtA[:, :90]), _t(dt[:, :90]),
                       _t(Bm[:, :90]), _t(Cm[:, :90]), chunk=32)


# (b, S, H, P, N, chunk, initial state): N in {4, 16}, P in {8, 32}, S a
# multiple of the chunk, and S < chunk with a chunk (Q = S) that is no
# power of two
SSD_CASES = [(2, 96, 3, 8, 4, 32, True), (2, 96, 3, 32, 16, 32, False),
             (1, 64, 2, 8, 16, 16, True), (2, 40, 3, 32, 4, 64, True),
             (1, 30, 2, 8, 16, 256, False)]


def _rel(a, b):
    a, b = (np.asarray(t, dtype=np.float64) for t in (a, b))
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_kernels_plain_decomposition(case):
    """`kernels.ssd.ssd` on the CPU (the kernels' plain versions and their
    hand-derived backward, through the custom ops): the forward against
    the port's sequential oracle in float64 and the JAX package's
    `ssd_chunked`; every gradient (xh, dtA, dt, B, C and the initial
    state's) against float64 autograd through that oracle and against
    `jax.vjp` of the JAX package's `ssd_chunked`. Relative L2 1e-5: fp32
    sums in another order (the decomposition's products over N, P and Q
    against the recurrence's or the einsums'); ~1e-7 is typical."""
    from repro_torch.kernels import ssd as K
    b, S, H, P, N, chunk, initial = case
    xh, dtA, dt, Bm, Cm, st0 = _ssd_inputs(b, S, H, P, N, seed=3)
    ins = [xh, dtA, dt, Bm, Cm] + ([st0] if initial else [])
    leaves = [[_t(a).requires_grad_(True) for a in ins],
              [_t(a).double().requires_grad_(True) for a in ins]]
    init = lambda ls: ls[5] if initial else None
    y, fin = K.ssd(*leaves[0][:5], chunk=chunk, initial_state=init(leaves[0]))
    ey, efin = TM.ssd_reference(*leaves[1][:5],
                                initial_state=init(leaves[1]))
    jy, jfin = JM.ssd_chunked(*(jnp.asarray(a) for a in ins[:5]),
                              chunk=chunk, initial_state=jnp.asarray(st0)
                              if initial else None)
    for want in (ey.detach(), np.asarray(jy)):
        assert _rel(y.detach(), want) < 1e-5
    for want in (efin.detach(), np.asarray(jfin)):
        assert _rel(fin.detach(), want) < 1e-5
    rng = np.random.RandomState(4)
    dy, dfin = _t(rng.randn(*y.shape).astype(np.float32)), \
        _t(rng.randn(*fin.shape).astype(np.float32))
    torch.autograd.backward([y, fin], [dy, dfin])
    torch.autograd.backward([ey, efin], [dy.double(), dfin.double()])
    _, vjp = jax.vjp(
        lambda *a: JM.ssd_chunked(*a[:5], chunk=chunk, initial_state=a[5]
                                  if initial else None),
        *(jnp.asarray(a) for a in ins))
    jgrads = vjp((jnp.asarray(dy.numpy()), jnp.asarray(dfin.numpy())))
    for name, got, want, jg in zip(("xh", "dtA", "dt", "B", "C", "init"),
                                   leaves[0], leaves[1], jgrads):
        assert _rel(got.grad, want.grad) < 1e-5, name
        assert _rel(got.grad, np.asarray(jg)) < 1e-5, name


def test_ssd_kernels_fake_mode_allocates_outputs_only(monkeypatch):
    """Under FakeTensorMode (the dry run) `kernels.ssd.ssd` forward and
    backward run the custom ops' fake versions: outputs and gradients of
    the right shapes, and no plain version (no [b, nc, H, Q, Q] decay)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels import ssd as K

    def ran(*a, **k):
        raise AssertionError("a plain version ran under FakeTensorMode")
    monkeypatch.setattr(K, "ssd_fwd_plain", ran)
    monkeypatch.setattr(K, "ssd_bwd_plain", ran)
    with FakeTensorMode():
        x = torch.empty(2, 64, 3, 8, requires_grad=True)
        dtA = torch.empty(2, 64, 3, requires_grad=True)
        B = torch.empty(2, 64, 16, requires_grad=True)
        init = torch.empty(2, 3, 8, 16, requires_grad=True)
        y, fin = K.ssd(x, dtA, dtA, B, B, chunk=32, initial_state=init)
        (y.sum() + fin.sum()).backward()
        assert (y.shape, fin.shape) == (x.shape, init.shape)
        assert (x.grad.shape, dtA.grad.shape, B.grad.shape,
                init.grad.shape) == (x.shape, dtA.shape, B.shape, init.shape)


@pytest.mark.parametrize("S", [48, 12])
def test_mamba2_train_cpu_path_runs_the_kernel_wrapper(S, monkeypatch):
    """On the CPU `mamba2_train` reaches `kernels.ssd.ssd` (its plain
    versions, through the custom ops), over three chunks of 16 steps and
    over a ragged S < chunk; its output, final state and every gradient
    match those of the same layer built on the sequential oracle
    `ssd_reference`, at relative L2 1e-5: fp32 sums in another order (the
    largest reading, A_log's gradient at S 48, was 5.6e-6)."""
    from torch.utils._pytree import tree_leaves, tree_map
    from repro_torch.kernels import ssd as K
    s = TM.SSMSpec(32, 64, 4, 16, 8, 4)
    gen = torch.Generator().manual_seed(0)
    p = TM.mamba2_init(gen, s)
    x = torch.randn((2, S, 32), generator=gen)

    def run():
        params = tree_map(lambda v: v.clone().requires_grad_(True), p)
        xx = x.clone().requires_grad_(True)
        out, (fin, _) = TM.mamba2_train(params, s, xx, chunk=16,
                                        dtype=torch.float32,
                                        return_state=True)
        (out.square().mean() + fin.square().mean()).backward()
        return [out, fin, xx.grad] + [v.grad for v in tree_leaves(params)]

    calls = []

    def spy(name):
        plain = getattr(K, name)

        def run_plain(*a):
            calls.append(name)
            return plain(*a)
        monkeypatch.setattr(K, name, run_plain)
    spy("ssd_fwd_plain")
    spy("ssd_bwd_plain")
    got = run()
    assert calls == ["ssd_fwd_plain", "ssd_bwd_plain"]

    def oracle(xh, dtA, dt, Bm, Cm, *, chunk, initial_state=None):
        return TM.ssd_reference(xh, dtA, dt, Bm, Cm, initial_state)
    monkeypatch.setattr(TM, "ssd_chunked", oracle)
    want = run()
    assert len(got) == len(want) == 11
    for a, b in zip(got, want):
        assert _rel(a.detach(), b.detach()) < 1e-5


# ---------------------------------------------------------------------- MoE
def _jax_route(xf, router, E, k, cf):
    """The reference's routing (`repro.models.moe._dispatch_compute`)."""
    logits = xf @ router
    _, sel = jax.lax.top_k(logits, k)
    flat_eid = sel.reshape(-1)
    sort_idx = jnp.argsort(flat_eid)
    sorted_eid = flat_eid[sort_idx]
    counts = jnp.bincount(flat_eid, length=E)
    pos = jnp.arange(flat_eid.size) - (jnp.cumsum(counts) - counts)[sorted_eid]
    cap = int(math.ceil(k * xf.shape[0] / E * cf))
    cap = max(8, ((cap + 7) // 8) * 8)
    return np.asarray(sel), np.asarray(sort_idx), np.asarray(pos < cap)


@pytest.mark.parametrize("cf", [1.25, 8.0])
def test_moe_routes_drops_and_outputs_match_reference(cf):
    d, E, k, f = 32, 4, 2, 64
    rng = np.random.RandomState(1)
    p = {"router": {"kernel": rng.randn(d, E).astype(np.float32)},
         "w_gate": (rng.randn(E, d, f) / np.sqrt(d)).astype(np.float32),
         "w_up": (rng.randn(E, d, f) / np.sqrt(d)).astype(np.float32),
         "w_down": (rng.randn(E, f, d) / np.sqrt(f)).astype(np.float32)}
    p["router"]["kernel"][:, 0] += 0.3      # expert 0 over capacity
    x = (rng.randn(4, 64, d) + 1.0).astype(np.float32)
    x[0, 1] = x[0, 0]                   # a tie in the slot sort's order
    xf = x.reshape(-1, d)
    sel, sort_idx, keep = _jax_route(xf, p["router"]["kernel"], E, k, cf)
    r = TMoE.route(_t(xf), _t(p["router"]["kernel"]), n_experts=E, top_k=k,
                   capacity_factor=cf)
    np.testing.assert_array_equal(r["sel"].numpy(), sel)
    np.testing.assert_array_equal(r["sort_idx"].numpy(), sort_idx)
    np.testing.assert_array_equal(r["keep"].numpy(), keep)
    assert (cf > 2) == keep.all()            # cf 1.25 drops slots
    tp = jax.tree.map(_t, p)
    y = TMoE.moe_apply(tp, _t(x), n_experts=E, top_k=k, capacity_factor=cf,
                       dtype=torch.float32)
    jy = JMoE.moe_apply(p, x, n_experts=E, top_k=k, capacity_factor=cf,
                        dtype=jnp.float32)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(
        float(TMoE.moe_aux_loss(tp, _t(x), n_experts=E, top_k=k)),
        float(JMoE.moe_aux_loss(p, x, n_experts=E, top_k=k)), rtol=1e-6)


def test_params_roundtrip_cache_specs_and_remat():
    """`params_to_numpy` inverts `params_from_jax`; `cache_specs` is
    `init_cache` on the meta device; `remat` (a checkpoint per block)
    gives the loss and gradient of the plain stack."""
    jlm = JT.LM(JCfg.get_config("hymba-1.5b").smoke(), dtype=jnp.float32)
    shapes = jax.eval_shape(jlm.init, jax.random.PRNGKey(0))
    rng = np.random.RandomState(3)
    np_params = jax.tree.map(
        lambda s: (0.1 * rng.randn(*s.shape)).astype(np.float32), shapes)
    params = TT.params_from_jax(np_params)
    back = TT.params_to_numpy(params)
    jax.tree.map(np.testing.assert_array_equal, back, np_params)
    cfg = TCfg.get_config("hymba-1.5b").smoke()
    lm = TT.LM(cfg, dtype=torch.float32, remat=False)
    specs, cache = lm.cache_specs(2, 8), lm.init_cache(2, 8)
    assert sorted(specs) == sorted(cache) == ["conv", "k", "ssm", "v"]
    for k in cache:
        assert specs[k].device.type == "meta"
        assert (specs[k].shape, specs[k].dtype) == (cache[k].shape,
                                                    cache[k].dtype)
    g = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 16), generator=g),
             "labels": torch.randint(0, cfg.vocab, (2, 16), generator=g)}
    flat, spec = C.flatten_pytree(params)
    out = []
    for remat in (False, True):
        w = flat.clone().requires_grad_(True)
        m = TT.LM(cfg, dtype=torch.float32, remat=remat)
        loss = m.loss(C.unflatten_pytree(w, spec), batch)
        out.append((loss.detach(), torch.autograd.grad(loss, w)[0]))
    assert torch.equal(out[0][0], out[1][0])
    torch.testing.assert_close(out[1][1], out[0][1], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("arch", ["gemma3-4b", "hymba-1.5b",
                                  "qwen3-moe-30b-a3b"])
def test_bf16_compute_tracks_reference(arch):
    """`LM`'s default compute dtype (bf16) on both sides: the loss within
    rtol 2e-3 and prefill logits within atol 0.1 (bf16 keeps 8 bits, and
    the two frameworks round different intermediate sums)."""
    jlm, tlm = U.models(arch)
    jlm = dataclasses.replace(jlm, dtype=jnp.bfloat16)
    tlm = dataclasses.replace(tlm, dtype=torch.bfloat16)
    np_params = U.numpy_params(jlm)
    tp = TT.params_from_jax(np_params)
    b = U.batch(jlm.cfg)
    jl = float(jax.jit(jlm.loss)(np_params, U.to_jax(b)))
    with torch.no_grad():
        tl = float(tlm.loss(tp, U.to_torch(b)))
        pb = {k: v for k, v in b.items() if k != "labels"}
        tp_logits, _ = tlm.prefill(tp, U.to_torch(pb))
    jp_logits, _ = jax.jit(jlm.prefill)(np_params, U.to_jax(pb))
    np.testing.assert_allclose(tl, jl, rtol=2e-3)
    np.testing.assert_allclose(tp_logits.float().numpy(),
                               np.asarray(jp_logits, np.float32), atol=0.1)


def _saved_bytes(fn):
    """`fn()` under a saved-tensor hook: the bytes of the distinct
    storages autograd keeps for the backward pass, and `fn()`'s value."""
    seen = {}

    def pack(t):
        s = t.untyped_storage()
        seen[s.data_ptr()] = s.nbytes()
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return sum(seen.values()), out


@pytest.mark.parametrize("S", [128, 512])
def test_chunked_ce_loss_matches_reference_and_saves_no_logits(S):
    """Four chunks: the loss within rtol 1e-5 and the gradients of h and
    the embedding within the bf16-logit CE tolerance of the reference's
    `chunked_ce_loss`. Autograd keeps h, the labels and nothing of the
    [B, chunk, V] logits (each chunk is recomputed in the backward pass,
    as the reference's per-chunk `jax.checkpoint(nothing_saveable)`), so
    the kept bytes grow with S·d, not with S·V."""
    B, d, V, chunk = 2, 16, 2048, S // 4
    rng = np.random.RandomState(5)
    h = rng.randn(B, S, d).astype(np.float32)
    emb = (rng.randn(V, d) / np.sqrt(d)).astype(np.float32)
    labels = rng.randint(0, V, size=(B, S)).astype(np.int32)
    th, te = _t(h).requires_grad_(True), _t(emb).requires_grad_(True)
    kept, loss = _saved_bytes(lambda: TT.chunked_ce_loss(
        th, te, torch.from_numpy(labels), chunk=chunk))
    assert kept <= th.nbytes + 8 * labels.size < B * chunk * V * 2
    gh, ge = torch.autograd.grad(loss, (th, te))
    jl, (jgh, jge) = jax.value_and_grad(
        lambda a, b: JT.chunked_ce_loss(a, b, jnp.asarray(labels),
                                        chunk=chunk), argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(emb))
    np.testing.assert_allclose(float(loss.detach()), float(jl),
                               rtol=U.LOSS_RTOL)
    for g, g_ref in ((gh, jgh), (ge, jge)):
        g_ref = np.asarray(g_ref)
        rel = np.linalg.norm(g.numpy() - g_ref) / np.linalg.norm(g_ref)
        assert rel <= U.CE_GRAD_TOL[0]
        assert np.abs(g.numpy() - g_ref).max() <= \
            U.CE_GRAD_TOL[1] * np.abs(g_ref).max()
