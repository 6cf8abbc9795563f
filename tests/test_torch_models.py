"""The port's models against `repro.models.small` with the same weights:
JAX-initialised parameters go into the port's flat buffer through
`params_from_jax`; logits, loss and the flat gradient match at rtol 1e-5 /
atol 1e-6 (fp32 sums taken in another order). The k = 3 local round
(Eq. 4) through the port's `fused_momentum` wrapper matches the reference
`_round_body`."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import compression as JC  # noqa: E402
from repro.models import small as jsmall  # noqa: E402

from repro_torch.core import compression as C  # noqa: E402
from repro_torch.models import small  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)

MODELS = {
    # name: (jax init, jax apply, port apply, input shape)
    "cnn_fmnist": (jsmall.cnn_init, jsmall.cnn_apply, small.cnn_apply,
                   (4, 28, 28, 1)),
    "mlp_fmnist": (jsmall.mlp_init, jsmall.mlp_apply, small.mlp_apply,
                   (4, 28, 28, 1)),
    "vgg11s_cifar10": (jsmall.vgg11s_init, jsmall.vgg11s_apply,
                       small.vgg11s_apply, (2, 32, 32, 3)),
    "lstm_sc": (jsmall.lstm_init, jsmall.lstm_apply, small.lstm_apply,
                (3, 6, 40)),
}


def numpy_params(jinit, seed=1):
    """Weights for the reference's parameter tree, drawn with numpy (the
    tree's structure from `jax.eval_shape`, so no JAX PRNG work)."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(jinit, jax.random.PRNGKey(0))
    return jax.tree.map(
        lambda s: (rng.randn(*s.shape) / np.sqrt(max(1, np.prod(
            s.shape[:-1])))).astype(np.float32), shapes)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_logits_loss_and_flat_grad_match(name):
    jinit, japply, tapply, shape = MODELS[name]
    params = numpy_params(jinit)
    rng = np.random.RandomState(0)
    x = rng.randn(*shape).astype(np.float32)
    y = rng.randint(0, 10, shape[0])

    jflat, jspec = JC.flatten_pytree(params)

    def jloss(flat):
        return jsmall.softmax_xent(japply(JC.unflatten_pytree(flat, jspec),
                                          jnp.asarray(x)), jnp.asarray(y))
    jlogits = jax.jit(japply)(params, jnp.asarray(x))
    jl, jg = jax.jit(jax.value_and_grad(jloss))(jflat)

    flat = small.params_from_jax(jax.tree.map(np.asarray, params))
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))
    _, spec = C.flatten_pytree(jax.tree.map(np.asarray, params))
    w = flat.clone().requires_grad_(True)
    logits = tapply(C.unflatten_pytree(w, spec), torch.from_numpy(x))
    loss = small.softmax_xent(logits, torch.from_numpy(y))
    (grad,) = torch.autograd.grad(loss, w)

    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               **TOL)
    np.testing.assert_allclose(loss.item(), float(jl), **TOL)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jg), **TOL)
    acc = small.accuracy(logits, torch.from_numpy(y))
    assert float(acc) == float(jsmall.accuracy(jlogits, jnp.asarray(y)))


@pytest.mark.parametrize("name", ["mlp_fmnist", "cnn_fmnist"])
def test_make_task_layout_matches_reference(name):
    jt = jsmall.make_task(name, num_samples=64, test_samples=16)
    tt = small.make_task(name, num_samples=64, test_samples=16)
    shapes = jax.eval_shape(jt.init_fn, jax.random.PRNGKey(0))
    assert tt.dim == sum(int(np.prod(s.shape))
                         for s in jax.tree.leaves(shapes))
    assert tt.init_fn(torch.Generator().manual_seed(0)).shape == (tt.dim,)
    for k in jt.test_batch:
        np.testing.assert_array_equal(np.asarray(tt.test_batch[k]),
                                      np.asarray(jt.test_batch[k]))
    if name == "cnn_fmnist":
        assert tt.dim == 1_663_370      # the paper's published width


def test_local_round_matches_round_body(monkeypatch):
    """k = 3 pseudo-gradient g = w0 − w3 (Eq. 4): the port's local round,
    one `fused_momentum` call per step, against the reference's jitted
    lax.scan."""
    from repro.core.simulator import AFLSimulator as JSim
    from repro.core.controller import DeviceProfile as JProfile
    from repro.core.factor import Plan as JPlan
    from repro.core.simulator import DeviceSpec as JSpec
    from repro_torch.core.controller import DeviceProfile
    from repro_torch.core.factor import Plan
    from repro_torch.core.simulator import AFLSimulator, DeviceSpec
    from repro_torch.kernels import fused_momentum as fm_mod

    jtask = jsmall.make_task("mlp_fmnist", num_samples=64, test_samples=16,
                             batch_size=8)
    ttask = small.make_task("mlp_fmnist", num_samples=64, test_samples=16,
                            batch_size=8)
    np_params = jax.tree.map(np.asarray, jtask.init_fn(jax.random.PRNGKey(2)))
    ttask.init_fn = lambda gen: small.params_from_jax(np_params)

    jsim = JSim(jtask, [JSpec(JProfile(0, 0.1, 1.0), JPlan(3, 1.0, 0, 1, 1))],
                engine="sequential", eta_l=0.05)
    tsim = AFLSimulator(ttask, [DeviceSpec(DeviceProfile(0, 0.1, 1.0),
                                           Plan(3, 1.0, 0, 1, 1))],
                        eta_l=0.05, device="cpu")
    rng = np.random.RandomState(3)
    batches = [{"image": rng.randn(8, 28, 28, 1).astype(np.float32),
                "label": rng.randint(0, 10, 8)} for _ in range(3)]
    flat = JC.flatten_pytree(jtask.init_fn(jax.random.PRNGKey(2)))[0]
    want = jsim._seq_round(flat, {k: np.stack([b[k] for b in batches])
                                  for k in batches[0]})

    calls = []
    real = fm_mod.fused_momentum

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    monkeypatch.setattr("repro_torch.optim.optim.fused_momentum", spy)
    got = tsim._local_round(small.params_from_jax(np_params),
                            [tsim._to_device(b) for b in batches])
    assert len(calls) == 3
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
