"""The port's optimizers and schedules against `repro.optim` on a small
parameter tree over 5 steps, from the same numpy weights and gradients,
at rtol 1e-6 (the port's schedules compute lr in Python doubles, the
reference in f32). The state's per-coordinate buffers are flat, in the
params' flat order, and the update is in place."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import optim as jopt  # noqa: E402
from repro.core import compression as JC  # noqa: E402

from repro_torch import optim as topt  # noqa: E402
from repro_torch.core import compression as C  # noqa: E402
from repro_torch.kernels import fused_momentum as fm_mod  # noqa: E402

TOL = dict(rtol=1e-6, atol=1e-7)
SHAPES = {"dense": {"kernel": (6, 5), "bias": (5,)}, "head": {"w": (5, 3)}}


def _tree(rng, scale=1.0):
    return {mod: {name: (rng.randn(*shape) * scale).astype(np.float32)
                  for name, shape in leaves.items()}
            for mod, leaves in SHAPES.items()}


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict)
            else torch.from_numpy(v.copy()) for k, v in tree.items()}


SCHEDULES = {
    "constant": lambda m: m.constant_schedule(0.05),
    "cosine": lambda m: m.cosine_schedule(0.05, 4, 0.2),
    "warmup_cosine": lambda m: m.warmup_cosine(0.05, 2, 6),
}

OPTIMIZERS = {
    "sgd": lambda m, lr: m.sgd(lr),
    "momentum": lambda m, lr: m.momentum_sgd(lr),
    "momentum_wd": lambda m, lr: m.momentum_sgd(lr, weight_decay=0.01),
    "momentum_nesterov": lambda m, lr: m.momentum_sgd(lr, nesterov=True),
    "momentum_wd_nesterov": lambda m, lr: m.momentum_sgd(
        lr, 0.8, weight_decay=0.02, nesterov=True),
    "adamw": lambda m, lr: m.adamw(lr),
    "adamw_wd": lambda m, lr: m.adamw(lr, weight_decay=0.05),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_match(name):
    js, ts = SCHEDULES[name](jopt), SCHEDULES[name](topt)
    for step in range(10):
        lr = ts(step)
        assert isinstance(lr, float)
        np.testing.assert_allclose(lr, float(js(jnp.int32(step))), **TOL)


@pytest.mark.parametrize("sched", ["constant", "cosine"])
@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_five_steps_match(name, sched):
    rng = np.random.RandomState(0)
    params = _tree(rng)
    grads = [_tree(rng, 0.5) for _ in range(5)]
    jo = OPTIMIZERS[name](jopt, SCHEDULES[sched](jopt))
    to = OPTIMIZERS[name](topt, SCHEDULES[sched](topt))

    jp = jax.tree.map(jnp.asarray, params)
    js = jo.init(jp)
    tp = _torch_tree(params)
    leaves = [tp["dense"]["bias"], tp["dense"]["kernel"], tp["head"]["w"]]
    ts = to.init(tp)
    for g in grads:
        jp, js = jax.jit(jo.update)(jax.tree.map(jnp.asarray, g), js, jp)
        tp2, ts = to.update(_torch_tree(g), ts, tp)
        assert tp2 is tp
    # in place: the same tensors hold the new values
    assert tp["dense"]["bias"] is leaves[0] and tp["head"]["w"] is leaves[2]
    jflat = np.asarray(JC.flatten_pytree(jp)[0])
    np.testing.assert_allclose(C.flatten_pytree(tp)[0].numpy(), jflat, **TOL)
    assert ts["step"] == int(js["step"]) == 5
    for key in ("mu", "m", "v"):
        if key in js:
            assert ts[key].shape == (jflat.size,)
            np.testing.assert_allclose(
                ts[key].numpy(), np.asarray(JC.flatten_pytree(js[key])[0]),
                **TOL)


def test_momentum_sgd_on_the_flat_buffer_is_one_fused_launch(monkeypatch):
    calls = []
    real = fm_mod.fused_momentum

    def spy(*a, **kw):
        calls.append(kw["lr"])
        return real(*a, **kw)
    monkeypatch.setattr("repro_torch.optim.optim.fused_momentum", spy)
    rng = np.random.RandomState(1)
    w = torch.from_numpy(rng.randn(100).astype(np.float32))
    g = torch.from_numpy(rng.randn(100).astype(np.float32))
    opt = topt.momentum_sgd(topt.cosine_schedule(0.1, 10))
    state = opt.init(w)
    before = w.clone()
    for _ in range(3):
        w2, state = opt.update(g, state, w)
        assert w2 is w
    assert len(calls) == 3 and calls[0] == 0.1 and calls[1] < 0.1
    mu1 = g
    mu2 = 0.9 * mu1 + g
    mu3 = 0.9 * mu2 + g
    np.testing.assert_allclose(state["mu"].numpy(), mu3.numpy(), **TOL)
    assert not torch.equal(w, before)


def test_apply_updates_matches():
    rng = np.random.RandomState(2)
    p, u = _tree(rng), _tree(rng)
    want = jopt.apply_updates(jax.tree.map(jnp.asarray, p),
                              jax.tree.map(jnp.asarray, u), scale=-0.5)
    got = topt.apply_updates(_torch_tree(p), _torch_tree(u), scale=-0.5)
    np.testing.assert_array_equal(
        C.flatten_pytree(got)[0].numpy(),
        np.asarray(JC.flatten_pytree(want)[0]))
