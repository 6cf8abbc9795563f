"""The port's multi-pod layer against `repro.dist` on a (pod, data, model)
= (2, 2, 2) mesh: the wire-cost model, `make_pod_sync` on every wire over
3 carried EF rounds, and `make_pod_round_step` with the mlp_micro task.

The JAX side needs 8 host devices, so all of its outputs come from ONE
subprocess per module (a module-scoped fixture) that sets XLA_FLAGS
itself, as tests/test_dist.py does, and writes an .npz; this process keeps
its single device. Inputs are made here from numpy seeds.

Tolerances: residuals are bitwise (both sides select the same entries and
the carry is acc or 0); params at rtol 1e-5 / atol 1e-6 (the Eq. 6 mean is
summed in another order). The round step trains in two frameworks: per-pod
losses at rtol 1e-4, deltas at atol 1e-5, and the whole round at rtol 1e-3
/ atol 2e-3, the reference's own tolerance for its composed round
(tests/test_dist.py).
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.dist import collectives as jcol  # noqa: E402

from repro_torch.core import compression as C  # noqa: E402
from repro_torch.dist import collectives as col  # noqa: E402
from repro_torch.dist import steps  # noqa: E402
from repro_torch.models import small  # noqa: E402
from repro_torch.optim import momentum_sgd  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MESH = {"pod": 2, "data": 2, "model": 2}
NB, BLK, ROUNDS = 8, 64, 3
WIRES = ("compact", "reference", "dense", "auto")
RATES = (0.05, 0.6)
# round step: mlp_micro, P = 2 pods, S = 4 shards, blk = 64, k = 2, B = 4
P_PODS, K, B, RBLK, LR = 2, 2, 4, 64, 0.05

_JAX_SIDE = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from repro.core import compression as C
from repro.dist import collectives as col
from repro.dist.steps import make_local_round_step, make_pod_round_step
from repro.models import small
from repro.optim import momentum_sgd

inp = dict(np.load(sys.argv[1]))
out = {}
mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 3)
nb, blk = inp["params0"].shape
for wire in %(wires)r:
    for rate in %(rates)r:
        tag = f"{wire}_{rate}"
        sync = col.make_pod_sync(mesh, nb * blk, rate=rate, n_blocks=nb,
                                 wire=wire)
        w = sync.wire
        out[tag + "_attrs"] = np.asarray(
            [sync.bytes_per_device, sync.payload_bits_per_pod]
            + ([w.n_blocks, w.blk, w.budget] if w else [-1, -1, -1]),
            np.float64)
        out[tag + "_path"] = np.asarray(sync.path)
        js = jax.jit(sync)
        p = jnp.asarray(inp["params0"])
        r = jnp.zeros((2, nb, blk), jnp.float32)
        for i, d in enumerate(inp["deltas"]):
            with mesh:
                p, r = js(p, jnp.asarray(d), r)
            out[f"{tag}_p{i}"] = np.asarray(p)
            out[f"{tag}_r{i}"] = np.asarray(r)

task = small.make_task("mlp_micro", num_samples=64, test_samples=16)
class LM:
    loss = staticmethod(task.loss_fn)
_, spec = C.flatten_pytree(task.init_fn(jax.random.PRNGKey(0)))
flat = jnp.asarray(inp["flat"])
dim = flat.shape[0]
nb = int(inp["round_nb"])
opt = momentum_sgd(%(lr)r)
params = C.unflatten_pytree(flat, spec)
batches = {"image": jnp.asarray(inp["image"]),
           "label": jnp.asarray(inp["label"])}
P = batches["label"].shape[0]
opt_states = jax.tree.map(lambda x: jnp.stack([x] * P), opt.init(params))
pb = jnp.concatenate([flat, jnp.zeros(nb * %(blk)d - dim)]).reshape(nb, -1)
residuals = jnp.zeros((P, nb, %(blk)d), jnp.float32)
sync = col.make_pod_sync(mesh, nb * %(blk)d, rate=0.05, n_blocks=nb)
step = make_pod_round_step(LM, opt, %(k)d, sync, spec=spec, dim=dim,
                           n_blocks=nb)
with mesh:
    new_pb, _, new_res, loss = jax.jit(step)(pb, opt_states, batches,
                                             residuals)
out["round_params"], out["round_res"] = np.asarray(new_pb), np.asarray(new_res)
out["round_loss"] = np.asarray(loss)
out["round_bits"] = np.asarray(step.wire_bits_per_pod)
local = jax.jit(make_local_round_step(LM, opt, %(k)d))
for p in range(P):
    _, _, delta, l = local(params, opt.init(params),
                           jax.tree.map(lambda x: x[p], batches))
    out[f"pod{p}_loss"] = np.asarray(l)
    out[f"pod{p}_delta"] = np.asarray(C.flatten_pytree(delta)[0])
np.savez(sys.argv[2], **out)
""" % dict(wires=WIRES, rates=RATES, lr=LR, k=K, blk=RBLK)


def _round_nb(dim: int) -> int:
    nb = -(-dim // RBLK)
    while nb % 4:      # shard nb over the 4 in-pod shards
        nb += 1
    return nb


@pytest.fixture(scope="module")
def task():
    return small.make_task("mlp_micro", num_samples=64, test_samples=16)


@pytest.fixture(scope="module")
def inputs(task):
    rng = np.random.RandomState(1)
    dim = task.dim
    return {
        "params0": rng.randn(NB, BLK).astype(np.float32),
        "deltas": rng.randn(ROUNDS, 2, NB, BLK).astype(np.float32),
        "flat": (rng.randn(dim) * 0.3).astype(np.float32),
        "round_nb": np.asarray(_round_nb(dim)),
        "image": rng.randn(P_PODS, K, B, 8, 8, 1).astype(np.float32),
        "label": rng.randint(0, 10, (P_PODS, K, B)).astype(np.int32),
    }


@pytest.fixture(scope="module")
def jax_out(inputs, tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_dist")
    np.savez(d / "in.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(_JAX_SIDE),
                        str(d / "in.npz"), str(d / "out.npz")],
                       capture_output=True, text=True, env=env, timeout=900)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n" \
        f"{r.stderr[-4000:]}"
    return dict(np.load(d / "out.npz"))


def test_wire_cost_model_equal():
    for blk in (1, 7, 64, 1024):
        for rate in (0.0, 0.001, 0.05, 0.26, 0.5, 1.0, 1.7):
            assert col.block_budget(blk, rate) == jcol.block_budget(blk, rate)
            w, jw = col.CompactWire(13, blk, 5), jcol.CompactWire(13, blk, 5)
            assert (w.dim, w.payload_bytes(), w.payload_bits()) == \
                (jw.dim, jw.payload_bytes(), jw.payload_bits())
    for p in (1, 2, 3, 4, 16):
        assert col.density_crossover(p) == jcol.density_crossover(p)
        assert col.density_crossover(p, value_bytes=2, index_bytes=4) == \
            jcol.density_crossover(p, value_bytes=2, index_bytes=4)
        for dim, n_blocks in ((512, 8), (1_665_024, 1626), (4096, 1)):
            for rate in (0.001, 0.01, 0.05, 0.3):
                assert col.all_gather_bytes(dim, p, rate, n_blocks=n_blocks) \
                    == jcol.all_gather_bytes(dim, p, rate, n_blocks=n_blocks)
    with pytest.raises(ValueError):
        col.all_gather_bytes(10, 2, 0.1, n_blocks=3)


@pytest.mark.parametrize("rate", RATES)
@pytest.mark.parametrize("wire", WIRES)
def test_pod_sync_matches_jax(jax_out, inputs, wire, rate):
    tag = f"{wire}_{rate}"
    sync = col.make_pod_sync(MESH, NB * BLK, rate=rate, n_blocks=NB,
                             wire=wire)
    assert sync.path == str(jax_out[tag + "_path"])
    w = sync.wire
    attrs = [sync.bytes_per_device, sync.payload_bits_per_pod] + (
        [w.n_blocks, w.blk, w.budget] if w else [-1, -1, -1])
    assert attrs == jax_out[tag + "_attrs"].tolist()
    p = torch.from_numpy(inputs["params0"].copy())
    r = torch.zeros(2, NB, BLK)
    for i, d in enumerate(inputs["deltas"]):
        p, r = sync(p, torch.from_numpy(d.copy()), r)
        np.testing.assert_array_equal(r.numpy().view(np.uint32),
                                      jax_out[f"{tag}_r{i}"].view(np.uint32))
        np.testing.assert_allclose(p.numpy(), jax_out[f"{tag}_p{i}"],
                                   rtol=1e-5, atol=1e-6)
    assert float(r.abs().max()) > 0          # the EF carry is live


def test_pod_round_step_matches_jax(jax_out, inputs, task):
    flat = torch.from_numpy(inputs["flat"].copy())
    dim, nb = task.dim, int(inputs["round_nb"])
    assert nb == 40

    class LM:
        loss = staticmethod(task.loss_fn)
    opt = momentum_sgd(LR)
    batches = {"image": torch.from_numpy(inputs["image"]),
               "label": torch.from_numpy(inputs["label"])}
    # per-pod local rounds (Eq. 4)
    local = steps.make_local_round_step(LM, opt, K)
    params = C.unflatten_pytree(flat, task.spec)
    for p in range(P_PODS):
        _, _, delta, loss = local(params, opt.init(flat),
                                  {k: v[p] for k, v in batches.items()})
        np.testing.assert_allclose(float(loss), float(jax_out[f"pod{p}_loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(C.flatten_pytree(delta)[0].numpy(),
                                   jax_out[f"pod{p}_delta"], atol=1e-5)
    assert torch.equal(C.flatten_pytree(params)[0], flat)   # untouched
    # the whole round
    mesh = {"pod": P_PODS, "data": 2, "model": 2}
    sync = col.make_pod_sync(mesh, nb * RBLK, rate=0.05, n_blocks=nb)
    assert sync.path == "compact"
    step = steps.make_pod_round_step(LM, opt, K, sync, spec=task.spec,
                                     dim=dim, n_blocks=nb)
    assert step.wire_bits_per_pod == float(jax_out["round_bits"]) \
        == 4 * sync.wire.payload_bits()
    pb = torch.zeros(nb * RBLK)
    pb[:dim] = flat
    pb = pb.view(nb, RBLK)
    new_pb, states, new_res, loss = step(
        pb, [opt.init(flat) for _ in range(P_PODS)], batches,
        torch.zeros(P_PODS, nb, RBLK))
    assert len(states) == P_PODS and all(s["step"] == K for s in states)
    np.testing.assert_allclose(float(loss), float(jax_out["round_loss"]),
                               rtol=1e-4)
    np.testing.assert_allclose(new_pb.numpy(), jax_out["round_params"],
                               rtol=1e-3, atol=2e-3)
    np.testing.assert_allclose(new_res.numpy(), jax_out["round_res"],
                               rtol=1e-3, atol=2e-3)
    assert float(new_res.abs().max()) > 0


def test_pod_round_step_rejects_a_wrong_block_count(task):
    class LM:
        loss = staticmethod(task.loss_fn)
    sync = col.make_pod_sync(MESH, 40 * RBLK, rate=0.05, n_blocks=40)
    step = steps.make_pod_round_step(LM, momentum_sgd(LR), K, sync,
                                     spec=task.spec, dim=task.dim,
                                     n_blocks=40)
    with pytest.raises(ValueError):
        step(torch.zeros(39, RBLK), [], {}, torch.zeros(2, 39, RBLK))


@pytest.mark.parametrize("bad", [
    lambda: col.make_pod_sync(MESH, 500, rate=0.05, n_blocks=8),
    lambda: col.make_pod_sync(MESH, 6 * 64, rate=0.05, n_blocks=6),
    lambda: col.make_pod_sync(MESH, 512, rate=0.05, n_blocks=8,
                              wire="ring"),
])
def test_pod_sync_rejects_bad_layouts(bad):
    with pytest.raises(ValueError):
        bad()


def test_profile_pod_helpers_drive_a_round_on_the_cpu(task):
    """`build_pod_round`, which `chip_smoke.py` and `launch/profile_pod.py`
    build the pod round with, at mlp_micro size: the layout, the batch
    stream, the starting state, the timed sync and one round."""
    from repro_torch.launch import profile_pod as pp
    assert pp.pod_blocks(task.dim, RBLK, 4) == 40
    assert pp.pod_blocks(1_663_370, 1024, 2) == 1626
    pr = pp.build_pod_round("cpu", 0.05, task=task, mesh=MESH, blk=RBLK,
                            k=K, batch=B)
    assert (pr.dim, pr.n_blocks, pr.sync.path) == (task.dim, 40, "compact")
    assert pr.step.wire_bits_per_pod == pr.sync.payload_bits_per_pod
    batches = pr.draw()
    assert batches["image"].shape == (P_PODS, K, B, 8, 8, 1)
    assert batches["image"].dtype == torch.float32
    assert batches["label"].shape == (P_PODS, K, B)
    flat = task.init_fn(torch.Generator().manual_seed(0))
    assert torch.equal(pr.params.reshape(-1)[:task.dim], flat)
    assert not pr.params.reshape(-1)[task.dim:].any()
    assert len(pr.opt_states) == P_PODS
    assert pr.residuals.shape == (P_PODS, 40, RBLK)
    _, _, res, loss = pr.step(pr.params, pr.opt_states, batches,
                              pr.residuals)
    assert np.isfinite(float(loss)) and float(res.abs().max()) > 0
    (t0, t1), = pr.split.spans
    assert t0 <= t1
    assert pr.split.last_deltas.shape == (P_PODS, 40, RBLK)
