"""The cross-process pod sync (`dist.collectives.make_pod_sync` on a
`DeviceMesh`) and pod round (`dist.steps.make_pod_round_step`) on a
(pod, data, model) = (2, 2, 2) mesh of 8 gloo processes, against the
reference (`repro.dist` on a (2, 2, 2) mesh of 8 XLA host devices, in ONE
subprocess that sets XLA_FLAGS itself, as tests/test_dist.py runs it) and
against the port's one-card path (`make_pod_sync` on the mesh's shape
dict), all on the same inputs.

The sync runs 3 carried EF rounds at δ 0.05 (compact wire: payloads
all-gathered over `pod`) and δ 0.6 (dense wire: in-pod histogram counts
summed, kept values all-reduced over `pod`), either side of the
crossover. Residuals are bitwise equal to the one-card path's (the same
entries are selected and the carry is acc or 0); params within rtol 1e-5
(the dense wire's sum over pods may take another order); the wire model
is the one-card sync's, the reference's and `all_gather_bytes`. The round
(mlp_micro, k 2, compact wire) equals the one-card round: params and
residuals bitwise, the loss within rtol 1e-6 (a mean over pods). Against
the reference's round it is held at tests/test_torch_dist.py's round
tolerances (loss rtol 1e-4, params and residuals rtol 1e-3 / atol 2e-3,
the reference's own for its composed round): the k local steps train in
two frameworks, so the deltas entering the sync differ by ~1e-5.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_dist_util as D  # noqa: E402

from repro_torch.dist import collectives as col  # noqa: E402
from repro_torch.dist import steps  # noqa: E402
from repro_torch.models import small  # noqa: E402
from repro_torch.optim import momentum_sgd  # noqa: E402

MESH = {"pod": 2, "data": 2, "model": 2}
NB, BLK, ROUNDS = 8, 64, 3
RATES = (0.05, 0.6)
K, B, RBLK, LR = 2, 4, 64, 0.05
SRC = os.path.join(os.path.dirname(__file__), "..", "src")

_JAX_SIDE = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from repro.core import compression as C
from repro.dist import collectives as col
from repro.dist.steps import make_pod_round_step
from repro.models import small
from repro.optim import momentum_sgd

inp = dict(np.load(sys.argv[1]))
out = {}
mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 3)
nb, blk = inp["params0"].shape
for rate in inp["rates"]:
    tag = f"r{float(rate)}"
    sync = col.make_pod_sync(mesh, nb * blk, rate=float(rate), n_blocks=nb)
    out[tag + "_path"] = np.asarray(sync.path)
    out[tag + "_attrs"] = np.asarray(
        [sync.bytes_per_device, sync.payload_bits_per_pod], np.float64)
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
rnb, rblk = int(inp["round_nb"]), int(inp["round_blk"])
opt = momentum_sgd(float(inp["lr"]))
params = C.unflatten_pytree(flat, spec)
batches = {"image": jnp.asarray(inp["image"]),
           "label": jnp.asarray(inp["label"])}
opt_states = jax.tree.map(lambda x: jnp.stack([x] * 2), opt.init(params))
pb = jnp.concatenate([flat, jnp.zeros(rnb * rblk - dim)]).reshape(rnb, -1)
sync = col.make_pod_sync(mesh, rnb * rblk, rate=0.05, n_blocks=rnb)
step = make_pod_round_step(LM, opt, int(inp["k"]), sync, spec=spec,
                           dim=dim, n_blocks=rnb)
with mesh:
    new_pb, _, new_res, loss = jax.jit(step)(
        pb, opt_states, batches, jnp.zeros((2, rnb, rblk), jnp.float32))
out["round_params"], out["round_res"] = np.asarray(new_pb), np.asarray(new_res)
out["round_loss"] = np.asarray(loss)
out["round_bits"] = np.asarray(step.wire_bits_per_pod)
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def task():
    return small.make_task("mlp_micro", num_samples=64, test_samples=16)


@pytest.fixture(scope="module")
def inputs(task):
    rng = np.random.RandomState(3)
    nb = -(-task.dim // RBLK)
    while nb % 4:                     # the 4 in-pod shards own whole blocks
        nb += 1
    return {"params0": rng.randn(NB, BLK).astype(np.float32),
            "deltas": rng.randn(ROUNDS, 2, NB, BLK).astype(np.float32),
            "rates": np.asarray(RATES),
            "flat": (rng.randn(task.dim) * 0.3).astype(np.float32),
            "round_nb": np.asarray(nb), "round_blk": np.asarray(RBLK),
            "k": np.asarray(K), "lr": np.asarray(LR),
            "image": rng.randn(2, K, B, 8, 8, 1).astype(np.float32),
            "label": rng.randint(0, 10, (2, K, B)).astype(np.int32)}


@pytest.fixture(scope="module")
def port_out(inputs, tmp_path_factory):
    return D.spawn("pod_cases", 8, tmp_path_factory.mktemp("gloo_pod"),
                   inputs)


@pytest.fixture(scope="module")
def jax_out(inputs, tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_pod")
    np.savez(d / "in.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(_JAX_SIDE),
                        str(d / "in.npz"), str(d / "out.npz")],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n" \
        f"{r.stderr[-4000:]}"
    return dict(np.load(d / "out.npz"))


@pytest.mark.parametrize("rate", RATES)
def test_pod_sync_across_processes_matches_reference(port_out, jax_out,
                                                     rate):
    tag = f"r{rate}"
    assert str(port_out[tag + "_path"]) == str(jax_out[tag + "_path"])
    np.testing.assert_array_equal(port_out[tag + "_attrs"],
                                  jax_out[tag + "_attrs"])
    for i in range(ROUNDS):
        np.testing.assert_array_equal(
            port_out[f"{tag}_r{i}"].view(np.uint32),
            jax_out[f"{tag}_r{i}"].view(np.uint32))
        np.testing.assert_allclose(port_out[f"{tag}_p{i}"],
                                   jax_out[f"{tag}_p{i}"], rtol=1e-5,
                                   atol=1e-6)
    assert np.abs(jax_out[f"{tag}_r{ROUNDS - 1}"]).max() > 0


def test_pod_round_across_processes_matches_reference(port_out, jax_out):
    assert float(port_out["round_bits"]) == float(jax_out["round_bits"])
    np.testing.assert_allclose(float(port_out["round_loss"]),
                               float(jax_out["round_loss"]), rtol=1e-4)
    np.testing.assert_allclose(port_out["round_params"],
                               jax_out["round_params"], rtol=1e-3,
                               atol=2e-3)
    np.testing.assert_allclose(port_out["round_res"], jax_out["round_res"],
                               rtol=1e-3, atol=2e-3)
    assert np.abs(jax_out["round_res"]).max() > 0


@pytest.mark.parametrize("rate", RATES)
def test_pod_sync_across_processes_matches_one_card(port_out, inputs, rate):
    sync = col.make_pod_sync(MESH, NB * BLK, rate=rate, n_blocks=NB)
    tag = f"r{rate}"
    assert str(port_out[tag + "_path"]) == sync.path == \
        ("compact" if rate < col.density_crossover(2) else "dense")
    np.testing.assert_array_equal(
        port_out[tag + "_attrs"],
        [sync.bytes_per_device, sync.payload_bits_per_pod])
    if sync.path == "compact":
        w = sync.wire
        assert sync.bytes_per_device == col.all_gather_bytes(
            w.dim, 2, rate, n_blocks=w.n_blocks)
    p = torch.from_numpy(inputs["params0"])
    r = torch.zeros((2, NB, BLK))
    for i, d in enumerate(inputs["deltas"]):
        p, r = sync(p, torch.from_numpy(d), r)
        np.testing.assert_array_equal(port_out[f"{tag}_r{i}"], r.numpy())
        np.testing.assert_allclose(port_out[f"{tag}_p{i}"], p.numpy(),
                                   rtol=1e-5, atol=1e-6)
    assert np.abs(port_out[f"{tag}_r{ROUNDS - 1}"]).max() > 0


def test_pod_round_across_processes_matches_one_card(port_out, inputs,
                                                     task):
    class LM:
        loss = staticmethod(task.loss_fn)

    nb = int(inputs["round_nb"])
    flat = torch.from_numpy(inputs["flat"])
    opt = momentum_sgd(LR)
    sync = col.make_pod_sync(MESH, nb * RBLK, rate=0.05, n_blocks=nb)
    step = steps.make_pod_round_step(LM, opt, K, sync, spec=task.spec,
                                     dim=task.dim, n_blocks=nb)
    pb = torch.zeros(nb * RBLK)
    pb[:task.dim] = flat
    batches = {"image": torch.from_numpy(inputs["image"]),
               "label": torch.from_numpy(inputs["label"])}
    new_pb, _, new_res, loss = step(
        pb.view(nb, RBLK), [opt.init(flat.clone()) for _ in range(2)],
        batches, torch.zeros((2, nb, RBLK)))
    np.testing.assert_array_equal(port_out["round_params"], new_pb.numpy())
    np.testing.assert_array_equal(port_out["round_res"], new_res.numpy())
    np.testing.assert_allclose(float(port_out["round_loss"]), float(loss),
                               rtol=1e-6)
    assert float(port_out["round_bits"]) == step.wire_bits_per_pod
