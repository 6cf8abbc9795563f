"""The port's LM step builders on a (data, model) = (2, 4) mesh of 8 gloo
processes, against `repro.dist.steps` and against the port's own
one-process step.

Cases (`tests/torch_dist_util.py::train_cases`, one spawn for all):
stablelm smoke at vocab 256, 2 layers, fp32, remat, batch (8, 64) —
data-parallel over `data` with FSDP/TP-sharded params at rest, with
`zero3_axes`, the dp layout (`zero3_layer`: params FSDP over the whole
mesh, batch over both axes), sequence parallelism (`act_seq_axis`) and
`microbatches=4`; qwen3-moe smoke with the shard-local MoE dispatch
(`moe_dispatch_axes`) at capacity factor 2 (capacity covers every slot of
a shard, so nothing drops) and at its own 1.25; one gemma3 smoke decode
step on a cache sequence-sharded over `model`, compute and int8. With
the tp layout's params these run tensor-parallel over `model`. The tensor-parallel cases (`TP_CASES`, `PREFILL_CASES`) are
held against the reference's GSPMD step on the same jax mesh: mamba2
(in_proj gathered), qwen3-moe with the global dispatch, paligemma
(patches, 1 KV head), hubert (the frames head), stablelm as MHA (each
rank its own KV heads) and with 4 q heads over a (1, 8) mesh (split
heads), hymba (attention and SSM heads in one block); prefill with
gathered and with own KV heads; decode with split heads and of the SSM.
The reference side runs as tests/test_dist.py runs it: one subprocess
with 8 XLA host devices.

Tolerances: the sharded loss against the reference's unsharded step at
rtol 2e-4 (tests/test_dist.py's); the stepped params at rtol 1e-4 / atol
1e-6; the step's gradient (the momentum after one step from zero) per
leaf at SHARD_GRAD_TOL, how far the reference's own sharded gradient is
from its unsharded one (asserted here too: `LM.loss` takes its logits in
bf16, so a batch split changes what is rounded; in the port the tied
embedding's gradient moves most, as each rank sums its chunks' bf16
gradient before the ranks sum in fp32); `microbatches=4` against the full
batch at rtol 1e-5 (loss) and rtol 1e-4 / atol 1e-6 (params),
tests/test_dist.py's; decode logits at `LOGITS_TOL`, the cache at rtol
1e-5 / atol 1e-6 (every slot but the one written bitwise), int8 logits
against the reference at atol 1e-2
(tests/test_torch_lm_decode.py says why). The tensor-parallel cases: the
loss at rtol 2e-4, the gradient and the update the step applied (−lr·g
from the same weights) per leaf at SHARD_GRAD_TOL, prefill logits and
cache and decode logits at `LOGITS_TOL`; their row-parallel partial sums
are added in another order than one matmul's, as the reference's are.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_dist_util as D  # noqa: E402
import torch_lm_util as U  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import transformer as JT  # noqa: E402

from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.dist import steps  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.optim import momentum_sgd  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
LR = 0.01
B, S = 8, 64
DENSE = ("stablelm-3b", dict(vocab=256, n_layers=2))
MOE = ("qwen3-moe-30b-a3b", dict(vocab=256, n_layers=2))
DEC = ("gemma3-4b", dict(vocab=128, n_layers=2))
DEC_B, DEC_S, CUR = 4, 64, 40
INT8_TOL = dict(rtol=1e-4, atol=1e-2)
# per leaf (relative L2, max abs / max |g|) between a sharded step's
# gradient and an unsharded one's: the reference's own sharded step moves
# its gradient this far (asserted below), since `LM.loss` takes bf16
# logits and a batch split changes what is rounded
SHARD_GRAD_TOL = (4e-3, 5e-3)

_JAX_SIDE = """
import os, sys, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.core import compression as C
from repro.dist import sharding as shl
from repro.dist.steps import (make_decode_step, make_prefill_step,
                              make_train_step)
from repro.models.transformer import LM
from repro.optim import momentum_sgd

inp = dict(np.load(sys.argv[1]))
out = {}

def tree(prefix):
    t = {}
    for k, v in inp.items():
        if k.startswith(prefix + "/"):
            node = t
            path = k[len(prefix) + 1:].split("/")
            for p in path[:-1]:
                node = node.setdefault(p, {})
            node[path[-1]] = jnp.asarray(v)
    return t

opt = momentum_sgd(float(inp["lr"]))

def make_mesh(shape):
    return jax.make_mesh(shape, ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)

def step(arch, replace, key, mb=1, batch_key="batch", shape=(2, 4),
         **lmkw):
    cfg = dataclasses.replace(get_config(arch).smoke(), **replace)
    lm = LM(cfg, dtype=jnp.float32, remat=True, **lmkw)
    params = tree(key)
    batch = tree(batch_key)
    st = opt.init(params)
    fn = make_train_step(lm, opt, microbatches=mb)
    if not lmkw:
        p, st, loss = jax.jit(fn)(params, st, batch)
    else:
        mesh = make_mesh(shape)
        ps = shl.param_specs(params, mesh)
        os_ = shl.opt_state_specs(jax.eval_shape(lambda: st), ps, mesh)
        bs = shl.batch_specs(batch, mesh, batch_axes=("data",))
        ns = lambda t: shl.named(t, mesh)
        with jax.set_mesh(mesh):
            p, st, loss = jax.jit(fn, in_shardings=(ns(ps), ns(os_), ns(bs)),
                                 out_shardings=(ns(ps), ns(os_),
                                                NamedSharding(mesh, P())))(
                params, st, batch)
    # one step from zero momentum: mu is the step's gradient
    return (float(loss), np.asarray(C.flatten_pytree(p)[0]),
            np.asarray(C.flatten_pytree(st["mu"])[0]))

out["dense_loss"], out["dense_params"], out["dense_grad"] = step(
    %(dense)r, %(dense_kw)r, "params")
out["dense_sh_loss"], out["dense_sh_params"], out["dense_sh_grad"] = step(
    %(dense)r, %(dense_kw)r, "params", batch_axes=("data",))
out["mb_loss"], out["mb_params"], out["mb_grad"] = step(
    %(dense)r, %(dense_kw)r, "params", mb=4)
out["moe2_loss"], _, _ = step(%(moe)r, dict(%(moe_kw)r, capacity_factor=2.0),
                              "moe_params")
out["moe_loss"], out["moe_params"], out["moe_grad"] = step(
    %(moe)r, dict(%(moe_kw)r, capacity_factor=1.25), "moe_params",
    batch_axes=("data",), moe_dispatch_axes=("data",), act_seq_axis="model")
cfg = dataclasses.replace(get_config(%(dec)r).smoke(), **%(dec_kw)r)
for kv in ("compute", "int8"):
    lm = LM(cfg, dtype=jnp.float32, remat=False, kv_dtype=kv)
    logits, _ = jax.jit(lm.decode_step)(tree("dec_params"),
                                        tree("cache_" + kv),
                                        jnp.asarray(inp["token"], jnp.int32),
                                        jnp.int32(int(inp["cur_index"])))
    out["dec_%%s_logits" %% kv] = np.asarray(logits)

# tensor parallelism over `model`, sequence parallelism for train/prefill
sp = dict(batch_axes=("data",), act_seq_axis="model")
out["tp_dense_loss"], out["tp_dense_params"], out["tp_dense_grad"] = step(
    %(dense)r, %(dense_kw)r, "params", **sp)
for name, (arch, replace, shape) in %(tp)r.items():
    out[name + "_loss"], out[name + "_params"], out[name + "_grad"] = step(
        arch, replace, name + "_params", batch_key=name + "_batch",
        shape=tuple(shape), **sp)
ns = lambda t, mesh: shl.named(t, mesh)
mesh = make_mesh((2, 4))
pb = tree("pre_batch")
for name, (arch, replace, key) in %(pre)r.items():
    lm = LM(dataclasses.replace(get_config(arch).smoke(), **replace),
            dtype=jnp.float32, remat=False, **sp)
    params = tree(key)
    with jax.set_mesh(mesh):
        logits, cache = jax.jit(make_prefill_step(lm), in_shardings=(
            ns(shl.param_specs(params, mesh), mesh),
            ns(shl.batch_specs(pb, mesh, batch_axes=("data",)), mesh)))(
                params, pb)
    out[name + "_logits"] = np.asarray(logits)
    for k, v in cache.items():
        out[f"{name}_cache/{k}"] = np.asarray(v)
scfg = dataclasses.replace(get_config("mamba2-780m").smoke(),
                           **%(tp)r["tp_ssm"][1])
for name, c, shape, key, cache_key, tok in (
        ("dec_split", cfg, (1, 8), "dec_params", "cache_compute", "token"),
        ("dec_ssm", scfg, (2, 4), "tp_ssm_params", "ssm_cache",
         "ssm_token")):
    mesh = make_mesh(shape)
    lm = LM(c, dtype=jnp.float32, remat=False, batch_axes=("data",))
    params, cache = tree(key), tree(cache_key)
    token = jnp.asarray(inp[tok], jnp.int32)
    with jax.set_mesh(mesh):
        logits, _ = jax.jit(make_decode_step(lm), in_shardings=(
            ns(shl.param_specs(params, mesh), mesh),
            ns(shl.cache_specs(cache, mesh, batch_axes=("data",)), mesh),
            ns(shl.batch_specs({"t": token}, mesh,
                               batch_axes=("data",))["t"], mesh),
            NamedSharding(mesh, P())))(params, cache, token,
                                       jnp.int32(int(inp["cur_index"])))
    out[name + "_logits"] = np.asarray(logits)
np.savez(sys.argv[2], **out)
""" % dict(dense=DENSE[0], dense_kw=DENSE[1], moe=MOE[0], moe_kw=MOE[1],
           dec=DEC[0], dec_kw=DEC[1], tp=D.TP_CASES, pre=D.PREFILL_CASES)


def _flat_keys(tree, prefix) -> dict:
    out = {}
    for path, v in jax.tree_util.tree_leaves_with_path(tree):
        out[prefix + "/" + "/".join(str(p.key) for p in path)] = \
            np.asarray(v)
    return out


def _jmodel(arch, replace, **kw):
    cfg = dataclasses.replace(jget_config(arch).smoke(), **replace)
    return JT.LM(cfg, dtype=jnp.float32, remat=False, **kw)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(0)
    inp = {"lr": np.asarray(LR), "token": rng.randint(0, 128, (DEC_B, 1)),
           "cur_index": np.asarray(CUR),
           "batch/tokens": rng.randint(0, 256, (B, S)).astype(np.int32),
           "batch/labels": rng.randint(0, 256, (B, S)).astype(np.int32)}
    inp.update(_flat_keys(U.numpy_params(_jmodel(*DENSE), seed=1), "params"))
    inp.update(_flat_keys(U.numpy_params(_jmodel(*MOE), seed=2),
                          "moe_params"))
    inp.update(_flat_keys(U.numpy_params(_jmodel(*DEC), seed=3),
                          "dec_params"))
    for i, (name, (arch, replace, _)) in enumerate(D.TP_CASES.items()):
        jlm = _jmodel(arch, replace)
        inp.update(_flat_keys(U.numpy_params(jlm, seed=10 + i),
                              name + "_params"))
        inp.update({f"{name}_batch/{k}": v for k, v in U.batch(
            jlm.cfg, B=B, S=S, seed=10 + i).items()})
    inp["pre_batch/tokens"] = rng.randint(0, 128, (DEC_B, DEC_S)).astype(
        np.int32)
    inp["ssm_token"] = rng.randint(0, 256, (DEC_B, 1))
    ssm = _jmodel(*D.TP_CASES["tp_ssm"][:2]).cache_specs(DEC_B, DEC_S)
    for k, sd in ssm.items():
        inp["ssm_cache/" + k] = (rng.randn(*sd.shape)
                                 * (0.1 if k == "ssm" else 1.0)
                                 ).astype(np.float32)
    for kv in ("compute", "int8"):
        shapes = _jmodel(*DEC, kv_dtype=kv).cache_specs(DEC_B, DEC_S)
        for k, sd in shapes.items():
            if sd.dtype == jnp.int8:
                v = rng.randint(-127, 128, sd.shape).astype(np.int8)
            elif k.endswith("scale"):
                v = (rng.rand(*sd.shape) * 0.02).astype(np.float32)
            else:
                v = rng.randn(*sd.shape).astype(np.float32)
            inp[f"cache_{kv}/{k}"] = v
    return inp


@pytest.fixture(scope="module")
def jax_proc(inputs, tmp_path_factory):
    """The reference side, started at once so that it runs while the
    port's processes do."""
    d = tmp_path_factory.mktemp("jax_steps")
    np.savez(d / "in.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen([sys.executable, "-c", _JAX_SIDE,
                             str(d / "in.npz"), str(d / "out.npz")],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)
    yield proc, d / "out.npz"
    proc.kill()


@pytest.fixture(scope="module")
def jax_out(jax_proc):
    proc, out = jax_proc
    _, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-4000:]
    return dict(np.load(out))


@pytest.fixture(scope="module")
def port_out(inputs, jax_proc, tmp_path_factory):
    return D.spawn("train_cases", 8, tmp_path_factory.mktemp("gloo_steps"),
                   inputs)


def _tree(inputs, prefix):
    return TT.params_from_jax(D._numpy_tree(inputs, prefix))


def _one_process_step(inputs, arch, replace, key, mb=1):
    cfg = dataclasses.replace(tget_config(arch).smoke(), **replace)
    lm = TT.LM(cfg, dtype=torch.float32, remat=True)
    params = _tree(inputs, key)
    opt = momentum_sgd(LR)
    batch = D.tree_from(inputs, "batch")
    _, state, loss = steps.make_train_step(lm, opt, microbatches=mb)(
        params, opt.init(params), batch)
    return float(loss), D.flat_numpy(params), state["mu"].numpy()


@pytest.fixture(scope="module")
def one(inputs):
    out = {}
    out["dense"] = _one_process_step(inputs, *DENSE, "params")
    out["mb"] = _one_process_step(inputs, *DENSE, "params", mb=4)
    out["moe2"] = _one_process_step(
        inputs, MOE[0], dict(MOE[1], capacity_factor=2.0), "moe_params")
    return out


def _spec(arch, replace):
    cfg = dataclasses.replace(tget_config(arch).smoke(), **replace)
    return TT.LM(cfg).param_spec()


def test_distribute_round_trips(port_out):
    """Every leaf: gathered back bitwise, and its local shard is what
    `distribute_tensor` puts on the rank (asserted on all 8 ranks)."""
    assert int(port_out["roundtrip_leaves"]) > 10


def test_reference_sharded_gradient_spread(jax_out):
    """The basis of SHARD_GRAD_TOL: the reference's sharded step's
    gradient against its unsharded step's."""
    U.assert_grads_close(jax_out["dense_sh_grad"], jax_out["dense_grad"],
                         _spec(*DENSE), SHARD_GRAD_TOL)
    np.testing.assert_allclose(float(jax_out["dense_sh_loss"]),
                               float(jax_out["dense_loss"]), rtol=2e-4)


@pytest.mark.parametrize("case", ["dense", "zero3", "dp", "seq"])
def test_sharded_train_step_matches_reference(port_out, jax_out, one, case):
    np.testing.assert_allclose(float(port_out[case + "_loss"]),
                               float(jax_out["dense_loss"]), rtol=2e-4)
    np.testing.assert_allclose(port_out[case + "_params"], one["dense"][1],
                               rtol=1e-4, atol=1e-6)
    spec = _spec(*DENSE)
    U.assert_grads_close(port_out[case + "_grad"], one["dense"][2], spec,
                         SHARD_GRAD_TOL)
    U.assert_grads_close(port_out[case + "_grad"], jax_out["dense_grad"],
                         spec, SHARD_GRAD_TOL)


def test_microbatched_step_matches_full_batch_and_reference(port_out,
                                                            jax_out, one):
    mb_loss, mb_p = float(port_out["mb_loss"]), port_out["mb_params"]
    np.testing.assert_allclose(mb_loss, one["dense"][0], rtol=1e-5)
    np.testing.assert_allclose(mb_p, one["dense"][1], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(one["mb"][0], one["dense"][0], rtol=1e-5)
    np.testing.assert_allclose(one["mb"][1], one["dense"][1], rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(mb_loss, float(jax_out["mb_loss"]),
                               rtol=U.LOSS_RTOL)
    np.testing.assert_allclose(mb_p, jax_out["mb_params"], rtol=1e-4,
                               atol=1e-6)
    U.assert_grads_close(port_out["mb_grad"], jax_out["mb_grad"],
                         _spec(*DENSE), SHARD_GRAD_TOL)


def _unsharded_routes(inputs, cf):
    """(sel, keep) of the port's one-process MoE forward, per layer."""
    cfg = dataclasses.replace(tget_config(MOE[0]).smoke(), **MOE[1],
                              capacity_factor=cf)
    lm = TT.LM(cfg, dtype=torch.float32, remat=False)
    seen = []
    real = moe.route

    def recording(xf, *a, **kw):
        r = real(xf, *a, **kw)
        seen.append((xf, r["sel"], r["keep"]))
        return r

    moe.route = recording
    try:
        with torch.no_grad():
            lm.loss(_tree(inputs, "moe_params"), D.tree_from(inputs, "batch"))
    finally:
        moe.route = real
    return seen


def test_sharded_moe_without_drops_matches_unsharded(port_out, jax_out, one,
                                                     inputs):
    """Capacity factor 2: a shard's capacity covers all its slots, so the
    shard-local dispatch routes and drops (none) as the unsharded one and
    the step is the unsharded reference's."""
    seen = _unsharded_routes(inputs, 2.0)
    rows = B // 2 * S                   # rank 0 = batch shard 0, all of S
    for layer, (_, sel, keep) in enumerate(seen):
        np.testing.assert_array_equal(port_out["moe2_sel"][layer],
                                      sel[:rows].numpy())
        assert keep.all() and port_out["moe2_keep"][layer].all()
    np.testing.assert_allclose(float(port_out["moe2_loss"]),
                               float(jax_out["moe2_loss"]), rtol=2e-4)
    np.testing.assert_allclose(port_out["moe2_params"], one["moe2"][1],
                               rtol=1e-4, atol=1e-6)
    U.assert_grads_close(port_out["moe2_grad"], one["moe2"][2], _spec(*MOE),
                         SHARD_GRAD_TOL)


def test_sharded_moe_matches_reference_sharded_dispatch(port_out, jax_out,
                                                        one, inputs):
    """Capacity factor 1.25: each shard dispatches alone, as the
    reference's shard_map does. Rank 0's drops are the unsharded
    dispatch's over its own tokens, and the step is the reference's
    sharded step."""
    x, sel, keep = _unsharded_routes(inputs, 1.25)[0]    # layer 0: the
    rows = B // 2 * S                 # later layers' inputs differ by drops
    np.testing.assert_array_equal(port_out["moe_sel"][0], sel[:rows].numpy())
    router = _tree(inputs, "moe_params")["layers"]["moe"]["router"]["kernel"]
    r = moe.route(x[:rows], router[0], n_experts=4, top_k=2,
                  capacity_factor=1.25)
    np.testing.assert_array_equal(port_out["moe_keep"][0],
                                  r["keep"].numpy())
    # this case drops, and not the global dispatch's slots
    assert not port_out["moe_keep"][0].all()
    assert not np.array_equal(port_out["moe_keep"][0], keep[:rows].numpy())
    np.testing.assert_allclose(float(port_out["moe_loss"]),
                               float(jax_out["moe_loss"]), rtol=2e-4)
    np.testing.assert_allclose(port_out["moe_params"], jax_out["moe_params"],
                               rtol=1e-4, atol=1e-6)
    U.assert_grads_close(port_out["moe_grad"], jax_out["moe_grad"],
                         _spec(*MOE), SHARD_GRAD_TOL)


@pytest.mark.parametrize("kv", ["compute", "int8"])
def test_decode_with_sequence_sharded_cache(port_out, jax_out, inputs, kv):
    # the cache really is sharded: each rank holds S/4 of every KV leaf
    assert (port_out[f"dec_{kv}_local_s"] == DEC_S // 4).all()
    cfg = dataclasses.replace(tget_config(DEC[0]).smoke(), **DEC[1])
    lm = TT.LM(cfg, dtype=torch.float32, remat=False, kv_dtype=kv)
    cache = D.tree_from(inputs, "cache_" + kv)
    with torch.no_grad():
        logits, cache = lm.decode_step(_tree(inputs, "dec_params"), cache,
                                       torch.from_numpy(inputs["token"]),
                                       CUR)
    got = port_out[f"dec_{kv}_logits"]
    np.testing.assert_allclose(got, logits.numpy(), **U.LOGITS_TOL)
    for k, v in cache.items():
        mine, want = port_out[f"dec_{kv}_cache/{k}"], v.numpy()
        np.testing.assert_allclose(mine, want, rtol=1e-5, atol=1e-6)
        # every position but the one written is untouched
        rest = np.arange(DEC_S) != CUR
        np.testing.assert_array_equal(mine[:, :, rest], want[:, :, rest])
    np.testing.assert_allclose(got, jax_out[f"dec_{kv}_logits"],
                               **(U.LOGITS_TOL if kv == "compute"
                                  else INT8_TOL))


# the port's tensor-parallel steps against the reference's GSPMD steps on
# the same jax mesh
# (port case, reference case, weights, arch, config change)
TP_PAIRS = [("dense", "dense_sh", "params") + DENSE,
            ("seq", "tp_dense", "params") + DENSE] + [
    (name, name, name + "_params", arch, replace)
    for name, (arch, replace, _) in D.TP_CASES.items()]


@pytest.mark.parametrize("case,ref,key,arch,replace", TP_PAIRS,
                         ids=[p[0] for p in TP_PAIRS])
def test_tensor_parallel_step_matches_reference_gspmd(port_out, jax_out,
                                                      inputs, case, ref,
                                                      key, arch, replace):
    """Dense (whole q heads, KV gathered), split heads on (1, 8), SSM,
    MoE with the global dispatch, vlm (patches, 1 KV head), audio (the
    frames head), with and without sequence parallelism."""
    np.testing.assert_allclose(float(port_out[case + "_loss"]),
                               float(jax_out[ref + "_loss"]), rtol=2e-4)
    spec = _spec(arch, replace)
    U.assert_grads_close(port_out[case + "_grad"], jax_out[ref + "_grad"],
                         spec, SHARD_GRAD_TOL)
    # the update the step applied (-lr·g from the same weights), held as
    # the gradient is
    p0 = D.flat_numpy(_tree(inputs, key))
    U.assert_grads_close((p0 - port_out[case + "_params"]) / LR,
                         (p0 - jax_out[ref + "_params"]) / LR, spec,
                         SHARD_GRAD_TOL)


@pytest.mark.parametrize("case", list(D.PREFILL_CASES))
def test_tensor_parallel_prefill_matches_reference_gspmd(port_out, jax_out,
                                                         case):
    """Prefill with sequence parallelism: the last logits, and the cache
    handed over to the decode layout (S over `model`, every KV head) from
    gathered KV (gemma3: 2 KV heads over 4 ranks) and from the ranks' own
    KV heads (MHA)."""
    assert int(port_out[case + "_local_s"]) == DEC_S // 4
    np.testing.assert_allclose(port_out[case + "_logits"],
                               jax_out[case + "_logits"], **U.LOGITS_TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(port_out[f"{case}_cache/{k}"],
                                   jax_out[f"{case}_cache/{k}"],
                                   **U.LOGITS_TOL)


@pytest.mark.parametrize("case", ["dec_split", "dec_ssm"])
def test_tensor_parallel_decode_matches_reference_gspmd(port_out, jax_out,
                                                        case):
    """Decode with split heads (gemma3 smoke, 4 q heads over 8 ranks) and
    of the SSM (mamba2 smoke: in_proj gathered, out_proj row-parallel)."""
    np.testing.assert_allclose(port_out[case + "_logits"],
                               jax_out[case + "_logits"], **U.LOGITS_TOL)
