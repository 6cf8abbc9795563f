"""Workers of the port's multi-process tests (not a test module).

`spawn(case, world, tmp_path, inputs)` starts `world` processes with
`torch.multiprocessing.spawn`; each joins a gloo group over a `file://`
store in `tmp_path` (no ports), runs the function `case` of this module
with the numpy inputs and returns rank 0's numpy outputs. The workers
import torch, numpy and `repro_torch` only.
"""
import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def spawn(case: str, world: int, tmp_path, inputs: dict) -> dict:
    inp = os.path.join(tmp_path, f"{case}_in.npz")
    out = os.path.join(tmp_path, f"{case}_out.npz")
    np.savez(inp, **inputs)
    mp.spawn(_run, args=(world, os.path.join(tmp_path, f"{case}_store"),
                         case, inp, out), nprocs=world, join=True)
    return dict(np.load(out))


def _run(rank, world, store, case, inp, out):
    torch.set_num_threads(1)
    import logging
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        res = globals()[case](dict(np.load(inp)))
        if rank == 0:
            np.savez(out, **res)
    finally:
        dist.destroy_process_group()


def tree_from(inp: dict, prefix: str) -> dict:
    """A nested dict of tensors from the "prefix/a/b" keys of `inp`."""
    out: dict = {}
    for key, v in inp.items():
        if not key.startswith(prefix + "/"):
            continue
        node = out
        path = key[len(prefix) + 1:].split("/")
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = torch.from_numpy(np.array(v))
    return out


def flat_numpy(tree) -> np.ndarray:
    """The flat vector of a tree (DTensors gathered) in flatten order."""
    from repro_torch.dist import sharding as shl
    return np.concatenate([
        (t.full_tensor() if hasattr(t, "full_tensor") else t)
        .detach().reshape(-1).numpy() for _, t in shl._with_paths(tree)])


# ------------------------------------------------------ LM steps on a mesh
def _lm_step(inp, arch, mesh, lmkw, *, layout="tp", microbatches=1,
             zero3=None, replace=None, seed_key="params", batch_key="batch"):
    from repro_torch.configs import get_config
    from repro_torch.dist import sharding as shl
    from repro_torch.dist import steps
    from repro_torch.models import transformer as TT
    from repro_torch.optim import momentum_sgd
    cfg = dataclasses.replace(get_config(arch).smoke(), **(replace or {}))
    lm = TT.LM(cfg, dtype=torch.float32, remat=True, **lmkw)
    params = TT.params_from_jax(_numpy_tree(inp, seed_key))
    if layout == "dp":
        pspec = shl.param_specs(params, mesh, fsdp_axis=("data", "model"),
                                model_axis=None)
        lm = dataclasses.replace(lm, zero3_layer=True,
                                 layer_param_specs=shl._map(
                                     lambda _, s: shl.P(*s[1:]),
                                     pspec["layers"]))
    else:
        pspec = shl.param_specs(params, mesh)
    dparams = shl.distribute(params, pspec, mesh)
    batch = tree_from(inp, batch_key)
    bspec = shl.batch_specs(batch, mesh, batch_axes=lm.batch_axes)
    opt = momentum_sgd(float(inp["lr"]))
    state = opt.init(dparams)
    from repro_torch.kernels.fused_momentum import fused_momentum
    n0 = fused_momentum.launches
    step = steps.make_train_step(lm, opt, microbatches=microbatches,
                                 pspec=pspec, zero3_axes=zero3)
    new, state, loss = step(dparams, state, shl.distribute(batch, bspec,
                                                           mesh))
    assert fused_momentum.launches == n0     # the CPU runs its plain version
    assert new is dparams and shl.flat_local(new) is not None
    # after one step from zero momentum, mu is the step's gradient
    return float(loss), flat_numpy(new), flat_numpy(like(new, state["mu"]))


def like(params, flat: torch.Tensor):
    """The flat local buffer `flat` (an optimizer state mirroring the
    params' local layout) as DTensors shaped and laid out as `params`."""
    from torch.distributed.tensor import DTensor

    from repro_torch.dist import sharding as shl
    out, pos = {}, 0
    for path, t in shl._with_paths(params):
        loc = t.to_local()
        v = flat[pos:pos + loc.numel()].view(loc.shape)
        pos += loc.numel()
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = DTensor.from_local(v, t.device_mesh, t.placements,
                                            run_check=False, shape=t.shape,
                                            stride=t.stride())
    return out


def _numpy_tree(inp, prefix):
    return {k: _numpy(v) for k, v in tree_from(inp, prefix).items()}


def _numpy(t):
    return {k: _numpy(v) for k, v in t.items()} if isinstance(t, dict) \
        else t.numpy()


def train_cases(inp: dict) -> dict:
    """The sharded train steps of tests/test_torch_dist_steps.py on a
    (data, model) = (2, 4) mesh, and the round trip of `distribute`."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs import get_config as tget_config
    from repro_torch.dist import sharding as shl
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import moe
    from repro_torch.models import transformer as TT
    mesh = make_local_mesh(2, 4, device_type="cpu")
    out = {}
    # placements round trip: distribute, then gather or re-distribute
    params = TT.params_from_jax(_numpy_tree(inp, "params"))
    pspec = shl.param_specs(params, mesh)
    dp = shl.distribute(params, pspec, mesh)
    for path, t in shl._with_paths(params):
        d = dict(shl._with_paths(dp))[path]
        assert torch.equal(d.full_tensor(), t), path
        ref = distribute_tensor(t, mesh, shl.placements(
            dict(shl._with_paths(pspec))[path], mesh), src_data_rank=None)
        assert torch.equal(d.to_local(), ref.to_local()), path
        assert d.placements == ref.placements
    out["roundtrip_leaves"] = np.asarray(len(shl._with_paths(dp)))
    # `_constrain` lays a DTensor residual stream out as the tokens
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    x = torch.arange(8 * 64 * 4, dtype=torch.float32).view(8, 64, 4)
    lm = TT.LM(tget_config("stablelm-3b").smoke(), batch_axes=("data",),
               act_seq_axis="model")
    h = lm._constrain(distribute_tensor(x, mesh, (Replicate(),) * 2))
    assert h.placements == (Shard(0), Shard(1))
    assert torch.equal(h.full_tensor(), x)
    assert lm._constrain(x) is x

    dense = ("stablelm-3b", dict(vocab=256, n_layers=2))
    cases = {
        "dense": dict(lmkw=dict(batch_axes=("data",))),
        "zero3": dict(lmkw=dict(batch_axes=("data",)), zero3=("data",)),
        "dp": dict(lmkw=dict(batch_axes=("data", "model")), layout="dp"),
        "seq": dict(lmkw=dict(batch_axes=("data",), act_seq_axis="model")),
        "mb": dict(lmkw=dict(batch_axes=("data",), act_seq_axis="model"),
                   microbatches=4),
    }
    for name, kw in cases.items():
        out[name + "_loss"], out[name + "_params"], out[name + "_grad"] = \
            _lm_step(inp, dense[0], mesh, replace=dense[1], **kw)
    # MoE: the shard-local, expert-TP dispatch. cf 2 (capacity ≥ the
    # shard's tokens: nothing can drop) and the config's own cf 1.25
    routes = []
    real_route = moe.route

    def recording(xf, *a, **kw):
        r = real_route(xf, *a, **kw)
        routes.append((xf.detach().clone(), r["sel"].clone(),
                       r["keep"].clone()))
        return r

    moe.route = recording
    try:
        mkw = dict(lmkw=dict(batch_axes=("data",), act_seq_axis="model",
                             moe_dispatch_axes=("data",)),
                   seed_key="moe_params")
        for name, cf in (("moe2", 2.0), ("moe", 1.25)):
            routes.clear()
            out[name + "_loss"], out[name + "_params"], \
                out[name + "_grad"] = _lm_step(
                    inp, "qwen3-moe-30b-a3b", mesh, replace=dict(
                        vocab=256, n_layers=2, capacity_factor=cf), **mkw)
            fwd = routes[:2]        # the forward calls; the rest recompute
            out[name + "_sel"] = torch.stack([s for _, s, _ in fwd]).numpy()
            out[name + "_keep"] = torch.stack(
                [k for _, _, k in fwd]).numpy()
    finally:
        moe.route = real_route
    out.update(decode_cases(inp, mesh))
    out.update(tp_cases(inp, mesh))
    return out


# The tensor-parallel cases: name -> (arch, config change, (data, model)
# mesh). Each runs a train step with batch over `data` and sequence
# parallelism over `model`, from "<name>_params" on "<name>_batch".
SP = dict(batch_axes=("data",), act_seq_axis="model")
TP_CASES = {
    "tp_ssm": ("mamba2-780m", dict(vocab=256, n_layers=2), (2, 4)),
    "tp_moe": ("qwen3-moe-30b-a3b", dict(vocab=256, n_layers=2), (2, 4)),
    "tp_vlm": ("paligemma-3b", dict(vocab=256, n_layers=2), (2, 4)),
    "tp_audio": ("hubert-xlarge", dict(vocab=256, n_layers=2), (2, 4)),
    "tp_split": ("stablelm-3b", dict(vocab=256, n_layers=2), (1, 8)),
    "tp_mha": ("stablelm-3b", dict(vocab=256, n_layers=2, n_kv_heads=4),
               (2, 4)),
    "tp_hybrid": ("hymba-1.5b", dict(vocab=256, n_layers=2), (2, 4)),
}
# prefill cases on the (2, 4) mesh: name -> (arch, config change, weights)
PREFILL_CASES = {
    "pre": ("gemma3-4b", dict(vocab=128, n_layers=2), "dec_params"),
    "pre_mha": TP_CASES["tp_mha"][:2] + ("tp_mha_params",),
}


def tp_cases(inp: dict, mesh) -> dict:
    """The tensor-parallel train steps of TP_CASES, the prefills of
    PREFILL_CASES (logits and cache), and decode of the gemma3 smoke
    config with split heads on a (1, 8) mesh and of mamba2 on the (2, 4)
    mesh."""
    from repro_torch.configs import get_config
    from repro_torch.dist import sharding as shl
    from repro_torch.dist import steps
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import transformer as TT
    meshes = {(2, 4): mesh, (1, 8): make_local_mesh(1, 8, device_type="cpu")}
    out = {}
    for name, (arch, replace, shape) in TP_CASES.items():
        out[name + "_loss"], out[name + "_params"], out[name + "_grad"] = \
            _lm_step(inp, arch, meshes[shape], SP, replace=replace,
                     seed_key=name + "_params", batch_key=name + "_batch")
    # prefill: KV gathered for the cache (gemma3), and the ranks' own KV
    # heads gathered for it (MHA)
    for name, (arch, replace, key) in PREFILL_CASES.items():
        c = dataclasses.replace(get_config(arch).smoke(), **replace)
        p = TT.params_from_jax(_numpy_tree(inp, key))
        lm = TT.LM(c, dtype=torch.float32, remat=False, **SP)
        batch = tree_from(inp, "pre_batch")
        logits, cache = steps.make_prefill_step(lm)(
            shl.distribute(p, shl.param_specs(p, mesh), mesh),
            shl.distribute(batch, shl.batch_specs(batch, mesh), mesh))
        out[name + "_logits"] = logits.full_tensor().numpy()
        out[name + "_local_s"] = np.asarray(cache["k"].to_local().shape[2])
        for k, v in cache.items():
            out[f"{name}_cache/{k}"] = v.full_tensor().numpy()
    cfg = dataclasses.replace(get_config("gemma3-4b").smoke(), vocab=128,
                              n_layers=2)
    # decode: split heads (4 q heads over 8 ranks), and the SSM
    scfg = dataclasses.replace(get_config("mamba2-780m").smoke(),
                               **TP_CASES["tp_ssm"][1])
    for name, c, m, key, cache_key, tok in (
            ("dec_split", cfg, meshes[(1, 8)], "dec_params", "cache_compute",
             "token"),
            ("dec_ssm", scfg, mesh, "tp_ssm_params", "ssm_cache",
             "ssm_token")):
        lm = TT.LM(c, dtype=torch.float32, remat=False, batch_axes=("data",))
        p = TT.params_from_jax(_numpy_tree(inp, key))
        cache = tree_from(inp, cache_key)
        logits, _ = steps.make_decode_step(lm)(
            shl.distribute(p, shl.param_specs(p, m), m),
            shl.distribute(cache, shl.cache_specs(cache, m,
                                                  batch_axes=("data",)), m),
            torch.from_numpy(inp[tok]), int(inp["cur_index"]))
        out[name + "_logits"] = logits.full_tensor().numpy()
    return out



def decode_cases(inp: dict, mesh) -> dict:
    """One decode step of gemma3-4b (smoke) on DTensor params and a cache
    sequence-sharded over `model`, compute and int8 caches."""
    from repro_torch.configs import get_config
    from repro_torch.dist import sharding as shl
    from repro_torch.dist import steps
    from repro_torch.models import transformer as TT
    cfg = dataclasses.replace(get_config("gemma3-4b").smoke(), vocab=128,
                              n_layers=2)
    out = {}
    params = TT.params_from_jax(_numpy_tree(inp, "dec_params"))
    dparams = shl.distribute(params, shl.param_specs(params, mesh), mesh)
    for kv in ("compute", "int8"):
        lm = TT.LM(cfg, dtype=torch.float32, remat=False, kv_dtype=kv,
                   batch_axes=("data",))
        cache = tree_from(inp, "cache_" + kv)
        cspec = shl.cache_specs(cache, mesh, batch_axes=("data",))
        dcache = shl.distribute(cache, cspec, mesh)
        logits, dcache = steps.make_decode_step(lm)(
            dparams, dcache, torch.from_numpy(inp["token"]),
            int(inp["cur_index"]))
        out[f"dec_{kv}_logits"] = logits.full_tensor().numpy()
        out[f"dec_{kv}_local_s"] = np.asarray(
            [dcache[k].to_local().shape[2] for k in sorted(dcache)])
        for k in sorted(dcache):
            out[f"dec_{kv}_cache/{k}"] = dcache[k].full_tensor().numpy()
    return out


# ------------------------------------------------------ pod sync over ranks
def pod_cases(inp: dict) -> dict:
    """`make_pod_sync` and `make_pod_round_step` with one process per
    (pod, in-pod shard) of a (pod, data, model) = (2, 2, 2) mesh: the
    gathered params and residuals of every round, and the wire model."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.dist import collectives as col
    from repro_torch.dist import sharding as shl
    from repro_torch.dist import steps
    from repro_torch.models import small
    from repro_torch.optim import momentum_sgd
    mesh = init_device_mesh("cpu", (2, 2, 2),
                            mesh_dim_names=("pod", "data", "model"))
    pspec = {"x": shl.P(("data", "model"), None)}
    dspec = {"x": shl.P("pod", ("data", "model"), None)}
    put = lambda t, spec: shl.distribute({"x": t}, spec, mesh)["x"]
    nb, blk = inp["params0"].shape
    out = {}
    for rate in inp["rates"]:
        tag = f"r{float(rate)}"
        sync = col.make_pod_sync(mesh, nb * blk, rate=float(rate),
                                 n_blocks=nb)
        out[tag + "_path"] = np.asarray(sync.path)
        out[tag + "_attrs"] = np.asarray(
            [sync.bytes_per_device, sync.payload_bits_per_pod])
        p = put(torch.from_numpy(inp["params0"]), pspec)
        r = put(torch.zeros((2, nb, blk)), dspec)
        for i, d in enumerate(inp["deltas"]):
            p, r = sync(p, put(torch.from_numpy(d), dspec), r)
            out[f"{tag}_p{i}"] = p.full_tensor().numpy()
            out[f"{tag}_r{i}"] = r.full_tensor().numpy()
    # the pod round: mlp_micro, k local steps per pod, compact wire
    task = small.make_task("mlp_micro", num_samples=64, test_samples=16)

    class LM:
        loss = staticmethod(task.loss_fn)

    flat = torch.from_numpy(inp["flat"])
    spec, dim = task.spec, flat.numel()
    rnb, rblk = int(inp["round_nb"]), int(inp["round_blk"])
    opt = momentum_sgd(float(inp["lr"]))
    sync = col.make_pod_sync(mesh, rnb * rblk, rate=0.05, n_blocks=rnb)
    step = steps.make_pod_round_step(LM, opt, int(inp["k"]), sync,
                                     spec=spec, dim=dim, n_blocks=rnb)
    pb = torch.zeros(rnb * rblk)
    pb[:dim] = flat
    states = [opt.init(flat.clone()) for _ in range(2)]
    batches = {"image": torch.from_numpy(inp["image"]),
               "label": torch.from_numpy(inp["label"])}
    new_pb, new_states, new_res, loss = step(
        put(pb.view(rnb, rblk), pspec), states, batches,
        put(torch.zeros((2, rnb, rblk)), dspec))
    out["round_params"] = new_pb.full_tensor().numpy()
    out["round_res"] = new_res.full_tensor().numpy()
    out["round_loss"] = np.asarray(float(loss))
    out["round_bits"] = np.asarray(step.wire_bits_per_pod)
    return out



# ------------------------------------------------ batches placed on a mesh
class _Rows:
    """A dataset whose batch is its rows (an int matrix, a float vector)
    and a 0-d scale."""

    def __init__(self, n: int):
        self.x = np.arange(n * 3, dtype=np.int64).reshape(n, 3)

    def __len__(self):
        return len(self.x)

    def batch(self, idx):
        return {"x": self.x[idx], "w": self.x[idx, 0].astype(np.float32),
                "scale": np.float32(0.5)}


def sharded_batch_case(inp: dict) -> dict:
    """`data.sharded_batches` on a (data, model) = (2, 1) mesh: `draws`
    batches; every rank asserts that it holds its own rows of the host
    batch and the whole scale, and that each local shard equals the
    reference's shard at its place in the mesh ("ref_<leaf><draw>/<data
    index>"); rank 0's local rows come back."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.data import DataLoader, sharded_batches
    from repro_torch.launch.mesh import make_local_mesh
    mesh = make_local_mesh(2, 1, device_type="cpu")
    rank = mesh.get_local_rank("data")
    seed, bs = int(inp["seed"]), int(inp["batch"])
    host = DataLoader(_Rows(16), batch_size=bs, seed=seed)
    it = sharded_batches(DataLoader(_Rows(16), batch_size=bs, seed=seed),
                         mesh)
    out = {}
    for i in range(int(inp["draws"])):
        want, got = host.next(), next(it)
        rows = slice(rank * bs // 2, (rank + 1) * bs // 2)
        assert sorted(got) == sorted(want)
        for k in ("x", "w"):
            assert got[k].placements == (Shard(0), Replicate()), k
            assert torch.equal(got[k].to_local(),
                               torch.from_numpy(want[k][rows])), k
            assert torch.equal(got[k].full_tensor(),
                               torch.from_numpy(want[k])), k
        assert got["scale"].placements == (Replicate(), Replicate())
        assert float(got["scale"].to_local()) == 0.5
        for k, v in got.items():
            # the same values and kind (jax without x64 narrows the int64
            # rows to int32; the port keeps the host dtype)
            mine, ref = v.to_local().numpy(), inp[f"ref_{k}{i}/{rank}"]
            assert mine.dtype.kind == ref.dtype.kind, k
            assert mine.shape == ref.shape and np.array_equal(mine, ref), k
        out[f"x{i}"] = got["x"].to_local().numpy()
        out[f"host{i}"] = want["x"]
    return out
