"""The port's dry run (`repro_torch.launch.dryrun`) on fake 256- and
512-rank meshes (the `fake` process-group backend, `FakeTensorMode`).
Each mesh size runs in a subprocess of its own (one default process
group per process), all started at once.

- smoke cells of train, prefill and decode complete on (16, 16) and
  (2, 16, 16) and carry the reference's result keys;
- the tp layout's schedule (gemma3-4b smoke: 4 q heads of 32 over 16
  `model` ranks, so split heads): `all-gather@data` is the closed form
  of the weights' `model` shards, (n−1)/n per gather (layer leaves twice
  in train: forward and the remat'd backward), and their gradients are
  reduce-scattered once; `all-gather@model` is exactly the closed form of
  the activations it should move (block inputs along S, q/k/v, the
  reduce-scatters' gradients, the logits), so no weight moves over
  `model`;
- the dp layout (params FSDP over the whole mesh, batch over it too): the
  FLOPs per device are the one-rank FLOPs ÷ n exactly (the batch divides
  n), and the all-gather and reduce-scatter wire bytes per device are the
  closed form of the FSDP parameter bytes, (n−1)/n per gather: each
  sharded layer leaf gathered twice (forward and the remat'd backward),
  each other sharded leaf once, each gradient reduce-scattered once;
- a decode cell all-gathers fewer bytes than the rank's own cache holds
  (the sequence-sharded cache is never gathered);
- `--sync-step` on a smoke config all-gathers the compact payload over
  `pod`;
- the estimator counts the CPU flash attention's FLOPs.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
# a smoke config whose d_model and d_ff the 256-way dp layout divides
DP = dict(arch="gemma3-4b", shape="train_4k", smoke=True,
          overrides={"d_model": 256, "d_ff": 512})
REF_KEYS = {"arch", "shape", "mesh", "kind", "variant", "status",
            "n_devices", "memory", "cost", "collectives", "params",
            "active_params"}


_PRELUDE = """
import json, math, types
import torch
from repro_torch.configs import get_config
from repro_torch.dist import sharding as shl
from repro_torch.launch import dryrun
from repro_torch.models.transformer import LM
DP = %r
out = {}


def sharded_bytes(mesh_shape):
    # bf16 bytes of the dp layout's sharded params: (layer leaves, others)
    cfg = get_config(DP["arch"]).smoke()
    import dataclasses
    cfg = dataclasses.replace(cfg, **DP["overrides"])
    meta = {}
    for path, shp in LM(cfg).param_spec():
        node = meta
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = torch.empty(shp, device="meta")
    specs = shl.param_specs(meta, types.SimpleNamespace(shape=mesh_shape),
                            fsdp_axis=tuple(mesh_shape), model_axis=None)
    layer = other = 0
    for (path, t), (_, sp) in zip(shl._with_paths(meta),
                                  shl._with_paths(specs)):
        if any(e is not None for e in sp):
            if path[0] == "layers":
                layer += t.numel() * 2
            else:
                other += t.numel() * 2
    return [layer, other]


def tp_bytes(mesh_shape):
    # bf16 bytes of the tp layout's weights gathered over data: each leaf
    # sharded over data, over its model shard count (layer leaves, others)
    cfg = get_config("gemma3-4b").smoke()
    meta = {}
    for path, shp in LM(cfg).param_spec():
        node = meta
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = torch.empty(shp, device="meta")
    specs = shl.param_specs(meta, types.SimpleNamespace(shape=mesh_shape))
    layer = other = 0
    for (path, t), (_, sp) in zip(shl._with_paths(meta),
                                  shl._with_paths(specs)):
        if "data" not in sp:
            continue
        n = t.numel() * 2 // (mesh_shape["model"] if "model" in sp else 1)
        if path[0] == "layers":
            layer += n
        else:
            other += n
    return [layer, other]
""" % (DP,)


def _start(body: str) -> subprocess.Popen:
    code = _PRELUDE + textwrap.dedent(body) + \
        "\nprint('RESULT' + json.dumps(out))\n"
    return subprocess.Popen([sys.executable, "-c", code],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=dict(os.environ, PYTHONPATH=SRC))


def _result(proc: subprocess.Popen) -> dict:
    out, err = proc.communicate(timeout=240)
    assert proc.returncode == 0, err[-4000:]
    line = [x for x in out.splitlines() if x.startswith("RESULT")][-1]
    return json.loads(line[len("RESULT"):])


@pytest.fixture(scope="module")
def procs(tmp_path_factory):
    """The three mesh sizes and the CLI's sync step, one process each,
    all started at once."""
    d = tmp_path_factory.mktemp("dryrun")
    started = {
        "single": _start("""
            for shape in ("train_4k", "prefill_32k", "decode_32k"):
                out[shape] = dryrun.run_cell("gemma3-4b", shape, "single",
                                             smoke=True, verbose=False)
            out["dp"] = dryrun.run_cell(
                DP["arch"], DP["shape"], "single", layout="dp", smoke=True,
                verbose=False, overrides=DP["overrides"])
            out["dp_sharded"] = sharded_bytes({"data": 16, "model": 16})
            out["tp_sharded"] = tp_bytes({"data": 16, "model": 16})
        """),
        "multi": _start("""
            for shape in ("train_4k", "prefill_32k", "decode_32k"):
                out[shape] = dryrun.run_cell("gemma3-4b", shape, "multi",
                                             smoke=True, verbose=False)
        """),
        "one": _start("""
            out["dp"] = dryrun.run_cell(
                DP["arch"], DP["shape"], "one", layout="dp", smoke=True,
                verbose=False, overrides=DP["overrides"])
        """),
        # the CLI: the cross-process sync on the 512-rank mesh
        "sync": subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun",
             "--sync-step", "--arch", "mamba2-780m", "--smoke", "--out",
             str(d / "sync.json")], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True,
            env=dict(os.environ, PYTHONPATH=SRC)),
    }
    yield started, d
    for p in started.values():
        p.kill()


@pytest.fixture(scope="module")
def single(procs):
    return _result(procs[0]["single"])


@pytest.fixture(scope="module")
def multi(procs):
    started, d = procs
    out = _result(started["multi"])
    _, err = started["sync"].communicate(timeout=240)
    assert started["sync"].returncode == 0, err[-4000:]
    out["sync"] = json.loads((d / "sync.json").read_text())
    return out


@pytest.fixture(scope="module")
def one_rank(procs):
    return _result(procs[0]["one"])


@pytest.mark.parametrize("mesh", ["single", "multi"])
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_smoke_cells_complete_with_reference_keys(single, multi, mesh,
                                                  shape):
    res = (single if mesh == "single" else multi)[shape]
    assert REF_KEYS <= set(res), REF_KEYS - set(res)
    assert res["status"] == "ok"
    assert res["n_devices"] == (256 if mesh == "single" else 512)
    assert res["kind"] == shape.split("_")[0]
    # the reference's tp layout: FSDP over data, tensor parallelism over
    # model (and sequence parallelism for train and prefill)
    assert res["parallelism"] == \
        "FSDP over data, tensor-parallel over model" + (
            ", sequence-parallel over model" if res["kind"] != "decode"
            else "") + (", data-parallel over pod" if mesh == "multi"
                        else "")
    m = res["memory"]
    assert m["peak_bytes"] >= m["argument_bytes"] > 0
    assert m["temp_bytes"] == m["peak_bytes"] - m["argument_bytes"]
    assert res["cost"]["matmul_flops_per_device"] > 0
    coll = res["collectives"]
    for kind in ("all-gather", "all-reduce", "reduce-scatter",
                 "all-to-all"):
        assert set(coll[kind]) >= {"count", "bytes"}
    assert coll["total_bytes"] == res["cost"]["collective_bytes_per_device"]
    if res["kind"] == "train":
        # FSDP: weights gathered, gradients reduce-scattered
        assert coll["all-gather"]["count"] and coll["reduce-scatter"]["count"]
    if mesh == "multi" and res["kind"] == "train":
        # pods are data-parallel replicas: gradients all-reduced over pod
        assert any(k.startswith("all-reduce@pod") for k in coll["by_axis"])


def _activation_gathers(res) -> int:
    """Result bytes the tp layout all-gathers over `model` in a gemma3-4b
    smoke cell: activations only. Per layer, each block input gathered
    along S (attention and MLP) and q/k/v gathered over `model` (split
    heads), again in the remat'd backward, and the gradients of the two
    row-parallel reduce-scatters; the embedding's reduce-scatter gradient
    and the CE's input (train); the last positions and the logits
    (prefill); one token's q/k/v and the logits (decode)."""
    from repro_torch.configs import get_config
    cfg = get_config("gemma3-4b").smoke()
    L, d, V = cfg.n_layers, cfg.d_model, cfg.vocab
    qkv = (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim_
    n_batch = 16 * (2 if res["mesh"] == "multi" else 1)
    b, S = res["variant"]["batch"] // n_batch, res["variant"]["seq"]
    if res["kind"] == "decode":
        return 2 * L * b * qkv + 4 * b * V
    block = 2 * b * S * (2 * d + qkv)          # one forward's, bf16
    if res["kind"] == "prefill":
        return L * block + 2 * b * 16 * d + 4 * b * V
    return L * (2 * block + 2 * 2 * b * S * d) + 2 * 2 * b * S * d


@pytest.mark.parametrize("mesh", ["single", "multi"])
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_tp_layout_collectives_match_tensor_parallel_closed_form(
        single, multi, mesh, shape):
    res = (single if mesh == "single" else multi)[shape]
    layer, other = single["tp_sharded"]
    assert layer > 0 and other > 0
    n = 16
    by = res["collectives"]["by_axis"]
    gathers = 2 if res["kind"] == "train" else 1       # remat'd layers
    assert by["all-gather@data"]["wire_bytes"] == pytest.approx(
        (n - 1) / n * (gathers * layer + other), rel=1e-9)
    if res["kind"] == "train":
        assert by["reduce-scatter@data"]["wire_bytes"] == pytest.approx(
            (n - 1) / n * (layer + other), rel=1e-9)
    assert by["all-gather@model"]["bytes"] == _activation_gathers(res)


def test_dp_layout_flops_split_exactly(single, one_rank):
    n = single["dp"]["n_devices"]
    assert n == 256 and single["dp"]["variant"]["batch"] % n == 0
    assert single["dp"]["cost"]["matmul_flops_per_device"] * n == \
        one_rank["dp"]["cost"]["matmul_flops_per_device"]


def test_estimate_counts_attention_flops():
    """The CPU flash SDPA that the fake trace runs is counted as torch
    counts the CUDA ones: q·kᵀ and p·v forward; the scores recomputed,
    dP, dV, dQ and dK backward (GQA: per q head)."""
    import types

    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch import dryrun
    from repro_torch.models import attention
    B, S, H, KV, hd = 2, 64, 4, 2, 32

    def step(q, k, v):
        attention.flash_attention(q, k, v, causal=True).sum().backward()

    with FakeTensorMode():
        q, k, v = (torch.randn(B, S, h, hd, requires_grad=True)
                   for h in (H, KV, KV))
        est = dryrun.estimate(step, (q, k, v),
                              types.SimpleNamespace(mesh_dim_names=()))
    assert est["flops_per_device"] == 2 * B * H * S * S * hd * (2 + 5)


def test_dp_layout_collectives_match_fsdp_closed_form(single):
    assert single["dp"]["parallelism"] == "FSDP over (data, model)"
    n = 256
    layer, other = single["dp_sharded"]
    assert layer > 0 and other > 0
    coll = single["dp"]["collectives"]
    ag = coll["all-gather"]["wire_bytes"]
    rs = coll["reduce-scatter"]["wire_bytes"]
    assert ag == pytest.approx((n - 1) / n * (2 * layer + other), rel=1e-9)
    assert rs == pytest.approx((n - 1) / n * (layer + other), rel=1e-9)


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_decode_cell_does_not_gather_the_cache(single, multi, mesh):
    res = (single if mesh == "single" else multi)["decode_32k"]
    assert res["local_cache_bytes"] > 0
    assert res["collectives"]["all-gather"]["bytes"] < \
        res["local_cache_bytes"]


def test_sync_step_gathers_over_pod(multi):
    res = multi["sync"]
    assert res["status"] == "ok" and res["wire"] == "compact"
    ag = res["collectives"]["by_axis"]["all-gather@pod"]
    assert ag["count"] == 2 and ag["bytes"] > 0       # values and indices
