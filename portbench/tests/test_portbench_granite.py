"""The granite-4.0-h-micro configuration and its cell at a CPU size: the
plain reference against `transformers`' GraniteMoeHybridForCausalLM with
the weights mapped leaf by leaf, its FLOP count against a closed form,
the configuration's context against its traffic, the readers of the two
per-layer launch metrics on hand-made traces, and whole runs of the
cell: the program correct, the TF32 control and each planted fault not.

The cell's own shrink: width 64, two periods of the layer pattern (20
layers), 64-token sequences, vocab 512 (`small_cells.py` shrinks the
Mamba-2 LM's keys only)."""
from __future__ import annotations

import math
import time
import types

import pytest
import torch

from portbench.tests.small_cells import one_thread  # noqa: F401
from portbench.tests.test_portbench_imports import top_level
from portbench import calibrate
from portbench.harness import compare, faults, inputs, main, spec
from portbench.harness.pod import port_arch
from portbench.reference import granite_hybrid as G
from portbench.reference.precision import Precision

W = "granite-4.0-h-micro.pod_compact_4k"
BENCH = spec.load_benchmark()
R = spec.metric_reader


def small() -> dict:
    cell = spec.resolve(BENCH, W)
    cell["config"].update(
        hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
        mamba_d_head=16, mamba_n_heads=8, mamba_d_state=16,
        mamba_chunk_size=32, shared_intermediate_size=128,
        intermediate_size=128, vocab_size=512, num_hidden_layers=20,
        context=64)
    cell["traffic"].update(seq_len=64, token_rows=64, blk=64)
    return cell


def test_widths_are_the_ports():
    """Every size the file gives the port is the registry's granite
    config but the depth, which is one whole period of layer_types."""
    cfg = spec.resolve(BENCH, W)["config"]
    from repro_torch.configs import get_config
    full, run = get_config(cfg["arch"]), port_arch(cfg)
    for field in cfg["arch_fields"]:
        if field != "n_layers":
            assert getattr(run, field) == getattr(full, field), field
    assert run.n_layers == 10 and cfg["vocab_size"] == 100352
    assert run.layer_mixers() == full.layer_mixers()[:10] == G.kinds(cfg)
    assert [c for c in BENCH["configs"] if c["name"] == cfg["name"]][0][
        "reduced"] == ["num_hidden_layers"]


def test_reference_loads_nothing_of_the_port():
    names = top_level("from portbench.reference import granite_hybrid")
    assert not names & {"jax", "jaxlib", "flax", "repro", "repro_torch",
                        "benchmarks"}


def _hf_state(p: dict, cfg: dict) -> dict:
    """The reference's leaves as `GraniteMoeHybridForCausalLM`'s
    state dict ([out, in] linears, conv1d [C, 1, W], the MLP's gate and
    up halves in one `input_linear`)."""
    sd = {"model.embed_tokens.weight": p["embed/embedding"],
          "lm_head.weight": p["embed/embedding"],
          "model.norm.weight": p["final_norm/scale"]}
    seen = {"ssm": 0, "attention": 0}
    for n, kind in enumerate(G.kinds(cfg)):
        i = seen[kind]
        seen[kind] += 1
        g = lambda k: p[f"layers/{kind}/{k}"][i]
        pre = f"model.layers.{n}."
        sd[pre + "post_attention_layernorm.weight"] = g("ffn_norm/scale")
        sd[pre + "shared_mlp.input_linear.weight"] = torch.cat(
            [g("w_gate/kernel"), g("w_up/kernel")], 1).T
        sd[pre + "shared_mlp.output_linear.weight"] = g("w_down/kernel").T
        if kind == "ssm":
            m = pre + "mamba."
            sd[pre + "input_layernorm.weight"] = g("ssm_norm/scale")
            sd.update({m + "in_proj.weight": g("ssm/in_proj/kernel").T,
                       m + "conv1d.weight": g("ssm/conv_w").T[:, None, :],
                       m + "conv1d.bias": g("ssm/conv_b"),
                       m + "dt_bias": g("ssm/dt_bias"),
                       m + "A_log": g("ssm/A_log"), m + "D": g("ssm/D"),
                       m + "norm.weight": g("ssm/norm/scale"),
                       m + "out_proj.weight": g("ssm/out_proj/kernel").T})
        else:
            sd[pre + "input_layernorm.weight"] = g("attn_norm/scale")
            for x in "qkvo":
                sd[pre + f"self_attn.{x}_proj.weight"] = \
                    g(f"w{x}/kernel").T
    return {k: v.contiguous() for k, v in sd.items()}


def test_reference_matches_transformers(monkeypatch, one_thread):
    """The reference's logits (its final hidden state through the tied
    head, fp32, over logits_scaling) against `transformers`' model on the
    same weights, its plain-PyTorch Mamba path: relative L2 within 1e-5
    (float32 rounding of two orders of the same sums)."""
    monkeypatch.setenv("USE_TF", "0")
    monkeypatch.setenv("USE_FLAX", "0")
    tf = pytest.importorskip("transformers")
    cfg = small()["config"]
    keys = set(tf.GraniteMoeHybridConfig().to_dict())
    hc = tf.GraniteMoeHybridConfig(
        **{k: v for k, v in cfg.items() if k in keys})
    hc.layer_types = cfg["layer_types"][:cfg["num_hidden_layers"]]
    assert hc.position_embedding_type == "nope"
    model = tf.GraniteMoeHybridForCausalLM(hc).eval()
    sp = G.spec(cfg)
    w = inputs.weights(sp, 5, "cpu", cfg["init"])
    p = G.unflatten(w, sp)
    sd = _hf_state(p, cfg)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    tok = torch.as_tensor(inputs.generator(cfg["data"]).make(
        cfg["data"], cfg["vocab_size"], 2, 64, 9))
    with torch.no_grad():
        want = model(input_ids=tok).logits
        h = G.hidden(w, sp, cfg, tok, Precision("fp32", "cpu"))
        got = (h @ p["embed/embedding"].T) / cfg["logits_scaling"]
    assert float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want)) < 1e-5


def test_flops_closed_form():
    cfg = small()["config"]          # d 64, 18 Mamba-2 + 2 attention layers
    # Mamba-2: in_proj 64·(256+32+8), out_proj 128·64, conv 4·160,
    # SSD 32·16 + 32·8·16 + 2·8·16·16; attention: q, o 64·64 each, k, v
    # 64·32 each, the causal scores and values 64·64 (H·hd·context);
    # MLP 3·64·128 every layer; head 64·512
    ssm = 64 * 296 + 128 * 64 + 4 * 160 + (512 + 4096 + 4096)
    attn = 2 * 64 * 64 + 2 * 64 * 32 + 64 * 64
    per = 18 * ssm + 2 * attn + 20 * 3 * 64 * 128
    assert G.forward_flops(cfg) == 2 * (per + 64 * 512)


def test_full_size_flops():
    """A token's forward through the benchmark's period at 4096 tokens:
    1.903 GFLOP in matrix products (9 Mamba-2 in/out projections, one
    attention layer's four, ten MLPs, the head), 0.017 in attention, and
    the SSD and conv terms of the nine Mamba-2 layers."""
    cfg = spec.resolve(BENCH, W)["config"]
    mm = 9 * (2048 * 8512 + 4096 * 2048) + 2 * 2048 * 2048 \
        + 2 * 2048 * 512 + 10 * 3 * 2048 * 8192 + 2048 * 100352
    attn = 32 * 64 * 4096
    ssd = 9 * (4 * 4352 + 256 * 128 + 256 * 64 * 64 + 2 * 64 * 64 * 128)
    assert 2 * mm == 1_903_427_584 and 2 * attn == 16_777_216
    assert G.forward_flops(cfg) == 2 * (mm + attn + ssd)


@pytest.mark.parametrize("w", [c for c in BENCH["workloads"]
                               if "context" in spec.resolve(
                                   BENCH, c["name"])["config"]],
                         ids=lambda c: c["name"])
def test_context_is_the_traffics_seq_len(w):
    cell = spec.resolve(BENCH, w["name"])
    assert cell["config"]["context"] == cell["traffic"]["seq_len"]


def _trace(host):
    return types.SimpleNamespace(host=list(host), device=[],
                                 window=(0.0, 1e6))


# two Mamba-2 layers' forwards (3 and 1 launches), an attention layer's
# (2), launches between them and in the backward that must not count
LAYERS = [
    ("cudaLaunchKernel", 0.0, 1.0),                  # embedding: outside
    ("lm.layer.ssm", 10.0, 20.0),
    ("cudaLaunchKernel", 11.0, 1.0),
    ("cuLaunchKernel", 12.0, 1.0),
    ("cudaLaunchKernelExC", 13.0, 1.0),
    ("cudaMemcpyAsync", 14.0, 1.0),                  # no launch
    ("lm.layer.ssm", 40.0, 10.0),
    ("cudaLaunchKernel", 41.0, 1.0),
    ("lm.layer.attention", 60.0, 10.0),
    ("cudaLaunchKernel", 61.0, 1.0),
    ("cudaLaunchKernel", 62.0, 1.0),
    ("cudaLaunchKernel", 100.0, 1.0),                # the backward
]


@pytest.mark.parametrize("name,want", [("ssm_fwd_launches.pod", 2.0),
                                       ("attn_fwd_launches.pod", 2.0)])
def test_layer_launch_readers(name, want):
    assert R(name).read({"trace": _trace(LAYERS)}) == pytest.approx(want)
    # the parent program has no layer spans; the CPU has no launches
    assert R(name).read({"trace": _trace(
        [r for r in LAYERS if not r[0].startswith("lm.")])}) is None
    assert R(name).read({"trace": _trace(
        [r for r in LAYERS if "Launch" not in r[0]])}) is None


RUNS = [None, *faults.FAULTS]


@pytest.mark.parametrize("fault", RUNS, ids=lambda f: f or "program")
def test_run_is_judged(fault, one_thread):
    res = main.run(W, 2 ** 31 + 11, 0.2, False,
                   t_start=time.perf_counter(), cell=small(), device="cpu",
                   faults=[faults.FAULTS[fault]] if fault else [])
    assert list(res)[-1] == "checks"
    assert res["correct"] is (fault is None), res["checks"]
    assert all(math.isfinite(v["value"]) for v in res["checks"].values())


def test_control_is_not_correct(one_thread):
    cell = small()
    got = calibrate.readings(cell, 5, ["control"], "cpu")["control"]
    ok, checks = compare.judge(got, cell["limits"])
    assert not ok, checks


def test_traced_run_reads_no_launches_on_the_cpu(one_thread):
    res = main.run(W, 3, 0.2, True, t_start=time.perf_counter(),
                   cell=small(), device="cpu")
    assert set(res["metrics"]) == {"local_s.pod", "sync_s.pod"}
    assert res["correct"]
