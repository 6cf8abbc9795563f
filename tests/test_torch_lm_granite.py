"""granite-4.0-h-micro in the port's LM (`repro_torch.models.transformer`,
a stack of Mamba-2 and attention layers): the loss and every gradient
leaf against the benchmark's plain reference
(`portbench/reference/granite_hybrid.py`) at a cut of two periods of the
pattern at width 128, the flat order against the reference's `spec`, the
spans of each layer kind, the paths that raise for it or for any
train-only field, and the ten assigned architectures' flat layout the
JAX package's (their loss and gradients against the JAX package:
`test_torch_lm_dense.py`, `test_torch_lm_mixed.py`)."""
import math
import os
import sys

import pytest

torch = pytest.importorskip("torch")

import torch_lm_util as U  # noqa: E402
from repro_torch.configs import (ARCH_IDS, PORT_ARCH_IDS,  # noqa: E402
                                 get_config)
from repro_torch.core import compression as C  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.obs import profiling  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.harness import inputs, spec  # noqa: E402
from portbench.harness.pod import port_arch  # noqa: E402
from portbench.reference import granite_hybrid as G  # noqa: E402
from portbench.reference.precision import Precision  # noqa: E402

ARCH = "granite-4.0-h-micro"


@pytest.fixture(autouse=True)
def one_thread():
    """One CPU thread a test, so that the suite's parallel workers do not
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_cfg() -> dict:
    """The benchmark's configuration cut to two periods of the pattern
    (20 layers) at width 128, 64-token sequences."""
    cfg = spec.load_json(spec.PB / "configs" / f"{ARCH}.json")
    cfg.update(hidden_size=128, num_attention_heads=4, num_key_value_heads=2,
               mamba_d_head=32, mamba_d_state=16, mamba_chunk_size=32,
               shared_intermediate_size=256, vocab_size=512,
               num_hidden_layers=20, context=64)
    return cfg


@pytest.fixture(scope="module")
def case():
    cfg = small_cfg()
    lm = TT.LM(port_arch(cfg), dtype=torch.float32, remat=False)
    sp = G.spec(cfg)
    w = inputs.weights(sp, 5, "cpu", cfg["init"])
    tok = torch.as_tensor(inputs.generator(cfg["data"]).make(
        cfg["data"], cfg["vocab_size"], 2, 65, 9))
    return cfg, lm, sp, w, tok[:, :-1], tok[:, 1:]


def _grad(fn, w):
    wt = w.clone().requires_grad_(True)
    lo = fn(wt)
    g, = torch.autograd.grad(lo, wt)
    return float(lo.detach()), g


def _leaf_errors(g, g_ref, sp):
    out, pos = {}, 0
    for path, shape in sp:
        n = math.prod(shape)
        a, b = g[pos:pos + n], g_ref[pos:pos + n]
        out["/".join(path)] = float(torch.linalg.vector_norm(a - b)
                                    / torch.linalg.vector_norm(b))
        pos += n
    return out


def test_layout_is_the_references(case):
    cfg, lm, sp, *_ = case
    assert [(tuple(p), tuple(s)) for p, s in lm.param_spec()] == sp
    assert lm.cfg.layer_mixers() == G.kinds(cfg)
    assert lm.cfg.layer_mixers()[:10] == ["ssm"] * 5 + ["attention"] \
        + ["ssm"] * 4
    assert lm.cfg.head_dim_ == 32 and not lm.cfg.rope


def test_full_size_counts():
    """The whole model and the benchmark's one period at published
    widths: 3.19 B and 951,991,232 parameters."""
    full = TT.LM(get_config(ARCH))
    n = sum(math.prod(s) for _, s in full.param_spec())
    assert n == 3_191_396_096
    cfg = spec.load_json(spec.PB / "configs" / f"{ARCH}.json")
    period = sum(math.prod(s) for _, s in G.spec(cfg))
    assert period == 9 * 76_182_976 + 60_821_504 + 205_520_896 + 2_048
    lm = TT.LM(port_arch(cfg))
    assert sum(math.prod(s) for _, s in lm.param_spec()) == period


def test_loss_and_gradient_match_the_reference_fp32_head(case):
    """The stack against the reference with both heads in fp32: every
    gradient leaf within 2e-5 relative L2 (float32 rounding through 20
    layers reads under 1e-5)."""
    cfg, lm, sp, w, x, y = case

    def ce32(h, emb):
        z = (h @ emb.T) / cfg["logits_scaling"]
        return torch.nn.functional.cross_entropy(
            z.reshape(-1, z.shape[-1]), y.reshape(-1))

    def ref(wt):
        h = G.hidden(wt, sp, cfg, x, Precision("fp32", "cpu"))
        return ce32(h, G.unflatten(wt, sp)["embed/embedding"])

    def port(wt):
        p = C.unflatten_pytree(wt, sp)
        h0, pos, _ = lm._embed_inputs(p, {"tokens": x})
        h, _ = lm._stack(p, h0, positions=pos)
        return ce32(h, p["embed"]["embedding"])

    lr, gr = _grad(ref, w)
    lp, gp = _grad(port, w)
    assert lp == pytest.approx(lr, rel=1e-6)
    worst = _leaf_errors(gp, gr, sp)
    assert max(worst.values()) < 2e-5, worst


def test_lm_loss_matches_the_reference(case):
    """`LM.loss` (bf16 logits, as the reference takes them): the loss to
    1e-5 and each gradient leaf within `torch_lm_util.CE_GRAD_TOL`'s
    relative L2 (the bf16 rounding of dlogits and dh, its docstring)."""
    cfg, lm, sp, w, x, y = case
    prec = Precision("fp32", "cpu")
    lr, gr = _grad(lambda wt: G.loss(wt, sp, cfg, x, y, prec), w)
    lp, gp = _grad(lambda wt: lm.loss(C.unflatten_pytree(wt, sp),
                                      {"tokens": x, "labels": y}), w)
    assert lp == pytest.approx(lr, rel=1e-5)
    worst = _leaf_errors(gp, gr, sp)
    assert max(worst.values()) < U.CE_GRAD_TOL[0], worst


def test_each_layer_opens_the_span_of_its_kind(case, monkeypatch):
    cfg, lm, sp, w, x, y = case
    names = []

    def record(name, timers=None, key=None):
        names.append(name)
        return profiling._NULL_CTX
    monkeypatch.setattr(TT, "annotate", record)
    with torch.no_grad():
        lm.loss(C.unflatten_pytree(w, sp), {"tokens": x, "labels": y})
    assert names == ["lm.layer." + k for k in G.kinds(cfg)]


@pytest.mark.parametrize("arch,span", [("mamba2-780m", "lm.layer.ssm"),
                                       ("gemma3-4b", "lm.layer.attention"),
                                       ("hymba-1.5b", "lm.layer.parallel")])
def test_one_kind_stacks_name_their_mixer(arch, span):
    cfg = get_config(arch).smoke()
    lm = TT.LM(cfg, dtype=torch.float32, remat=True)
    p = lm.init(torch.Generator().manual_seed(0))
    for t in torch.utils._pytree.tree_leaves(p):
        t.requires_grad_(True)
    tok = torch.randint(0, cfg.vocab, (1, 16))
    profiling.set_profiling(True)
    try:
        with torch.profiler.profile() as prof:
            lm.loss(p, {"tokens": tok, "labels": tok}).backward()
    finally:
        profiling.set_profiling(False)
    spans = [e.name for e in prof.events() if e.name.startswith("lm.layer")]
    # forward only: the remat'd recompute in the backward opens none
    assert spans == [span] * cfg.n_layers
    assert profiling.annotate(span) is profiling._NULL_CTX


def test_other_paths_raise_naming_the_arch():
    cfg = get_config(ARCH).smoke()
    assert cfg.n_layers == 10                 # one whole period
    lm = TT.LM(cfg, dtype=torch.float32)
    p = lm.init(torch.Generator().manual_seed(0))
    tok = torch.zeros((1, 8), dtype=torch.long)
    for call in (lambda: lm.prefill(p, {"tokens": tok}),
                 lambda: lm.decode_step(p, {}, tok[:, :1], 0),
                 lambda: lm.init_cache(1, 8)):
        with pytest.raises(NotImplementedError, match=ARCH):
            call()
    assert set(cfg.shapes()) == {"train_4k"}


def test_mesh_path_raises_naming_the_arch(monkeypatch):
    cfg = get_config(ARCH).smoke()
    lm = TT.LM(cfg, dtype=torch.float32)
    monkeypatch.setattr(TT, "_mesh_of", lambda params: object())
    with pytest.raises(NotImplementedError, match=f"{ARCH}: the mesh path"):
        lm._region({}, 1, 8)


def test_datacenter_cli_runs_granite():
    from repro_torch.launch import train
    args = train.build_parser().parse_args(
        ["--mode", "datacenter", "--arch", ARCH, "--steps", "2", "--pods",
         "2", "--local-k", "1", "--batch-size", "2", "--rate", "0.05",
         "--device", "cpu", "--quiet"])
    res = train.run_datacenter(args)
    assert math.isfinite(res["loss"]) and res["comm_mb"] > 0


def test_registry_keeps_the_assigned_list():
    assert ARCH not in ARCH_IDS and PORT_ARCH_IDS == [ARCH]
    assert get_config(ARCH).mixer_pattern
    with pytest.raises(KeyError):
        get_config("granite-4.0-h-small")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_assigned_archs_keep_their_layout(arch):
    """One stack of every layer, its flat layout the JAX package's (the
    port-only fields' defaults: `test_torch_lm_modules.py`)."""
    cfg = get_config(arch)
    assert cfg.layer_mixers() == [] and cfg.smoke().n_layers == 2
    jlm, tlm = U.models(arch)
    import jax
    shapes = jax.eval_shape(jlm.init, jax.random.PRNGKey(0))
    ref = sorted((tuple(k.key for k in path), tuple(s.shape)) for path, s in
                 jax.tree_util.tree_flatten_with_path(shapes)[0])
    assert [(tuple(p), tuple(s)) for p, s in tlm.param_spec()] == ref


SET = {"mixer_pattern": ("ssm", "attention"), "rope": False,
       "attn_scale": 0.125, "embed_scale": 12.0, "residual_scale": 0.22,
       "logit_divisor": 8.0}


@pytest.mark.parametrize("field", TT.TRAIN_ONLY)
def test_paths_without_a_field_raise_where_it_is_set(field, monkeypatch):
    """Any one train-only field set on an assigned arch's smoke config
    makes prefill, decode, the decode cache and the mesh path raise,
    naming the field, rather than compute without it."""
    assert set(SET) == set(TT.TRAIN_ONLY)
    import dataclasses
    cfg = dataclasses.replace(get_config("gemma3-4b").smoke(),
                              **{field: SET[field]})
    lm = TT.LM(cfg, dtype=torch.float32)
    tok = torch.zeros((1, 8), dtype=torch.long)
    monkeypatch.setattr(TT, "_mesh_of", lambda params: object())
    for call in (lambda: lm.prefill({}, {"tokens": tok}),
                 lambda: lm.decode_step({}, {}, tok[:, :1], 0),
                 lambda: lm.init_cache(1, 8),
                 lambda: lm._region({}, 1, 8)):
        with pytest.raises(NotImplementedError, match=field):
            call()
