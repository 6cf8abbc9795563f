"""Shared inputs, weights and comparisons for the LM parity tests of the
PyTorch port (`tests/test_torch_lm_*.py`). Not a test module.

Weights are drawn with numpy from a seed in the reference's parameter
tree (shapes from `jax.eval_shape(lm.init, ...)`) and go into both
packages: the reference as jnp arrays, the port through
`transformer.params_from_jax`. Both run in fp32 compute without remat.

Tolerances:
- logits: rtol 1e-4, atol 1e-5; loss: rtol 1e-5;
- gradients, per leaf: relative L2 <= 1e-4 and max abs <= 1e-3·max|g_ref|,
  for the loss with an fp32 head (`head32_loss`: the LM's stack and an
  fp32 `h @ E^T` cross-entropy);
- gradients of `LM.loss` itself: relative L2 <= 5e-4 and max abs <=
  5e-3·max|g_ref|. `LM.loss` takes its logits in bf16 (the reference's
  `chunked_ce_loss`), so its backward rounds dlogits and dh to bf16: the
  reference's own gradient moves by 0.7-1.5e-4 (relative L2, hymba and
  gemma3 smoke configs) when its fp32 parameters are scaled by
  1 + 1e-7·N(0, 1), the size of fp32 rounding. The fp32-head gradient
  holds the stack to 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jget_config
from repro.core import compression as JC
from repro.models import transformer as JT

from repro_torch.configs import get_config as tget_config
from repro_torch.core import compression as C
from repro_torch.models import transformer as TT

LOGITS_TOL = dict(rtol=1e-4, atol=1e-5)
LOSS_RTOL = 1e-5
GRAD_TOL = (1e-4, 1e-3)        # fp32 head: (relative L2, max abs / max|g|)
CE_GRAD_TOL = (5e-4, 5e-3)     # LM.loss (bf16 logits)


def models(arch: str, **replace):
    """(reference LM, port LM) at the arch's smoke config, fp32 compute,
    with `replace` applied to both configs."""
    jcfg = dataclasses.replace(jget_config(arch).smoke(), **replace)
    tcfg = dataclasses.replace(tget_config(arch).smoke(), **replace)
    return (JT.LM(jcfg, dtype=jnp.float32, remat=False),
            TT.LM(tcfg, dtype=torch.float32, remat=False))


def numpy_params(jlm, seed: int = 1) -> dict:
    """Weights for the reference's tree: matrices N(0, 1/fan_in), norm
    scales and D near 1, other vectors small."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(jlm.init, jax.random.PRNGKey(0))

    def draw(path, s):
        name = path[-1].key
        layer = path[0].key == "layers"
        shape = s.shape
        core = shape[1:] if layer else shape
        if name in ("scale", "D"):
            return (1.0 + 0.1 * rng.randn(*shape)).astype(np.float32)
        if name == "embedding":
            return (rng.randn(*shape) / np.sqrt(shape[-1])).astype(np.float32)
        if len(core) >= 2:
            return (rng.randn(*shape) / np.sqrt(core[-2])).astype(np.float32)
        return (0.1 * rng.randn(*shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def batch(cfg, B: int = 2, S: int = 64, seed: int = 0,
          labels: bool = True) -> dict:
    """The reference's test batch (`tests/test_models.py::_batch`) as
    numpy arrays."""
    rng = np.random.RandomState(seed)
    if cfg.frontend == "frames":
        out = {"frames": rng.randn(B, S, cfg.frame_dim).astype(np.float32),
               "labels": rng.randint(0, cfg.vocab, (B, S)).astype(np.int32)}
    elif cfg.frontend == "patches":
        text = S - cfg.n_patches
        out = {"patches": rng.randn(B, cfg.n_patches, cfg.patch_dim)
               .astype(np.float32),
               "tokens": rng.randint(0, cfg.vocab, (B, text)).astype(np.int32),
               "labels": rng.randint(0, cfg.vocab, (B, text)).astype(np.int32)}
    else:
        out = {"tokens": rng.randint(0, cfg.vocab, (B, S)).astype(np.int32),
               "labels": rng.randint(0, cfg.vocab, (B, S)).astype(np.int32)}
    if not labels:
        out.pop("labels")
    return out


def to_jax(b: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in b.items()}


def to_torch(b: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


def head32_loss(lm, T, params, b):
    """The LM loss with its bf16 logits replaced by fp32 ones; `T` is the
    transformer module of `lm`'s package."""
    x, positions, prefix = lm._embed_inputs(params, b)
    h, _ = lm._stack(params, x, positions=positions, prefix_len=prefix)
    if lm.cfg.frontend == "frames":
        logits = h @ params["head"]["kernel"] + params["head"]["bias"]
    else:
        if lm.cfg.frontend == "patches":
            h = h[:, lm.cfg.n_patches:]
        logits = h @ params["embed"]["embedding"].T
    return T._ce(logits, b["labels"])


def jax_value_and_flat_grad(loss_fn, params):
    """(loss, flat gradient) of loss_fn(params) in the reference."""
    flat, spec = JC.flatten_pytree(params)
    f = jax.jit(jax.value_and_grad(
        lambda w: loss_fn(JC.unflatten_pytree(w, spec))))
    loss, g = f(flat)
    return float(loss), np.asarray(g)


def torch_value_and_flat_grad(loss_fn, params):
    """(loss, flat gradient, flatten spec) of loss_fn(params) in the
    port."""
    flat, spec = C.flatten_pytree(params)
    w = flat.clone().requires_grad_(True)
    loss = loss_fn(C.unflatten_pytree(w, spec))
    (g,) = torch.autograd.grad(loss, w)
    return float(loss.detach()), g.numpy(), spec


def assert_grads_close(g, g_ref, spec, tol):
    """Per leaf of `spec`: relative L2 and max abs (relative to the
    leaf's max |g_ref|) within `tol`."""
    rel_l2, rel_max = tol
    pos = 0
    for path, shape in spec:
        n = int(np.prod(shape)) if shape else 1
        a, b = g[pos:pos + n], g_ref[pos:pos + n]
        pos += n
        scale = np.max(np.abs(b))
        if scale == 0:
            np.testing.assert_array_equal(a, b)
            continue
        r = np.linalg.norm(a - b) / np.linalg.norm(b)
        m = np.max(np.abs(a - b)) / scale
        assert r <= rel_l2 and m <= rel_max, ("/".join(path), r, m)
    assert pos == g_ref.size


def run_case(case):
    """Reference and port outputs of one (arch, config change, S) case."""
    arch, replace, S = case
    jlm, tlm = models(arch, **replace)
    np_params = numpy_params(jlm)
    b = batch(jlm.cfg, S=S)
    jp = np_params
    tp = TT.params_from_jax(np_params)
    jb, tb = to_jax(b), to_torch(b)
    out = {}
    out["jloss"], out["jgrad"] = jax_value_and_flat_grad(
        lambda p: jlm.loss(p, jb), jp)
    out["tloss"], out["tgrad"], out["spec"] = torch_value_and_flat_grad(
        lambda p: tlm.loss(p, tb), tp)
    _, out["jgrad32"] = jax_value_and_flat_grad(
        lambda p: head32_loss(jlm, JT, p, jb), jp)
    _, out["tgrad32"], _ = torch_value_and_flat_grad(
        lambda p: head32_loss(tlm, TT, p, tb), tp)
    pb = {k: v for k, v in b.items() if k != "labels"}
    jl, jc = jax.jit(jlm.prefill)(jp, to_jax(pb))
    with torch.no_grad():
        tl, tc = tlm.prefill(tp, to_torch(pb))
    out["jprefill"] = (np.asarray(jl),
                       {k: np.asarray(v) for k, v in jc.items()})
    out["tprefill"] = (tl.numpy(), {k: v.numpy() for k, v in tc.items()})
    return out
