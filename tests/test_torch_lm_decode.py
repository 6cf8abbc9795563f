"""The port's serving path (`LM.prefill`, `LM.decode_step`, `LM.init_cache`)
against `repro`'s, with the same numpy-drawn weights, on the five archs
that `tests/test_models.py` decodes:

- prefill, caches grown along S, one decode step: the port's logits equal
  its own full forward over S + 1 tokens (atol 2e-2, as the reference's
  test) and the reference's `decode_step` (rtol 1e-4, atol 1e-5), and the
  updated caches equal the reference's;
- 16 decode steps from an empty cache, compute and int8 KV caches: each
  step's logits equal the reference's in the same cache dtype, so do the
  final caches (int8 codes equal), and the int8 cache tracks the compute
  cache (corrcoef > 0.999, the same last argmax), as the reference's int8
  test holds it.

The int8 decode quantizes q and the attention probabilities to int8
codes per row on the fly. Where the two frameworks' fp32 values of a row
straddle a rounding boundary, one code differs by one step, 1/127 of the
row's largest magnitude: on paligemma that moved logits by 5.2e-3 with no
code of the cache itself differing. So int8 logits are held at atol 1e-2
(rtol 1e-4); `tests/test_torch_lm_modules.py` holds `decode_attention`'s
int8 path to rtol 1e-4 / atol 1e-5 on identical inputs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_lm_util as U  # noqa: E402

from repro_torch.models import transformer as TT  # noqa: E402

INT8_TOL = dict(rtol=1e-4, atol=1e-2)
ARCHS = ["gemma3-4b", "hymba-1.5b", "mamba2-780m", "paligemma-3b",
         "qwen3-moe-30b-a3b"]


def _models(arch):
    # MoE capacity drops are load-dependent (a token may be dropped in the
    # full forward but never in single-token decode): lift the capacity so
    # the consistency invariant is exact, as the reference's test does
    extra = {"capacity_factor": 8.0} if "moe" in arch else {}
    return U.models(arch, **extra)


def _grow(cache, n):
    return {k: (np.concatenate([v, np.zeros(v.shape[:2] + (n,) + v.shape[3:],
                                            v.dtype)], axis=2)
                if k in ("k", "v") else np.asarray(v))
            for k, v in cache.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_after_prefill(arch):
    jlm, tlm = _models(arch)
    params = U.numpy_params(jlm)
    tp = TT.params_from_jax(params)
    B, S = 2, 32
    b = U.batch(jlm.cfg, B, S, 0, labels=False)
    nxt = np.random.RandomState(0).randint(0, jlm.cfg.vocab, (B, 1)) \
        .astype(np.int32)
    b2 = dict(b, tokens=np.concatenate([b["tokens"], nxt], 1))
    pos = S  # the position decode writes: the prefill's length
    if jlm.cfg.frontend == "patches":
        pos = jlm.cfg.n_patches + b["tokens"].shape[1]

    _, jc = jax.jit(jlm.prefill)(params, U.to_jax(b))
    jc = _grow({k: np.asarray(v) for k, v in jc.items()}, 4)
    jl, jc_new = jax.jit(jlm.decode_step)(params, U.to_jax(jc),
                                          jnp.asarray(nxt), jnp.int32(pos))
    with torch.no_grad():
        _, tc = tlm.prefill(tp, U.to_torch(b))
        tc = {k: torch.from_numpy(v) for k, v in
              _grow({k: v.numpy() for k, v in tc.items()}, 4).items()}
        tl, tc_new = tlm.decode_step(tp, tc, torch.from_numpy(nxt), pos)
        tf, _ = tlm.prefill(tp, U.to_torch(b2))
    np.testing.assert_allclose(tl[:, 0].numpy(), tf[:, 0].numpy(), atol=2e-2)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **U.LOGITS_TOL)
    assert sorted(tc_new) == sorted(jc_new)
    for k in jc_new:
        np.testing.assert_allclose(tc_new[k].numpy(), np.asarray(jc_new[k]),
                                   **U.LOGITS_TOL, err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_from_empty_cache_both_cache_dtypes(arch):
    jlm, tlm = _models(arch)
    params = U.numpy_params(jlm)
    tp = TT.params_from_jax(params)
    B, S = 2, 16
    tok = np.random.RandomState(0).randint(0, jlm.cfg.vocab, (B, S)) \
        .astype(np.int32)
    last = {}
    for kv in ("compute", "int8"):
        jm = dataclasses.replace(jlm, kv_dtype=kv)
        tm = dataclasses.replace(tlm, kv_dtype=kv)
        jc, tc = jm.init_cache(B, S), tm.init_cache(B, S)
        assert sorted(tc) == sorted(jc)
        for k in jc:
            assert tuple(tc[k].shape) == jc[k].shape, k
            assert str(tc[k].dtype).split(".")[-1] == str(jc[k].dtype), k
        step = jax.jit(jm.decode_step)
        with torch.no_grad():
            for t in range(S):
                jl, jc = step(params, jc, jnp.asarray(tok[:, t:t + 1]),
                              jnp.int32(t))
                tl, tc = tm.decode_step(tp, tc,
                                        torch.from_numpy(tok[:, t:t + 1]), t)
                tol = U.LOGITS_TOL if kv == "compute" else INT8_TOL
                np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                           **tol, err_msg=f"{kv} step {t}")
        for k in jc:     # int8 codes: equal
            np.testing.assert_allclose(
                tc[k].numpy().astype(np.float32),
                np.asarray(jc[k]).astype(np.float32), **U.LOGITS_TOL,
                err_msg=f"{kv} cache {k}")
        last[kv] = tl.numpy()
    a, b = last["compute"], last["int8"]
    assert np.corrcoef(a.ravel(), b.ravel())[0, 1] > 0.999
    assert (a[:, -1].argmax(-1) == b[:, -1].argmax(-1)).all()
