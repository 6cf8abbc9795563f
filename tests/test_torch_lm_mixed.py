"""The port's LM (`repro_torch.models.transformer`) against `repro`'s,
with the same numpy-drawn weights, on the MoE, hybrid, SSM and encoder
archs at their smoke configs: `LM.loss` and its gradient, the gradient
through an fp32 head, and `LM.prefill`'s logits and caches (tolerances in
`torch_lm_util`). The dense and prefix-LM archs are in
`test_torch_lm_dense.py`."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_lm_util as U  # noqa: E402

CASES = {
    "grok-1-314b": ("grok-1-314b", {}, 64),
    "qwen3-moe-30b-a3b": ("qwen3-moe-30b-a3b", {}, 64),
    "hymba-1.5b": ("hymba-1.5b", {}, 64),
    "hubert-xlarge": ("hubert-xlarge", {}, 64),
    "mamba2-780m": ("mamba2-780m", {}, 64),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    return U.run_case(CASES[request.param])


def test_loss(case):
    np.testing.assert_allclose(case["tloss"], case["jloss"], rtol=U.LOSS_RTOL)


def test_grad_fp32_head(case):
    U.assert_grads_close(case["tgrad32"], case["jgrad32"], case["spec"],
                         U.GRAD_TOL)


def test_grad_lm_loss(case):
    U.assert_grads_close(case["tgrad"], case["jgrad"], case["spec"],
                         U.CE_GRAD_TOL)


def test_prefill_logits_and_caches(case):
    (jl, jc), (tl, tc) = case["jprefill"], case["tprefill"]
    assert tl.shape == jl.shape
    np.testing.assert_allclose(tl, jl, **U.LOGITS_TOL)
    assert sorted(tc) == sorted(jc)
    for k in jc:
        assert tc[k].shape == jc[k].shape, k
        np.testing.assert_allclose(tc[k], jc[k], **U.LOGITS_TOL, err_msg=k)
