"""The port's LM (`repro_torch.models.transformer`) against `repro`'s,
with the same numpy-drawn weights, on the dense and prefix-LM archs at
their smoke configs: `LM.loss` and its gradient, the gradient through an
fp32 head, and `LM.prefill`'s logits and caches (tolerances in
`torch_lm_util`). Also a gemma3 config whose sliding window (8) bites at
S = 32. The mixed, MoE, SSM and encoder archs are in
`test_torch_lm_mixed.py`."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_lm_util as U  # noqa: E402

CASES = {
    "gemma3-4b": ("gemma3-4b", {}, 64),
    "starcoder2-15b": ("starcoder2-15b", {}, 64),
    "gemma3-27b": ("gemma3-27b", {}, 64),
    "stablelm-3b": ("stablelm-3b", {}, 64),
    "paligemma-3b": ("paligemma-3b", {}, 64),
    "gemma3-4b-window8": ("gemma3-4b", {"window": 8}, 32),
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
