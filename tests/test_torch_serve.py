"""`python -m repro_torch.launch.serve --device cpu` against
`python -m repro.launch.serve`, with the reference's initial weights
patched into the port: the same result keys and the same greedy `sample`
tokens, except from the first step where the reference's two largest
logits are closer than 1e-4 (a near-tie that fp32 rounding may decide
either way). Also the refusals: the encoder-only arch, and `cuda`
without a card."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models.transformer import LM as JLM  # noqa: E402

from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

ARGS = ["--requests", "3", "--batch", "2", "--prompt-len", "8", "--gen",
        "8", "--seed", "0", "--quiet"]


def _reference_gaps(arch, params, n):
    """The reference's greedy decode of the first request (its batch of
    the first two prompts, as the CLI forms it): per step, the gap
    between the first row's two largest logits, and the tokens."""
    cfg = get_config(arch).smoke()
    lm = JLM(cfg, dtype=jnp.float32, remat=False)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab, size=(8,)).astype(np.int32)
               for _ in range(3)][:2]
    toks = jnp.asarray(np.stack(prompts))
    batch, base = {"tokens": toks}, 8
    if cfg.frontend == "patches":
        batch["patches"] = jnp.zeros((2, cfg.n_patches, cfg.patch_dim))
        base += cfg.n_patches
    logits, cache = jax.jit(lm.prefill)(params, batch)
    cache = {k: (jnp.concatenate([v, jnp.zeros(
        v.shape[:2] + (base + n - v.shape[2],) + v.shape[3:], v.dtype)], 2)
        if k in ("k", "v") else v) for k, v in cache.items()}
    decode = jax.jit(lm.decode_step)
    gaps, tokens, row = [], [], logits[:, -1, :]
    for g in range(n):
        top2 = np.sort(np.asarray(row[0]))[-2:]
        gaps.append(float(top2[1] - top2[0]))
        tok = jnp.argmax(row, -1).astype(jnp.int32)[:, None]
        tokens.append(int(tok[0, 0]))
        logits, cache = decode(params, cache, tok, jnp.int32(base + g))
        row = logits[:, 0, :]
    return gaps, tokens


@pytest.mark.parametrize("arch", ["gemma3-4b", "mamba2-780m",
                                  "paligemma-3b"])
def test_serve_cli_matches_reference(arch, monkeypatch, capsys):
    jserve.main(["--arch", arch] + ARGS)
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    params = JLM(get_config(arch).smoke(), dtype=jnp.float32,
                 remat=False).init(jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, params)
    monkeypatch.setattr(TT.LM, "init", lambda self, gen, device=None:
                        TT.params_from_jax(np_params, device))
    tserve.main(["--arch", arch, "--device", "cpu"] + ARGS)
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(out) == sorted(ref) == ["arch", "requests", "sample",
                                          "tokens_per_s"]
    assert (out["arch"], out["requests"]) == (ref["arch"], ref["requests"])
    assert out["tokens_per_s"] > 0 and len(out["sample"]) == 8
    gaps, tokens = _reference_gaps(arch, params, 8)
    assert tokens == ref["sample"]
    for g, (a, b) in enumerate(zip(out["sample"], ref["sample"])):
        if a != b:
            assert gaps[g] < 1e-4, (g, a, b, gaps[g])
            break
    else:
        assert out["sample"] == ref["sample"]


def test_serve_refuses_encoder_only_and_missing_card(monkeypatch):
    with pytest.raises(SystemExit):
        tserve.main(["--arch", "hubert-xlarge", "--device", "cpu"] + ARGS)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tserve.main(["--arch", "gemma3-4b", "--device", "cuda"] + ARGS)
