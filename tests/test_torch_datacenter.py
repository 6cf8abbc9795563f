"""`python -m repro_torch.launch.train --mode datacenter --device cpu`
against `python -m repro.launch.train --mode datacenter`, with the
reference's initial weights patched into the port and fixed `--local-k`
and `--rate` (otherwise the plans come from a timed α): `comm_mb`
identical and `loss` within rtol 1e-4, on the SSM arch (an attention arch
is in `test_torch_datacenter_attn.py`, so the two run on separate
workers). `--ckpt-dir` writes checkpoints that read back bitwise, in the
reference's layout. `cuda` without a card raises."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models.transformer import LM as JLM  # noqa: E402

from repro_torch.checkpoint import CheckpointManager, load_pytree  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

ARGS = ["--mode", "datacenter", "--local-k", "2", "--rate", "0.05",
        "--steps", "3", "--pods", "2", "--quiet"]


def _patch_reference_init(monkeypatch, arch, seed=0):
    params = JLM(get_config(arch).smoke(), dtype=jnp.float32,
                 remat=False).init(jax.random.PRNGKey(seed))
    np_params = jax.tree.map(np.asarray, params)
    monkeypatch.setattr(TT.LM, "init", lambda self, gen, device=None:
                        TT.params_from_jax(np_params, device))


def _json(capsys):
    return json.loads(capsys.readouterr().out)


def check_cli_matches_reference(arch, monkeypatch, capsys):
    jtrain.main(ARGS + ["--arch", arch])
    ref = _json(capsys)
    _patch_reference_init(monkeypatch, arch)
    ttrain.main(ARGS + ["--arch", arch, "--device", "cpu"])
    out = _json(capsys)
    assert sorted(out) == sorted(ref) == ["comm_mb", "loss"]
    assert out["comm_mb"] == ref["comm_mb"]
    np.testing.assert_allclose(out["loss"], ref["loss"], rtol=1e-4)


def test_datacenter_cli_matches_reference(monkeypatch, capsys):
    check_cli_matches_reference("mamba2-780m", monkeypatch, capsys)


def test_datacenter_checkpoints_read_back_bitwise(monkeypatch, capsys,
                                                  tmp_path):
    saved = {}
    real_save = CheckpointManager.save

    def spy(self, step, tree):
        saved[step] = tree["w"].clone()
        return real_save(self, step, tree)

    monkeypatch.setattr(CheckpointManager, "save", spy)
    ttrain.main(ARGS + ["--arch", "mamba2-780m", "--device", "cpu",
                        "--ckpt-dir", str(tmp_path), "--ckpt-every", "1"])
    assert np.isfinite(_json(capsys)["loss"])
    assert sorted(saved) == [1, 2, 3]
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    assert mgr.steps() == [2, 3]
    for step in (2, 3):
        w = load_pytree(str(tmp_path / f"step_{step}"))["w"]
        assert w.dtype == np.float32
        np.testing.assert_array_equal(w, saved[step].numpy())
    assert not torch.equal(saved[2], saved[3])


def test_datacenter_refuses_missing_card_and_non_token_archs(monkeypatch):
    with pytest.raises(SystemExit):
        ttrain.main(ARGS + ["--arch", "hubert-xlarge", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        ttrain.main(ARGS + ["--arch", "mamba2-780m", "--device", "cuda"])
