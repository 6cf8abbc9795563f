"""`python -m repro_torch.launch.train --mode datacenter --device cpu`
against the reference CLI on an attention arch (gemma3-4b's smoke
config), as `test_torch_datacenter.py` runs it on the SSM arch: `comm_mb`
identical, `loss` within rtol 1e-4."""
import pytest

torch = pytest.importorskip("torch")

from test_torch_datacenter import check_cli_matches_reference  # noqa: E402


def test_datacenter_cli_matches_reference_attention(monkeypatch, capsys):
    check_cli_matches_reference("gemma3-4b", monkeypatch, capsys)
