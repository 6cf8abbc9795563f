"""`python -m repro_torch.obs.check TRACE [METRICS]` (the port of
`repro.obs.check`) on the `--trace-out` / `--metrics-out` artifacts of a
`--device cpu` FL CLI run: it passes on them, and exits non-zero on a
trace with a required key removed, on a metrics file with a section
removed, and when fewer device tracks than asked for are present."""
import json

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import train  # noqa: E402
from repro_torch.obs import check  # noqa: E402


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    d = tmp_path_factory.mktemp("obs")
    trace, metrics = str(d / "trace.json"), str(d / "metrics.json")
    train.main(["--task", "mlp_micro", "--rounds", "2", "--devices", "3",
                "--samples", "300", "--test-samples", "100", "--device",
                "cpu", "--quiet", "--trace-out", trace,
                "--metrics-out", metrics])
    return d, trace, metrics


def test_check_passes_on_cli_artifacts(artifacts, capsys):
    _, trace, metrics = artifacts
    assert check.main([trace, metrics, "--min-device-tracks", "3"]) == 0
    out = capsys.readouterr().out
    assert out.count("[obs.check] OK") == 2 and "(3 devices)" in out


@pytest.mark.parametrize("key", ["ts", "ph", "name"])
def test_check_fails_on_a_trace_missing_a_key(artifacts, key, capsys):
    d, trace, _ = artifacts
    with open(trace) as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    victim = next(e for e in events if e.get("ph") != "M")
    del victim[key]
    bad = str(d / f"trace_no_{key}.json")
    with open(bad, "w") as f:
        json.dump(doc, f)
    assert check.main([bad]) != 0
    assert "FAIL" in capsys.readouterr().err


def test_check_fails_on_bad_metrics_and_too_few_tracks(artifacts, capsys):
    d, trace, metrics = artifacts
    with open(metrics) as f:
        doc = json.load(f)
    del doc["counters"]
    bad = str(d / "metrics_bad.json")
    with open(bad, "w") as f:
        json.dump(doc, f)
    assert check.main([trace, bad]) != 0
    assert check.main([trace, "--min-device-tracks", "4"]) != 0
