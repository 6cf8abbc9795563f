"""BENCHMARK.json against the benchmark's contract, and every cell, metric
and configuration resolving to its own files by name."""
from __future__ import annotations

import json
import math
import re

import pytest

from portbench.tests.small_cells import ROOT
from portbench.harness import inputs, spec

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_resolves(w):
    cell = spec.resolve(BENCH, w["name"])
    assert cell["chips"] == 1
    drv = spec.driver(cell["traffic"]["driver"])
    assert all(callable(getattr(drv, f)) for f in (
        "setup", "window", "end_to_end", "traced", "context", "release",
        "check", "calibrate"))
    assert cell["limits"]["limits"]
    assert any(m["name"] != "setup_s" for m in cell["end_to_end"])
    assert {m["name"] for m in cell["end_to_end"]} >= {"setup_s"}
    assert cell["per_layer"]
    assert len(w["why"]) <= 200 and "\n" not in w["why"]


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_found(m):
    assert callable(spec.metric_reader(m["name"]).read)
    e2e = {e["name"]: e for e in BENCH["end_to_end"]}
    assert m["moves"] in e2e
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(m["workloads"]) <= cells
    for w in m["workloads"]:           # each cell reports what it moves
        assert spec.applies(e2e[m["moves"]], w)


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(c):
    path = ROOT + "/" + c["file"]
    assert c["file"].startswith("portbench/configs/")
    with open(path) as f:
        assert json.load(f)["name"] == c["name"]
    assert c["source"].startswith("https://")


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_names_its_reference_and_data(c):
    """The model's reference and the data generator are found by the
    names the configuration file gives, with the interfaces the drivers
    and the mfu metrics use."""
    cfg = spec.load_json(spec.ROOT / c["file"])
    model = spec.reference(cfg)
    assert model.__name__ == f"portbench.reference.{cfg['reference']}"
    sp = model.spec(cfg)
    assert sp and all(len(shape) >= 1 for _, shape in sp)
    assert callable(model.loss) and model.forward_flops(cfg) > 0
    assert callable(inputs.generator(cfg["data"]).make)


def test_names_units_bounds():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads"):
        assert len({x["name"] for x in BENCH[k]}) == len(BENCH[k])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_check_fits_the_day():
    """2 + 14 runs per cell at run_seconds + 60 s, 2 x 90 s of compile
    per cell and 1200 s spare, for the full 24 cells, within 12 hours."""
    r = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (r + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_limits_are_numbers(w):
    lim = spec.resolve(BENCH, w["name"])["limits"]["limits"]
    assert all(isinstance(v, float) and math.isfinite(v) and v >= 0
               for v in lim.values())
