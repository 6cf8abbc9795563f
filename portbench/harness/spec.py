"""What a run measures, read from `BENCHMARK.json` and the data files
beside the harness.

A cell (an entry of `workloads`) names a configuration and a traffic mix;
each is a JSON file found by its name:

  portbench/configs/<config>.json    sizes of the model as it is run;
                                     its "reference" names the model's
                                     plain reference, a module of
                                     `portbench.reference`, and its
                                     "data" group's "generator" a module
                                     of `portbench.data`
  portbench/traffic/<traffic>.json   parameters of the mix; its "driver"
                                     names the module of
                                     `portbench.harness` that runs it
  portbench/limits/<workload>.json   the limit of each number compared
                                     for `correct`, with the readings it
                                     was set from
  portbench/metrics/<metric>.py      the reader of one per-layer metric

A metric without a "workloads" list applies to every cell.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

PB = Path(__file__).resolve().parents[1]
ROOT = PB.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def resolve(bench: dict, workload: str, root: Path = ROOT) -> dict:
    """The cell `workload` with its files loaded: {"name", "chips",
    "config", "traffic", "limits", "end_to_end", "per_layer"}."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: "
                         f"{sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = load_json(root / configs[w["config"]]["file"])
    return {
        "name": workload,
        "chips": int(w["chips"]),
        "config": cfg,
        "traffic": load_json(PB / "traffic" / f"{w['traffic']}.json"),
        "limits": load_json(PB / "limits" / f"{workload}.json"),
        "end_to_end": [m for m in bench["end_to_end"]
                       if applies(m, workload)],
        "per_layer": [m for m in bench["per_layer"] if applies(m, workload)],
    }


def metric_reader(name: str):
    """The module `portbench/metrics/<name>.py` (its `read(ctx)` gives the
    metric's value, or None where it finds nothing to read)."""
    path = PB / "metrics" / f"{name}.py"
    mod_name = "portbench_metric_" + "".join(
        c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference(cfg: dict):
    """The configuration's model reference, the module
    `portbench.reference.<cfg["reference"]>` (`spec`, `loss`,
    `forward_flops`)."""
    return importlib.import_module(f"portbench.reference.{cfg['reference']}")


def driver(name: str):
    """The class `Cell` of the module `portbench.harness.<name>`, which
    runs a traffic mix whose "driver" is `name`."""
    return importlib.import_module(f"portbench.harness.{name}").Cell
