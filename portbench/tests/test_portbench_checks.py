"""Whole runs of each cell at a CPU size (the harness's look for a card
skipped): the program as it is comes out correct; the control (the
reference in TF32 in the program's place) and every fault the cell can
have, planted under the timed path, come out not correct under the
cell's limits."""
from __future__ import annotations

import time

import pytest

from portbench.tests.small_cells import FL, POD, one_thread, small  # noqa: F401
from portbench import calibrate
from portbench.harness import compare, faults, main

CELLS = FL + POD
RUNS = [(w, f) for w in CELLS for f in (None, *faults.FAULTS)]


@pytest.mark.parametrize("workload,fault", RUNS,
                         ids=lambda x: x if isinstance(x, str) else "")
def test_run_is_judged(workload, fault, one_thread):
    cell = small(workload)
    res = main.run(workload, 2 ** 31 + 11, 0.2, False,
                   t_start=time.perf_counter(), cell=cell, device="cpu",
                   faults=[faults.FAULTS[fault]] if fault else [])
    assert list(res)[-1] == "checks"
    assert res["correct"] is (fault is None), res["checks"]
    assert (res["failed"] == 0) is (fault is None)


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload, one_thread):
    cell = small(workload)
    got = calibrate.readings(cell, 5, ["control"], "cpu")["control"]
    ok, checks = compare.judge(got, cell["limits"])
    assert not ok, checks


def test_traced_run_reports_per_layer_metrics(one_thread):
    cell = small("mamba2-780m.pod_compact")
    res = main.run(cell["name"], 3, 0.2, True, t_start=time.perf_counter(),
                   cell=cell, device="cpu")
    assert set(res["metrics"]) == {"local_s.pod", "sync_s.pod"}
    assert set(res["device"]) >= {"busy_s", "window_s"}
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
