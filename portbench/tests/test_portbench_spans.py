"""The readers of the program's spans (`harness/spans.py` and the metrics
that name a span) on hand-made traces: host and device rows (name,
start_us, dur_us), as `device.Trace` holds them."""
from __future__ import annotations

import types

import pytest

from portbench.harness import spans
from portbench.harness import spec

R = spec.metric_reader


def trace(host, device=(), window=(0.0, 1e6)):
    return types.SimpleNamespace(host=list(host), device=list(device),
                                 window=window)


# two local rounds of 2 and 1 steps; launches inside them, and outside
# any span (before, between, after) that must not count
LOCAL = [
    ("cudaLaunchKernel", 0.0, 1.0),                  # outside
    ("local_round", 10.0, 90.0),
    ("local_round.step", 12.0, 40.0),
    ("cudaLaunchKernel", 13.0, 1.0),
    ("aten::mm", 14.0, 5.0),
    ("cudaLaunchKernel", 15.0, 1.0),
    ("local_round.step", 55.0, 40.0),
    ("cuLaunchKernel", 60.0, 1.0),                   # a Triton launch
    ("cudaLaunchKernelExC", 70.0, 1.0),
    ("cudaMemcpyAsync", 80.0, 1.0),                  # no launch
    ("cudaLaunchKernel", 150.0, 1.0),                # between: outside
    ("local_round", 200.0, 50.0),
    ("local_round.step", 201.0, 45.0),
    ("cudaLaunchKernel", 210.0, 1.0),
    ("cudaLaunchKernel", 220.0, 1.0),
    ("cudaLaunchKernel", 300.0, 1.0),                # after: outside
]


@pytest.mark.parametrize("name", ["launches_per_step.fl",
                                  "launches_per_step.pod"])
def test_launches_per_step(name):
    # 6 launches inside the local rounds over 3 steps
    assert R(name).read({"trace": trace(LOCAL)}) == pytest.approx(2.0)
    # no span (the parent program), or no launch (no card): nothing read
    assert R(name).read({"trace": trace(
        [r for r in LOCAL if not r[0].startswith("local_round")])}) is None
    assert R(name).read({"trace": trace(
        [r for r in LOCAL if "Launch" not in r[0]])}) is None


def test_launches_of_another_thread_count_by_time():
    # autograd's backward thread launches while the step waits for it:
    # the rows carry no thread, and the launch lies inside the step
    host = [("local_round", 0.0, 100.0), ("local_round.step", 1.0, 98.0),
            ("autograd::engine::evaluate_function: MmBackward0", 20.0,
             30.0), ("cudaLaunchKernel", 25.0, 1.0)]
    assert spans.launches_per_step(trace(host)) == 1.0


@pytest.mark.parametrize("name,span", [("aggregate_s.fl", "sim.aggregate"),
                                       ("schedule_s.fl", "sim.schedule")])
def test_host_span_seconds_per_round(name, span):
    host = [(span, 0.0, 300.0), ("sim.eval", 400.0, 50.0),
            (span, 1000.0, 100.0), ("aten::add", 1010.0, 5.0)]
    ctx = {"trace": trace(host), "trace_rounds": 2}
    assert R(name).read(ctx) == pytest.approx(400e-6 / 2)
    assert R(name).read({**ctx, "trace_rounds": 0}) is None
    assert R(name).read({**ctx, "trace": trace(host[1:2])}) is None


def test_sync_device_ms_clips_to_the_sync_body():
    host = [
        # round 1: the drain waits 0-40 for the local round's tail
        ("pod.sync", 0.0, 200.0),
        ("cudaDeviceSynchronize", 1.0, 38.0),
        ("pod_sync.compact_pack", 40.0, 20.0),
        ("pod_sync.all_gather", 60.0, 10.0),
        ("pod_sync.scatter_apply", 70.0, 10.0),
        # round 2, dense wire
        ("pod.sync", 1000.0, 100.0),
        ("pod_sync.dense", 1010.0, 50.0),
    ]
    device = [
        ("backward tail", -20.0, 50.0),     # before the body: left out
        ("hist_kernel", 45.0, 30.0),         # [45, 75)
        ("compact_kernel", 70.0, 20.0),      # overlaps: union to 90
        ("index_add", 190.0, 30.0),          # partly after: [190, 200)
        ("gemm", 500.0, 100.0),              # between the spans
        ("ef_topk_kernel", 1005.0, 40.0),    # [1010, 1045) in the body
    ]
    ctx = {"trace": trace(host, device), "trace_rounds": 2}
    busy_us = (90 - 45) + (200 - 190) + (1045 - 1010)
    assert R("sync_device_ms.pod").read(ctx) == pytest.approx(
        1e-3 * busy_us / 2)
    # no inner range: the whole span counts
    only = trace([host[0]], device)
    assert spans.device_ms_inside(only, "pod.sync", "pod_sync.", 1) == \
        pytest.approx(1e-3 * (30 + 45 + 10))


def test_sync_device_ms_reads_nothing_without_span_or_card():
    host = [("pod.sync", 0.0, 100.0), ("pod_sync.dense", 5.0, 50.0)]
    read = R("sync_device_ms.pod").read
    assert read({"trace": trace(host[1:], [("k", 10.0, 5.0)]),
                 "trace_rounds": 1}) is None
    assert read({"trace": trace(host, []), "trace_rounds": 1}) is None
