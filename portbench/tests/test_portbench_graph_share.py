"""`graph_round_share.fl` on hand-made traces: host rows (name, start_us,
dur_us), as `device.Trace` holds them."""
from __future__ import annotations

import types

import pytest

from portbench.harness import spec

R = spec.metric_reader("graph_round_share.fl")


def trace(host):
    return types.SimpleNamespace(host=list(host), device=[],
                                 window=(0.0, 1e6))


def eager(t0):
    """An eager local round of two steps at `t0`: kernel launches, no
    graph launch."""
    return [("local_round", t0, 50.0),
            ("local_round.step", t0 + 1.0, 20.0),
            ("cudaLaunchKernel", t0 + 2.0, 1.0),
            ("local_round.step", t0 + 25.0, 20.0),
            ("cuLaunchKernel", t0 + 26.0, 1.0)]


def replayed(t0):
    """A replayed local round at `t0`: one graph launch, no steps."""
    return [("local_round", t0, 10.0), ("cudaGraphLaunch", t0 + 2.0, 5.0)]


# graph launches outside any local round (before, between, after) never
# count, nor make a round count
OUTSIDE = [("cudaGraphLaunch", 5.0, 1.0), ("cudaGraphLaunch", 480.0, 1.0),
           ("cudaGraphLaunch", 2000.0, 1.0)]


@pytest.mark.parametrize("rounds,expected", [
    ([replayed(100.0), replayed(200.0), replayed(300.0)], 100.0),
    ([eager(100.0), eager(200.0), eager(300.0)], 0.0),
    ([eager(100.0), replayed(200.0), eager(300.0), replayed(400.0)], 50.0),
    ([replayed(100.0), eager(200.0), eager(300.0), eager(400.0)], 25.0),
])
def test_share_of_replayed_rounds(rounds, expected):
    host = OUTSIDE + [row for r in rounds for row in r]
    assert R.read({"trace": trace(host)}) == pytest.approx(expected)


def test_a_round_with_several_graph_launches_counts_once():
    host = eager(100.0) + [("local_round", 200.0, 30.0),
                           ("cudaGraphLaunch", 201.0, 2.0),
                           ("cudaGraphLaunch", 210.0, 2.0)]
    assert R.read({"trace": trace(host)}) == pytest.approx(50.0)


def test_a_cu_graph_launch_counts():
    # a graph launch through the low-level CUDA API
    host = [("local_round", 0.0, 10.0), ("cuGraphLaunch", 1.0, 2.0)]
    assert R.read({"trace": trace(host)}) == pytest.approx(100.0)


def test_no_local_round_span_reads_nothing():
    # the parent program without the span, or a run without a card
    host = [("sim.stage", 0.0, 10.0), ("cudaGraphLaunch", 1.0, 2.0),
            ("cudaLaunchKernel", 20.0, 1.0)]
    assert R.read({"trace": trace(host)}) is None
    assert R.read({"trace": trace([])}) is None
