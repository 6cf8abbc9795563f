"""The batched engine's chunk graphs (`core/simulator.py`: `_ChunkGraph`
over the drain's `_Arena`, captured by `dist.steps.capture_graph`).

On the CPU the engine runs every local round eagerly, as before. The
graph path's plumbing (the arena's staging and output views, the cache
entry's eager -> capture -> replay order, re-capture where the tensors
moved, the counters) is held on the CPU with a fake capture whose replay
runs the captured call again. The test marked `card` holds real graph
replays against the eager path on a CUDA card, and skips here.
"""
import contextlib
import gc

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import simulator as TS  # noqa: E402
from repro_torch.core.controller import DeviceProfile  # noqa: E402
from repro_torch.core.factor import Plan  # noqa: E402
from repro_torch.models import small  # noqa: E402
from repro_torch.obs import MetricsRegistry  # noqa: E402


def _fleet(cfg):
    """DeviceSpecs from (k, δ, compressor, error feedback) per device;
    every cycle ends well inside the 1 s period, so each round's drain
    starts every device."""
    out = []
    for did, (k, delta, comp, ef) in enumerate(cfg):
        p = DeviceProfile(did, 0.01, 0.5)
        out.append(TS.DeviceSpec(
            p, Plan(k, delta, 0.0, k * p.alpha + delta * p.beta, 1), comp,
            ef))
    return out


def _task(name="mlp_micro", **kw):
    task = small.make_task(name, **kw)
    task.init_fn = lambda gen, f=task.init_fn: f(
        torch.Generator().manual_seed(5))
    return task


# mlp_micro on the CPU: a 4-row and a 2-row topk EF chunk (k 3 and 1), a
# one-row topk chunk without EF in the "full" band, and topk_threshold
# chunks of 1 and 2 rows
MIXED = ([(3, 0.05, "topk", True)] * 4 + [(1, 0.05, "topk", True)] * 2
         + [(2, 1.0, "topk", False)] + [(3, 0.1, "topk_threshold", True)]
         + [(1, 0.2, "topk_threshold", True)] * 2)


def _run(sim, rounds=4):
    """Run `sim`; every arrival's payload (dense, in arrival order), the
    model, the residuals and the metrics."""
    got = []
    on_arrival = sim.agg.on_arrival

    def rec(t, a):
        u = a.update
        got.append(np.array(u.dense() if hasattr(u, "dense") else u))
        return on_arrival(t, a)
    sim.agg.on_arrival = rec
    hist = sim.run(total_rounds=rounds, eval_every=1)
    sim.close()
    return {"payloads": got, "w": sim.model.w.copy(),
            "res": sim.residual_snapshot()[1].copy(),
            "records": [(r.round, r.accuracy, r.loss) for r in hist.records]}


def _sim(cfg=MIXED, metrics=None, **kw):
    return TS.AFLSimulator(_task(num_samples=400, test_samples=40,
                                 batch_size=8), _fleet(cfg), "periodic",
                           seed=2, device="cpu", metrics=metrics, **kw)


def _same(a, b):
    assert len(a["payloads"]) == len(b["payloads"]) > 0
    for x, y in zip(a["payloads"], b["payloads"]):
        assert np.array_equal(x, y)
    assert np.array_equal(a["w"], b["w"])
    assert np.array_equal(a["res"], b["res"])
    assert a["records"] == b["records"]


class _FakeGraph:
    """Stands in for a captured CUDA graph: its replay runs the call."""

    def __init__(self, fn, log):
        self.fn, self.log = fn, log

    def replay(self):
        self.log.append("replay")
        self.fn()


@pytest.fixture
def fake_capture(monkeypatch):
    """`capture_graph` replaced by a fake that records the call (and
    runs nothing, as a capture runs no kernel); returns the event log."""
    log = []

    def capture(fn, pool):
        log.append("capture")
        return _FakeGraph(fn, log)
    monkeypatch.setattr(TS, "capture_graph", capture)
    return log


def test_cpu_engine_runs_eagerly():
    m = MetricsRegistry()
    sim = _sim(metrics=m)
    assert sim._graph_pool is None and sim._arena_pool is None
    batched = _run(sim)
    assert sim._arena is None
    assert not any(isinstance(fn, TS._ChunkGraph)
                   for fn in sim._bucket_fns.values())
    counters = m.snapshot()["counters"]
    assert counters.get("engine.graph_captures", 0) == 0
    assert counters.get("engine.graph_replays", 0) == 0
    assert counters["engine.bucket_compiles"] > 0
    # mlp_micro has no convolution: the batched engine's payloads are
    # bitwise the sequential engine's
    _same(batched, _run(_sim(engine="sequential")))


@pytest.mark.parametrize("cfg,rows,P", [
    (MIXED, 12, 4),                          # k 3 x 4 rows
    ([(2, 0.05, "topk", True)] * 20, 32, 16),   # 20 members: cap 16
    ([(30, 0.05, "topk", True)] + [(2, 0.05, "topk", True)] * 5, 30, 4),
    ([(5, 0.1, "topk_threshold", False)] * 3, 10, 2),
])
def test_arena_sizes_follow_the_plan(cfg, rows, P):
    sim = _sim(cfg)
    assert (sim._arena_rows, sim._arena_P) == (rows, P)
    sim.close()


def test_a_replan_resizes_the_arena():
    sim = _sim()
    assert (sim._arena_rows, sim._arena_P) == (12, 4)
    # as `_maybe_replan` applies a new plan: the 4-row bucket's devices
    # move to k 7 in two bands, and the k 1 pair to k 20
    for did, (k, delta) in {0: (7, 0.05), 1: (7, 0.05), 2: (7, 0.4),
                            3: (7, 0.4), 4: (20, 0.05),
                            5: (20, 0.05)}.items():
        spec = sim.devices[did]
        spec.plan = Plan(k, delta, 0.0, spec.plan.round_time, 1)
        sim._stacked[did].set_k(k)
    sim._plan_buckets()
    assert (sim._arena_rows, sim._arena_P) == (40, 2)
    sim.close()


def test_cache_entry_is_eager_then_captures_then_replays(fake_capture):
    log = fake_capture
    calls = []
    out_buf = torch.zeros((2, 3))

    def round_fn(flat, steps):
        log.append("run")
        calls.append((flat.data_ptr(), steps[0]["x"].data_ptr()))
        return flat + 10.0 * steps[0]["x"]

    m = MetricsRegistry()
    fn = TS._ChunkGraph(round_fn, lambda: out_buf, None, m)
    flat, x = torch.arange(3.0), torch.ones((2, 3))
    steps = [{"x": x}]
    g_of = lambda v: flat + torch.full((2, 3), 10.0 * v)  # noqa: E731

    # first use: eager, its own result, nothing captured
    g = fn(flat, steps)
    assert log == ["run"] and g.data_ptr() != out_buf.data_ptr()
    assert torch.equal(g, g_of(1.0))
    assert m.snapshot()["counters"] == {}
    # second use: capture (which runs nothing on the card: the fake's
    # replay runs the call), then replay into the output view
    log.clear()
    x.fill_(2.0)
    g = fn(flat, steps)
    assert log == ["capture", "replay", "run"]
    assert g.data_ptr() == out_buf.data_ptr()
    assert torch.equal(g, g_of(2.0))
    # later uses replay the same graph on fresh data in the same tensors
    for v in (3.0, 4.0):
        log.clear()
        x.fill_(v)
        assert torch.equal(fn(flat, steps), g_of(v))
        assert log == ["replay", "run"]
    counters = m.snapshot()["counters"]
    assert counters == {"engine.graph_captures": 1.0,
                        "engine.graph_replays": 3.0}
    # a tensor that moved: captured again over the new address
    log.clear()
    moved = [{"x": torch.full((2, 3), 5.0)}]
    assert torch.equal(fn(flat, moved), g_of(5.0))
    assert log == ["capture", "replay", "run"]
    assert calls[-1][1] == moved[0]["x"].data_ptr()
    assert m.snapshot()["counters"]["engine.graph_captures"] == 2.0


def test_graph_path_on_the_cpu_with_a_fake_capture(fake_capture,
                                                   monkeypatch):
    """The simulator's graph path end to end, with the pools faked: the
    arena's staging and output views and the chunk graphs give the eager
    engine's payloads, model and residuals bitwise."""
    monkeypatch.setattr(torch.cuda, "use_mem_pool",
                        lambda pool: contextlib.nullcontext())
    m = MetricsRegistry()
    sim = _sim(metrics=m)
    sim._graph_pool = sim._arena_pool = object()
    staged = []
    stage = TS._Arena.stage

    def stage_rec(arena, host):
        staged.append(arena)
        return stage(arena, host)
    monkeypatch.setattr(TS._Arena, "stage", stage_rec)
    graphed = _run(sim, rounds=5)
    c = m.snapshot()["counters"]
    # 5 chunk shapes, each eager in the first drain and replayed in the
    # 4 later ones (CPU tensors do not keep their addresses between
    # drains, so some captures repeat)
    assert c["engine.graph_replays"] == 5 * 4
    assert 5 <= c["engine.graph_captures"] <= 5 * 4
    assert fake_capture.count("replay") == 5 * 4
    assert len(staged) == 5 * 5 and sim._arena is None
    _same(graphed, _run(_sim(), rounds=5))


# ---------------------------------------------------------------- the card
# the CNN at the paper's width: a 4-row topk EF chunk of k 3, a 2-row one
# of k 1, a one-row one of k 1 (another band), and topk_threshold chunks
# of one row (k 3) and two rows (k 1)
CNN = ([(3, 0.01, "topk", True)] * 4 + [(1, 0.01, "topk", True)] * 2
       + [(1, 0.1, "topk", True)] + [(3, 0.02, "topk_threshold", True)]
       + [(1, 0.05, "topk_threshold", True)] * 2)
# the evaluation holds the peak, as in the FL cells of the benchmark,
# where `sim.eval` sets it (PERF.md): with 2400 test images its
# activations exceed the 4-row vmapped round's
TEST_IMAGES = 2400


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    # fp32 as the FL cells run it; deterministic cuDNN algorithms, since
    # the one-row round's default weight gradient differs from one eager
    # run to the next (atomics), and graph and eager are compared bitwise
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = saved


def _keep(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


def _card_run(graphs: bool, rounds: int, task=None, cfg=CNN) -> dict:
    """A fleet (default: the CNN one) on the card, with the chunk graphs
    (`graphs`) or with the engine's eager path; each chunk's local-round
    output g and payload, in dispatch order, and the memory the run
    allocated at its peak and in its highest drain, over what was
    allocated before it.
    Both runs start alike: no simulator of an earlier run is left (its
    chunk functions refer back to it, so only the cycle collector frees
    it), and no cuBLAS workspace."""
    gc.collect()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    if task is None:
        task = _task("cnn_fmnist", num_samples=2000,
                     test_samples=TEST_IMAGES, batch_size=32)
    sim = TS.AFLSimulator(task, _fleet(cfg), "periodic", seed=4,
                          device="cuda", metrics=MetricsRegistry())
    if not graphs:
        sim._graph_pool = sim._arena_pool = None
    gs, payloads, peaks, drain_peaks = [], [], [], []

    def record(g):
        gs.append(_keep(g))
        return g

    def collect(rec, results, real=sim._collect_chunk):
        payloads.append([_keep(t) for t in (
            rec[2] if isinstance(rec[2], tuple) else (rec[2],))])
        return real(rec, results)

    def drain(starts, push, real=sim._process_starts_batched):
        # the peak so far, then this drain's own
        peaks.append(torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        out = real(starts, push)
        drain_peaks.append(torch.cuda.max_memory_allocated())
        return out

    with pytest.MonkeyPatch.context() as mp:
        if graphs:
            mp.setattr(TS._ChunkGraph, "__call__",
                       lambda self, *a, real=TS._ChunkGraph.__call__:
                       record(real(self, *a)))
        else:
            mp.setattr(sim, "_local_round", lambda *a, real=sim._local_round:
                       record(real(*a)[None])[0])
            mp.setattr(TS, "batched_local_round",
                       lambda *a, real=TS.batched_local_round:
                       record(real(*a)))
        mp.setattr(sim, "_collect_chunk", collect)
        mp.setattr(sim, "_process_starts_batched", drain)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        hist = sim.run(total_rounds=rounds, eval_every=1)
        torch.cuda.synchronize()
    out = {"g": gs, "payloads": payloads,
           "peak": max(peaks + drain_peaks
                       + [torch.cuda.max_memory_allocated()]) - base,
           "drain_peak": max(drain_peaks) - base, "w": sim.model.w.copy(),
           "res": sim.residual_snapshot()[1].copy(),
           "evals": len(hist.records),
           "counters": sim._metrics.snapshot()["counters"],
           "arena_out": sim._arena_P * sim.dim * 4}
    sim.close()
    del sim
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _assert_replays_equal_eager(graph, eager, rounds, shapes):
    c = graph["counters"]
    # every chunk shape: eager in the first drain, captured in the second,
    # replayed in every later one, with an evaluation between drains
    assert c["engine.graph_captures"] == shapes
    assert c["engine.graph_replays"] == shapes * (rounds - 1)
    assert graph["evals"] == eager["evals"] >= rounds
    assert len(graph["g"]) == len(eager["g"]) == shapes * rounds
    for a, b in zip(graph["g"], eager["g"]):
        assert a.shape == b.shape and torch.equal(a, b)
    assert len(graph["payloads"]) == len(eager["payloads"])
    for a, b in zip(graph["payloads"], eager["payloads"]):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    assert np.array_equal(graph["w"], eager["w"])
    assert np.array_equal(graph["res"], eager["res"])


@pytest.mark.card
def test_replay_equals_eager_on_the_card(card):
    rounds = 5
    eager = _card_run(False, rounds)
    graph = _card_run(True, rounds)
    _assert_replays_equal_eager(graph, eager, rounds, shapes=5)
    print(f"allocated over the start, eager / graphs: peak "
          f"{eager['peak']} / {graph['peak']} B, highest drain "
          f"{eager['drain_peak']} / {graph['drain_peak']} B, arena output "
          f"{graph['arena_out']} B")
    # nothing of the graph path is live at the evaluation, which holds
    # the peak; inside a drain it adds at most the arena's output
    assert graph["peak"] <= 1.01 * eager["peak"]
    assert eager["drain_peak"] < eager["peak"]
    assert graph["drain_peak"] <= 1.01 * eager["drain_peak"] \
        + graph["arena_out"]


# the engine's other tasks: a 2-row topk EF chunk of k 2 and a one-row one
# of k 1
OTHER = [(2, 0.05, "topk", True)] * 2 + [(1, 0.1, "topk", True)]


@pytest.mark.card
@pytest.mark.parametrize("name", ["mlp_fmnist", "vgg11s_cifar10",
                                  "lstm_sc"])
def test_replay_equals_eager_on_other_tasks(card, name):
    rounds = 3
    eager, graph = (_card_run(graphs, rounds, _task(
        name, num_samples=300, test_samples=50, batch_size=16), OTHER)
        for graphs in (False, True))
    _assert_replays_equal_eager(graph, eager, rounds, shapes=2)
