"""The port's span tree (`obs.profiling.annotate`), on the CPU.

Under `torch.profiler` with profiling on, a small `AFLSimulator` run and a
tiny pod round record the spans `obs.profiling` lists, each child inside
one of its parent's intervals, and no `sim.schedule` span holds a phase.
With profiling off and no timers every site gets the shared null
context; the simulator's `PhaseTimers` keys are the five phases.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import simulator as S  # noqa: E402
from repro_torch.core.controller import DeviceProfile  # noqa: E402
from repro_torch.core.factor import Plan  # noqa: E402
from repro_torch.launch import profile_pod  # noqa: E402
from repro_torch.models.small import make_task  # noqa: E402
from repro_torch.obs import MetricsRegistry, PhaseTimers  # noqa: E402
from repro_torch.obs import profiling  # noqa: E402

PHASES = ("sim.heap_drain", "sim.dispatch", "sim.collect", "sim.aggregate",
          "sim.eval")
# (did, k, delta, ef): devices 0 and 2 share a bucket (one two-row,
# vmapped chunk); the one-row fleet gives every device a k of its own
VMAPPED = [(0, 2, 0.05, True), (1, 3, 1.0, False), (2, 2, 0.05, True)]
ONE_ROW = [(0, 2, 0.05, True), (1, 3, 0.2, False), (2, 4, 0.05, True)]


def _sim(fleet, engine="batched", **kw):
    task = make_task("mlp_micro", num_samples=300, test_samples=50,
                     batch_size=8)
    specs = []
    for did, k, delta, ef in fleet:
        p = DeviceProfile(did, 0.01 * (1 + did), 2.0)
        specs.append(S.DeviceSpec(
            p, Plan(k, delta, 0.0, k * p.alpha + delta * p.beta, 1), "topk",
            ef))
    return S.AFLSimulator(task, specs, "periodic", round_period=1.0, seed=3,
                          engine=engine, device="cpu", **kw)


def _spans(fn):
    """{name: [(start_us, end_us)]} of the host rows recorded over fn()
    with profiling on."""
    profiling.set_profiling(True)
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            fn()
    finally:
        profiling.set_profiling(False)
    out = {}
    for e in prof.events():
        out.setdefault(e.name, []).append((e.time_range.start,
                                           e.time_range.end))
    return out


def _inside(child, parents):
    return any(a <= child[0] and child[1] <= b for a, b in parents)


def _assert_nested(spans, child, parent):
    assert spans.get(child), f"no {child} span"
    for c in spans[child]:
        assert _inside(c, spans[parent]), f"{child} {c} outside {parent}"


@pytest.mark.parametrize("fleet", [VMAPPED, ONE_ROW],
                         ids=["vmapped", "one_row"])
def test_simulator_span_tree(fleet, monkeypatch):
    sim = _sim(fleet)
    rows, ks = [], []
    real = S.batched_local_round

    def spy(loss_fn, opt, flat, spec, batches):
        rows.append(next(iter(batches[0].values())).shape[0])
        return real(loss_fn, opt, flat, spec, batches)
    monkeypatch.setattr(S, "batched_local_round", spy)
    real_dispatch = S.AFLSimulator._dispatch_chunk

    def dispatch(self, bkey, items, flat):
        ks.append(self.devices[items[0][1]].plan.k)
        return real_dispatch(self, bkey, items, flat)
    monkeypatch.setattr(S.AFLSimulator, "_dispatch_chunk", dispatch)
    spans = _spans(lambda: sim.run(total_rounds=3, eval_every=1))
    # the vmapped path runs in the first fleet only
    assert bool(rows) == (fleet is VMAPPED) and all(r > 1 for r in rows)
    for child, parent in [("sim.draw", "sim.heap_drain"),
                          ("sim.dispatch", "sim.heap_drain"),
                          ("sim.collect", "sim.heap_drain"),
                          ("sim.stage", "sim.dispatch"),
                          ("local_round", "sim.dispatch"),
                          ("local_round.step", "local_round"),
                          ("sim.compress", "sim.dispatch")]:
        _assert_nested(spans, child, parent)
    for name in ("sim.schedule", "sim.aggregate", "sim.eval"):
        assert spans.get(name), f"no {name} span"
    # the event loop's spans hold no phase
    for a, b in spans["sim.schedule"]:
        for ph in PHASES:
            assert not any(a <= s and e <= b for s, e in spans[ph])
    # one local round and one stage per chunk, one step span per
    # optimizer step of each chunk
    assert len(spans["local_round"]) == len(spans["sim.stage"]) == len(ks)
    assert len(spans["local_round.step"]) == sum(ks)


def test_sequential_span_tree():
    sim = _sim(ONE_ROW, engine="sequential")
    spans = _spans(lambda: sim.run(total_rounds=2, eval_every=1))
    for child in ("sim.stage", "local_round", "sim.compress"):
        _assert_nested(spans, child, "sim.dispatch")
    _assert_nested(spans, "local_round.step", "local_round")
    for a, b in spans["sim.schedule"]:
        assert not any(a <= s and e <= b for s, e in spans["sim.dispatch"])


@pytest.mark.parametrize("rate", [0.05, 0.9], ids=["compact", "dense"])
def test_pod_round_span_tree(rate):
    k, n_pods = 2, 2
    pr = profile_pod.build_pod_round(
        "cpu", rate, task=make_task("mlp_micro", num_samples=64,
                                    test_samples=8, batch_size=4),
        mesh={"pod": n_pods, "data": 1, "model": 1}, blk=64, k=k, batch=4)
    batches = pr.draw()
    spans = _spans(lambda: pr.step(pr.params, pr.opt_states, batches,
                                   pr.residuals))
    assert len(spans["pod.round"]) == 1
    assert len(spans["local_round"]) == n_pods
    assert len(spans["local_round.step"]) == n_pods * k
    _assert_nested(spans, "local_round", "pod.round")
    _assert_nested(spans, "local_round.step", "local_round")
    _assert_nested(spans, "pod.sync", "pod.round")
    inner = (["pod_sync.compact_pack", "pod_sync.all_gather",
              "pod_sync.scatter_apply"] if rate < 0.5 else
             ["pod_sync.dense"])
    assert pr.sync.path == ("compact" if rate < 0.5 else "dense")
    for name in inner:
        _assert_nested(spans, name, "pod.sync")


def test_sites_get_the_null_context_when_off(monkeypatch):
    """Profiling off and no timers: no span opens a range or times
    anything, in the simulator or the pod round."""
    def refuse(*a, **kw):
        raise AssertionError("a span went past the null context")
    monkeypatch.setattr(profiling, "_range", refuse)
    monkeypatch.setattr(profiling, "_timed", refuse)
    assert profiling.annotate("sim.schedule") is profiling._NULL_CTX
    _sim(VMAPPED).run(total_rounds=2, eval_every=1)
    _sim(ONE_ROW, engine="sequential").run(total_rounds=2, eval_every=1)
    pr = profile_pod.build_pod_round(
        "cpu", 0.05, task=make_task("mlp_micro", num_samples=64,
                                    test_samples=8, batch_size=4),
        mesh={"pod": 2, "data": 1, "model": 1}, blk=64, k=2, batch=4)
    pr.step(pr.params, pr.opt_states, pr.draw(), pr.residuals)


@pytest.mark.parametrize("engine,keys", [
    ("batched", {"heap_drain", "dispatch", "collect", "aggregate", "eval"}),
    ("sequential", {"dispatch", "aggregate", "eval"})])
def test_phase_timer_keys(engine, keys, monkeypatch):
    """The simulator times exactly its phases, under their own names,
    without opening a range while profiling is off."""
    monkeypatch.setattr(profiling, "_range", lambda name: pytest.fail(
        "a range opened with profiling off"))
    m = MetricsRegistry()
    sim = _sim(VMAPPED if engine == "batched" else ONE_ROW, engine=engine,
               metrics=m)
    sim.run(total_rounds=2, eval_every=1)
    assert set(sim._timers.totals) == keys
    assert all(sim._timers.calls[k] > 0 for k in keys)
    assert {k for k in m.snapshot()["counters"] if k.startswith("time.")} \
        == {f"time.{k}_{x}" for k in keys for x in ("s", "calls")}


def test_timed_span_adds_to_its_key_and_opens_a_range():
    timers = PhaseTimers()
    profiling.set_profiling(True)
    try:
        with torch.profiler.profile() as prof:
            with profiling.annotate("sim.eval", timers, "eval"):
                torch.ones(4).sum()
            with timers.phase("local"):
                pass
    finally:
        profiling.set_profiling(False)
    assert set(timers.totals) == {"eval", "local"}
    assert timers.calls == {"eval": 1, "local": 1}
    names = {e.name for e in prof.events()}
    assert {"sim.eval", "local"} <= names
