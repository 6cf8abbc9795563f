"""The port's copies of `repro`'s numpy-only host modules give *equal*
results on the same inputs: plans, aggregator events and staleness logs,
failure windows, channel outcomes, partitions, datasets, loaders and the
observability exports."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import aggregation as JA  # noqa: E402
from repro.core import controller as JCtl  # noqa: E402
from repro.core import factor as JF  # noqa: E402
from repro.core import simulator as JS  # noqa: E402
from repro.data import partition as JP  # noqa: E402
from repro.data import pipeline as JPipe  # noqa: E402
from repro.data import synthetic as JSyn  # noqa: E402
from repro import ft as JFT  # noqa: E402
from repro import obs as JObs  # noqa: E402

from repro_torch.core import aggregation as TA  # noqa: E402
from repro_torch.core import controller as TCtl  # noqa: E402
from repro_torch.core import factor as TF  # noqa: E402
from repro_torch.core import simulator as TS  # noqa: E402
from repro_torch.data import partition as TP  # noqa: E402
from repro_torch.data import pipeline as TPipe  # noqa: E402
from repro_torch.data import synthetic as TSyn  # noqa: E402
from repro_torch import ft as TFT  # noqa: E402
from repro_torch import obs as TObs  # noqa: E402


def _spec_tuple(s):
    return (dataclasses.astuple(s.profile), dataclasses.astuple(s.plan),
            s.compressor, s.error_feedback, s.compressor_kwargs, s.rate)


class TestPlans:
    @pytest.mark.parametrize("method", sorted(JS.STRATEGY_FOR_METHOD))
    @pytest.mark.parametrize("k_grid", [None, [1, 2, 4, 8, 16]])
    def test_plan_devices_equal(self, method, k_grid):
        jp = JS.make_heterogeneous_devices(6, 2.5e6, seed=3)
        tp = TS.make_heterogeneous_devices(6, 2.5e6, seed=3)
        assert [dataclasses.astuple(p) for p in jp] == \
            [dataclasses.astuple(p) for p in tp]
        kw = dict(k_bounds=(1, 30), fixed_k=5, fixed_delta=0.05,
                  error_feedback=True, k_grid=k_grid)
        js = JS.plan_devices(jp, method, 1.0, **kw)
        ts = TS.plan_devices(tp, method, 1.0, **kw)
        assert [_spec_tuple(s) for s in js] == [_spec_tuple(s) for s in ts]
        assert TS.STRATEGY_FOR_METHOD == JS.STRATEGY_FOR_METHOD

    def test_solvers_and_controller_equal(self):
        for a, b in [(0.02, 5.0), (0.08, 40.0), (0.5, 0.1)]:
            assert dataclasses.astuple(JF.solve_plan(a, b, 1.0)) == \
                dataclasses.astuple(TF.solve_plan(a, b, 1.0))
            assert dataclasses.astuple(
                JF.solve_plan_fixed_delta(a, b, 1.0, 0.1)) == \
                dataclasses.astuple(TF.solve_plan_fixed_delta(a, b, 1.0, 0.1))
            assert dataclasses.astuple(JF.solve_plan_fixed_k(a, b, 1.0, 7)) \
                == dataclasses.astuple(TF.solve_plan_fixed_k(a, b, 1.0, 7))
        jc = JCtl.FedLuckController(1.0, (1, 8), (0.05, 1.0))
        tc = TCtl.FedLuckController(1.0, (1, 8), (0.05, 1.0))
        for alpha in (0.1, 0.11, 0.3, 0.05):
            jplan = jc.update_profile(JCtl.DeviceProfile(0, alpha, 2.0))
            tplan = tc.update_profile(TCtl.DeviceProfile(0, alpha, 2.0))
            assert dataclasses.astuple(jplan) == dataclasses.astuple(tplan)
        assert jc.replans == tc.replans and jc.summary() == tc.summary()

    def test_profile_alpha_defaults_to_the_card(self):
        import inspect
        sig = inspect.signature(TCtl.profile_alpha)
        assert sig.parameters["device"].default == "cuda"

    def test_profile_alpha_on_the_cpu(self, monkeypatch):
        """An explicit device="cpu" runs warmup + iters steps and never
        synchronises a CUDA device."""
        calls = []
        monkeypatch.setattr(TCtl, "_cuda_sync",
                            lambda: pytest.fail("synchronised on the CPU"))
        alpha = TCtl.profile_alpha(lambda: calls.append(1), warmup=2,
                                   iters=3, device="cpu")
        assert len(calls) == 5 and 0.0 <= alpha < 1.0


def _arrivals(mod, sparse: bool):
    rng = np.random.RandomState(5)
    out = []
    for i in range(12):
        u = rng.randn(50).astype(np.float32)
        if i == 4:
            u[3] = np.nan
        if sparse and i % 3 == 0:
            idx = rng.choice(50, 5, replace=False).astype(np.int32)
            u = mod.SparseUpdate(u[idx], idx, 50, 5)
        out.append(mod.Arrival(i % 4, u, max(0, i // 3 - (i % 3)),
                               64.0 * (i + 1), 0.1 * i))
    return out


def _ev(e):
    return (e.time, e.new_round, list(e.release_to), dict(e.staleness))


class TestAggregation:
    @pytest.mark.parametrize("name,kw", [("periodic", {}),
                                         ("fedbuff", {"buffer_size": 3}),
                                         ("fedasync", {}),
                                         ("sync", {"num_devices": 4})])
    @pytest.mark.parametrize("sparse", [False, True])
    def test_events_staleness_and_model_equal(self, name, kw, sparse):
        w0 = np.random.RandomState(0).randn(50).astype(np.float32)
        res = []
        for mod in (JA, TA):
            model = mod.GlobalModel(w0, eta_g=0.5)
            agg = mod.make_aggregator(name, model, **kw)
            agg.sanitizer = mod.UpdateSanitizer(mod.SanitizerConfig(
                tau_max=2, clip_norm=3.0))
            if name == "sync":
                agg.begin_round(0.0, [0, 1, 2, 3])
            events = []
            for a in _arrivals(mod, sparse):
                events += [_ev(e) for e in agg.on_arrival(a.arrive_time, a)]
                if a.device_id == 3:
                    events += [_ev(e) for e in agg.on_round_boundary(
                        a.arrive_time)]
            res.append((events, list(agg.staleness_log), model.w.copy(),
                        model.round, agg.total_bits,
                        dict(agg.sanitizer.counts)))
        (je, js, jw, jr, jb, jc), (te, ts, tw, tr, tb, tc) = res
        assert je == te and js == ts and jr == tr and jb == tb and jc == tc
        np.testing.assert_array_equal(jw, tw)


class TestFaultModels:
    def test_failure_schedule_equal(self):
        js = JFT.FailureSchedule.random(6, 20.0, rate_per_device=1.5, seed=9)
        ts = TFT.FailureSchedule.random(6, 20.0, rate_per_device=1.5, seed=9)
        assert [dataclasses.astuple(w) for w in js.windows] == \
            [dataclasses.astuple(w) for w in ts.windows]
        for d in range(6):
            for t in np.linspace(0, 20, 41):
                assert js.is_down(d, t) == ts.is_down(d, t)
                assert js.recovery_time(d, t) == ts.recovery_time(d, t)
                assert js.crash_recovery(d, t, t + 1.3) == \
                    ts.crash_recovery(d, t, t + 1.3)
                assert js.lost_in_flight(d, t, t + 0.7) == \
                    ts.lost_in_flight(d, t, t + 0.7)

    def test_lossy_channel_outcomes_equal(self):
        chans = [mod.LossyChannel(
            loss_prob={0: 0.5, 1: 0.2, 2: 0.0}, corrupt_prob=0.2,
            drift=[mod.BandwidthDrift(1, 1.0, 2.5)], seed=11)
            for mod in (JFT, TFT)]
        for ch in chans:
            ch.trace_attempts = True
        outs = [[], []]
        for i in range(40):
            did = i % 3
            for ch, out in zip(chans, outs):
                c = ch.maybe_corrupt(did)
                arr = ch.transmit(did, 0.3 * i, 0.4)
                ch.charge_wire(1000.0, arr[1], arr[0] is not None)
                out.append((c, arr, list(ch.last_attempts),
                            ch.beta_multiplier(did, 0.3 * i)))
        assert outs[0] == outs[1]
        assert chans[0].counters == chans[1].counters


class TestData:
    def test_partitions_equal(self):
        labels = np.random.RandomState(1).randint(0, 10, 500)
        for a, b in zip(JP.iid_partition(500, 7, seed=2),
                        TP.iid_partition(500, 7, seed=2)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(JP.dirichlet_partition(labels, 5, seed=3),
                        TP.dirichlet_partition(labels, 5, seed=3)):
            np.testing.assert_array_equal(a, b)

    def test_datasets_and_loader_streams_equal(self):
        for kw in ({"shape": (28, 28, 1), "num_samples": 40, "seed": 0,
                    "sample_seed": 999},
                   {"shape": (8, 8, 1), "num_samples": 100, "seed": 1}):
            ja, ta = (JSyn.SyntheticClassification(**kw),
                      TSyn.SyntheticClassification(**kw))
            np.testing.assert_array_equal(ja.images, ta.images)
            np.testing.assert_array_equal(ja.labels, ta.labels)
        js, ts = (JSyn.SyntheticSpeech(num_samples=30),
                  TSyn.SyntheticSpeech(num_samples=30))
        np.testing.assert_array_equal(js.frames, ts.frames)
        idx = np.arange(10, 90)
        jl = JPipe.DataLoader(ja, idx, batch_size=16, seed=17)
        tl = TPipe.DataLoader(ta, idx, batch_size=16, seed=17)
        for _ in range(12):
            jb, tb = jl.next(), tl.next()
            for k in jb:
                np.testing.assert_array_equal(jb[k], tb[k])
        jsl = JPipe.StackedLoader(JPipe.DataLoader(ja, idx, 8, seed=1), 3, 0)
        tsl = TPipe.StackedLoader(TPipe.DataLoader(ta, idx, 8, seed=1), 3, 0)
        for _ in range(4):
            np.testing.assert_array_equal(jsl.next()["image"],
                                          tsl.next()["image"])


class TestObs:
    def test_trace_metrics_and_exports_equal(self, tmp_path):
        outs = []
        for mod in (JObs, TObs):
            tr, m = mod.Tracer(), mod.MetricsRegistry()
            tr.span(mod.device_track(2), "local_round", 0.5, 1.25, k=3)
            tr.instant(mod.SERVER_TRACK, "aggregate", 2.0, round=1)
            tr.instant(mod.CONTROLLER_TRACK, "replan", 2.5, device=2)
            m.counter("sim.cycles").inc(3)
            m.gauge("sim.events").set(7)
            h = m.histogram("sim.staleness", mod.STALENESS_BUCKETS)
            for v in (0, 1, 3, 70):
                h.observe(v)
            timers = mod.PhaseTimers()
            with timers.phase("eval"):
                pass
            doc = mod.PerfettoExporter().to_chrome(tr)
            info = mod.validate_chrome_trace(doc)
            path = tmp_path / f"{mod.__name__}.json"
            m.to_json(str(path), extra={"engine": "sequential"})
            mod.validate_metrics_json(str(path))
            outs.append((tr.events, doc["traceEvents"], info,
                         m.snapshot(), sorted(timers.snapshot())))
        (je, jdoc, jinfo, jsnap, jt), (te, tdoc, tinfo, tsnap, tt) = outs
        assert [dataclasses.astuple(e) for e in je] == \
            [dataclasses.astuple(e) for e in te]
        assert jdoc == tdoc and jinfo == tinfo and jsnap == tsnap
        assert jt == tt

    def test_annotate_is_a_torch_profiler_region(self):
        from repro_torch.obs import profiling
        assert profiling.annotate("x") is profiling._NULL_CTX
        profiling.set_profiling(True)
        try:
            ctx = profiling.annotate("sim.local_round")
            assert isinstance(ctx, torch.profiler.record_function)
            with ctx:
                pass
        finally:
            profiling.set_profiling(False)

    def test_device_breakdown_sums_device_entries(self):
        """The launch profilers' summary: busy seconds from the CUDA
        entries' self times only, idle share of the wall, top by time."""
        from types import SimpleNamespace as NS
        from repro_torch.obs import profiling
        cuda, cpu = torch.autograd.DeviceType.CUDA, \
            torch.autograd.DeviceType.CPU
        events = [NS(key="conv", count=4, device_type=cuda,
                     self_device_time_total=3000.0),
                  NS(key="host", count=9, device_type=cpu,
                     self_device_time_total=9e9),
                  NS(key="copy", count=2, device_type=cuda,
                     self_device_time_total=1000.0)]
        out = profiling.device_breakdown(NS(key_averages=lambda: events),
                                         0.01, top=1)
        assert out["device_busy_s"] == pytest.approx(0.004)
        assert out["idle_share"] == pytest.approx(0.6)
        assert out["top"] == [{"name": "conv", "calls": 4, "ms": 3.0}]
        host_only = NS(key_averages=lambda: events[1:2])
        empty = profiling.device_breakdown(host_only, 0.01)
        assert empty == {"device_busy_s": None, "idle_share": None, "top": []}
