"""The port's batched simulator engine, on the CPU, on mlp_micro.

Mirrors `tests/test_simulator_batched.py` against `repro_torch`: on the
same device the batched engine (`vmap(grad)` local rounds over a stacked
[B, d] buffer, one `fused_momentum` call per step per chunk, per-row
compression, the [N+1, d] residual stack) is *bitwise* equal to the
port's sequential engine — weights, EF residuals, wire bits, records and
counters — on mixed-k / mixed-δ / EF fleets, with and without faults.

Against `repro`'s batched engine, from the same JAX-initialised weights:
event lists identical with accuracy and loss taken out, the whole metrics
snapshot without `time.*` identical (so `engine.*` is included), fault
counters, wire bits and staleness identical; accuracy and loss within
|Δacc| <= 0.02 and loss rtol 1e-3 (fp32 training in two frameworks: see
`tests/test_torch_slice.py`).
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import simulator as JS  # noqa: E402
from repro.core.aggregation import SanitizerConfig as JSan  # noqa: E402
from repro.core.controller import DeviceProfile as JProfile  # noqa: E402
from repro.core.controller import FedLuckController as JCtl  # noqa: E402
from repro.core.factor import Plan as JPlan  # noqa: E402
from repro import ft as JFT  # noqa: E402
from repro import obs as JObs  # noqa: E402
from repro.models import small as jsmall  # noqa: E402

from repro_torch.core import simulator as TS  # noqa: E402
from repro_torch.core.aggregation import SanitizerConfig as TSan  # noqa: E402
from repro_torch.core.controller import DeviceProfile as TProfile  # noqa: E402
from repro_torch.core.controller import FedLuckController as TCtl  # noqa: E402
from repro_torch.core.factor import Plan as TPlan  # noqa: E402
from repro_torch import ft as TFT  # noqa: E402
from repro_torch import obs as TObs  # noqa: E402
from repro_torch.kernels import fused_momentum as fm_mod  # noqa: E402
from repro_torch.models import small as tsmall  # noqa: E402

ACC_TOL, LOSS_RTOL = 0.02, 1e-3
TASK_KW = dict(num_samples=600, test_samples=200, batch_size=16)
# (did, k, delta, ef): three share k=2 (a multi-row chunk plus a
# singleton), δ = 1 devices ride the "full" band, EF on two of them
MIXED = [(0, 2, 0.05, True), (1, 5, 1.0, False), (2, 2, 0.2, True),
         (3, 2, 1.0, False)]
PKG = {
    "jax": dict(S=JS, Profile=JProfile, Plan=JPlan, FT=JFT, Obs=JObs,
                San=JSan, Ctl=JCtl),
    "torch": dict(S=TS, Profile=TProfile, Plan=TPlan, FT=TFT, Obs=TObs,
                  San=TSan, Ctl=TCtl),
}


@pytest.fixture(scope="module")
def weights():
    t = jsmall.make_task("mlp_micro", **TASK_KW)
    return jax.tree.map(np.asarray, t.init_fn(jax.random.PRNGKey(3)))


def _task(pkg, weights):
    if pkg == "jax":
        task = jsmall.make_task("mlp_micro", **TASK_KW)
        task.init_fn = lambda key: weights
    else:
        task = tsmall.make_task("mlp_micro", **TASK_KW)
        task.init_fn = lambda gen: tsmall.params_from_jax(weights)
    return task


def _fleet(pkg, cfg=MIXED, compressor="topk", ckw=None):
    m = PKG[pkg]
    out = []
    for did, k, delta, ef in cfg:
        p = m["Profile"](did, 0.01 * (1 + did), 2.0)
        rt = k * p.alpha + delta * p.beta
        out.append(m["S"].DeviceSpec(p, m["Plan"](k, delta, 0.0, rt, 1),
                                     compressor, ef, dict(ckw or {})))
    return out


def _faults(pkg, *, channel=False, sanitizer=False, controller=False):
    """Fresh stateful fault models per run, so both runs consume identical
    RNG streams (the reference's `_fault_run` fleet)."""
    m = PKG[pkg]
    FT = m["FT"]
    kw = {"failure_schedule": FT.FailureSchedule.random(
        4, 12.0, rate_per_device=1.0, mean_downtime=0.6, seed=4)}
    if channel:
        kw["channel"] = FT.LossyChannel(
            loss_prob=0.3, corrupt_prob=0.1,
            drift=[FT.BandwidthDrift(1, 2.0, 3.0)], seed=7)
        sanitizer = True   # NaN payloads must not reach the model
    if sanitizer:
        kw["sanitizer"] = m["San"](tau_max=8)
    if controller:
        kw["controller"] = m["Ctl"](1.0, (1, 8), (0.05, 1.0))
        kw["stragglers"] = [FT.StragglerDrift(2, 3.0, 4.0)]
    return kw


def _run(weights, engine, *, pkg="torch", strategy="periodic", rounds=6,
         fleet=None, obs=False, **kw):
    m = PKG[pkg]
    extra = {"device": "cpu"} if pkg == "torch" else {}
    tracer = m["Obs"].Tracer() if obs else None
    metrics = m["Obs"].MetricsRegistry() if obs else None
    sim = m["S"].AFLSimulator(
        _task(pkg, weights), fleet or _fleet(pkg), strategy,
        round_period=1.0, seed=3, engine=engine, tracer=tracer,
        metrics=metrics, **kw, **extra)
    h = sim.run(total_rounds=rounds, eval_every=2)
    _, res = sim.residual_snapshot()
    out = {
        "w": np.asarray(sim.model.w).copy(),
        "res": np.asarray(res).copy(),
        "bits": sim.agg.total_bits,
        "records": [(r.time, r.round, r.accuracy, r.loss, r.gbits,
                     r.mean_staleness, r.drops) for r in h.records],
        "windows": [r.window for r in h.records],
        "events": sim.events_processed,
        "counters": dict(h.counters),
        "staleness": list(sim.agg.staleness_log),
        "tracer": tracer, "metrics": metrics, "history": h,
    }
    sim.close()
    return out


def _assert_bitwise(b, s):
    assert np.array_equal(b["w"], s["w"])
    assert np.array_equal(b["res"], s["res"])
    assert b["bits"] == s["bits"]
    assert b["records"] == s["records"]
    assert b["events"] == s["events"]
    assert b["counters"] == s["counters"]


class TestEngineEquivalence:
    def test_batched_is_the_default_engine(self, weights):
        sim = TS.AFLSimulator(_task("torch", weights), _fleet("torch"),
                              device="cpu")
        assert sim.engine == "batched" and sim._batched
        assert sim._res_stack.shape == (5, sim.dim)   # [N+1, d]
        sim.close()

    def test_bitwise_equal_periodic(self, weights):
        _assert_bitwise(_run(weights, "batched"),
                        _run(weights, "sequential"))

    def test_bitwise_equal_strict_bits(self, weights):
        """count_index_bits=True: the strict per-compressor bits of every
        row of a chunk are those of the sequential cycles."""
        b = _run(weights, "batched", count_index_bits=True, rounds=4)
        s = _run(weights, "sequential", count_index_bits=True, rounds=4)
        assert b["bits"] == s["bits"] > 0
        assert np.array_equal(b["w"], s["w"])

    def test_residuals_accumulate(self, weights):
        b = _run(weights, "batched")
        assert float(np.abs(b["res"][0]).sum()) > 0   # EF device row moved
        assert float(np.abs(b["res"][1]).sum()) == 0  # non-EF row untouched

    def test_fedbuff_strategy_equivalent(self, weights):
        b = _run(weights, "batched", strategy="fedbuff", rounds=4)
        s = _run(weights, "sequential", strategy="fedbuff", rounds=4)
        assert np.array_equal(b["w"], s["w"])
        assert b["records"] == s["records"]

    @pytest.mark.parametrize("compressor,ckw", [
        ("topk_threshold", None), ("randk", None), ("qsgd", {"levels": 16}),
        ("signsgd", None), ("terngrad", None), ("none", None)])
    def test_bitwise_equal_every_compressor(self, weights, compressor, ckw):
        """Every bucket kind: the threshold kernel path, the random
        compressors' per-row generators, and the dense codes; EF on two of
        the four devices."""
        cfg = [(0, 2, 0.05, True), (1, 2, 0.2, False), (2, 2, 0.05, True),
               (3, 3, 0.1, False)]
        b = _run(weights, "batched", rounds=4,
                 fleet=_fleet("torch", cfg, compressor, ckw))
        s = _run(weights, "sequential", rounds=4,
                 fleet=_fleet("torch", cfg, compressor, ckw))
        _assert_bitwise(b, s)
        assert b["bits"] > 0

    def test_bitwise_equal_multi_row_chunks(self, weights):
        """Mixed δ_i in one top-k band ride one chunk under the band's
        k-cap (3 rows -> chunks 2 + 1), beside a full-band pair."""
        cfg = [(0, 2, 0.05, True), (1, 2, 0.045, True), (2, 2, 0.05, True),
               (3, 3, 1.0, False), (4, 3, 1.0, False)]
        b = _run(weights, "batched", fleet=_fleet("torch", cfg))
        s = _run(weights, "sequential", fleet=_fleet("torch", cfg))
        _assert_bitwise(b, s)

    def test_one_fused_momentum_call_per_step_per_chunk(self, weights,
                                                        monkeypatch):
        """The local round of a chunk updates its [B·d] buffer with one
        `fused_momentum` call per step, whatever B is."""
        seen = []
        real = fm_mod.fused_momentum

        def spy(w, mu, g, **kw):
            seen.append(w.numel())
            return real(w, mu, g, **kw)
        monkeypatch.setattr("repro_torch.optim.optim.fused_momentum", spy)
        chunks = []
        real_dispatch = TS.AFLSimulator._dispatch_chunk

        def dispatch(self, bkey, items, flat):
            chunks.append((bkey[0], len(items)))
            return real_dispatch(self, bkey, items, flat)
        monkeypatch.setattr(TS.AFLSimulator, "_dispatch_chunk", dispatch)
        cfg = [(0, 2, 0.05, True), (1, 2, 0.045, True), (2, 2, 0.05, True),
               (3, 3, 1.0, False)]
        b = _run(weights, "batched", rounds=3, fleet=_fleet("torch", cfg))
        dim = b["w"].size
        assert len(seen) == sum(k for k, _ in chunks) > 0
        assert sorted(seen) == sorted(B * dim for k, B in chunks
                                      for _ in range(k))
        assert any(B > 1 for _, B in chunks)


    def test_one_row_chunks_take_the_plain_local_round(self, weights,
                                                       monkeypatch):
        """A chunk of one row runs the sequential engine's local round;
        only chunks of two or more rows take the vmapped one."""
        rows = []
        real = TS.batched_local_round

        def spy(loss_fn, opt, flat, spec, batches):
            rows.append(next(iter(batches[0].values())).shape[0])
            return real(loss_fn, opt, flat, spec, batches)
        monkeypatch.setattr(TS, "batched_local_round", spy)
        chunks = []
        real_dispatch = TS.AFLSimulator._dispatch_chunk

        def dispatch(self, bkey, items, flat):
            chunks.append(len(items))
            return real_dispatch(self, bkey, items, flat)
        monkeypatch.setattr(TS.AFLSimulator, "_dispatch_chunk", dispatch)
        cfg = [(0, 2, 0.05, True), (1, 2, 0.045, True), (2, 2, 0.05, True),
               (3, 3, 1.0, False)]
        b = _run(weights, "batched", rounds=3, fleet=_fleet("torch", cfg))
        assert 1 in chunks and any(n > 1 for n in chunks)
        assert sorted(rows) == sorted(n for n in chunks if n > 1)
        _assert_bitwise(b, _run(weights, "sequential", rounds=3,
                                fleet=_fleet("torch", cfg)))

    def test_batched_grad_runs_without_cudnn(self, weights):
        """`batched_grad` takes the vmapped gradients with cuDNN off and
        restores the flag; on mlp_micro they equal per-row autograd."""
        from repro_torch.core import compression as C
        from repro_torch.dist.steps import batched_grad
        task = _task("torch", weights)
        seen = []

        def loss(params, batch):
            seen.append(torch.backends.cudnn.enabled)
            return task.loss_fn(params, batch)
        w0 = task.init_fn(None)
        W = torch.stack([w0, w0 * 0.5, w0 * 2.0])
        host = task.dataset.batch(np.arange(3 * 16))
        batch = {k: torch.as_tensor(np.asarray(v).reshape(3, 16, *v.shape[1:]))
                 for k, v in host.items()}
        batch["image"] = batch["image"].to(torch.float32)
        before = torch.backends.cudnn.enabled
        g = batched_grad(loss, task.spec)(W, batch)
        assert seen == [False] and torch.backends.cudnn.enabled == before
        for r in range(3):
            w = W[r].clone().requires_grad_(True)
            (want,) = torch.autograd.grad(task.loss_fn(
                C.unflatten_pytree(w, task.spec),
                {k: v[r] for k, v in batch.items()}), w)
            assert torch.equal(g[r], want)


class TestGradAccuracy:
    def test_first_step_check_on_the_cpu(self):
        """`launch.grad_accuracy.first_step_check` at cnn_fmnist's full
        width, 2 rows x 2 steps: the engines' gradients agree to its
        tolerance where they decide alike, and the check passes."""
        from repro_torch.launch import grad_accuracy as ga
        rec = ga.first_step_check(torch.device("cpu"), rows=2, steps=2)
        assert rec["ok"] and rec["row_steps"] == 4
        assert rec["worst_gap_unflipped"] <= ga.TOL
        assert rec["round_gap_median"] < 1e-3

    def test_flips_finds_a_changed_decision(self):
        """A ReLU input of opposite sign and a pool window with another
        argmax are both reported, each with its float64 gap."""
        from repro_torch.launch.grad_accuracy import flips
        a = torch.tensor([[[[1.0, 2.0], [0.5, -1.0]]]])
        b = torch.tensor([[[[1.0, 1.5], [2.5, 1e-9]]]])
        a64 = torch.tensor([[[[1.0, 2.0], [2.0 - 1e-7, -1e-9]]]],
                           dtype=torch.float64)
        gaps = flips((a,), (b,), (a64,))
        assert len(gaps) == 2
        assert gaps[0] == pytest.approx(1e-9 / 2.0)      # the ReLU
        assert gaps[1] == pytest.approx(1e-7 / 2.0)      # the pool
        assert flips((a,), (a,), (a64,)) == []


class TestChunking:
    def test_chunk_sizes_match_reference(self):
        for n in range(1, 70):
            sizes = TS._chunk_sizes(n)
            assert sizes == JS._chunk_sizes(n)
            assert sum(sizes) == n
            assert all(s & (s - 1) == 0 for s in sizes)  # powers of two
        assert TS._CHUNK_CAP == JS._CHUNK_CAP
        assert [TS._next_pow2(n) for n in range(1, 40)] == \
            [JS._next_pow2(n) for n in range(1, 40)]

    def test_buckets_match_reference(self, weights):
        """Same bucket keys and k-caps as the reference on a mixed fleet
        (topk bands, the full band, a non-topk compressor)."""
        cfg = MIXED + [(4, 2, 0.07, True)]
        sims = []
        for pkg in ("jax", "torch"):
            fleet = _fleet(pkg, cfg)
            fleet[-1].compressor = "randk"
            extra = {"device": "cpu"} if pkg == "torch" else {}
            sims.append(PKG[pkg]["S"].AFLSimulator(
                _task(pkg, weights), fleet, engine="batched", **extra))
        js, ts = sims
        assert [js._bucket_key(js.devices[d]) for d in js._dids] == \
            [ts._bucket_key(ts.devices[d]) for d in ts._dids]
        assert js._bucket_kcap == ts._bucket_kcap
        for s in sims:
            s.close()

    def test_failure_schedule_keeps_batched_engine(self, weights):
        fs = TFT.FailureSchedule.random(4, 10.0, seed=0)
        sim = TS.AFLSimulator(_task("torch", weights), _fleet("torch"),
                              "periodic", failure_schedule=fs,
                              engine="batched", device="cpu")
        assert sim._batched
        sim.close()


class TestFaultEquivalence:
    """A failure-injected mixed-k/δ/EF fleet is *bitwise* identical across
    the port's engines — crashes, lossy links, retries, drift,
    sanitization, and mid-run re-plans all included."""

    def test_crash_injected_bitwise_equal(self, weights):
        b = _run(weights, "batched", rounds=8, **_faults("torch"))
        s = _run(weights, "sequential", rounds=8, **_faults("torch"))
        assert b["counters"]["crash_lost"] > 0   # faults actually fired
        _assert_bitwise(b, s)

    def test_chaos_bitwise_equal(self, weights):
        b = _run(weights, "batched", rounds=8,
                 **_faults("torch", channel=True))
        s = _run(weights, "sequential", rounds=8,
                 **_faults("torch", channel=True))
        assert b["counters"]["retries"] > 0
        assert b["counters"]["drops_total"] > 0
        _assert_bitwise(b, s)

    def test_drift_replan_bitwise_equal(self, weights):
        b = _run(weights, "batched", rounds=8,
                 **_faults("torch", controller=True))
        s = _run(weights, "sequential", rounds=8,
                 **_faults("torch", controller=True))
        assert b["counters"]["replans"] > 0
        _assert_bitwise(b, s)

    def test_prefetch_bitwise_equal_across_replan(self, weights):
        """prefetch > 0 draws the same batches as the synchronous path,
        across a mid-run re-plan (set_k re-stacks, nothing is flushed)."""
        base = _run(weights, "batched", rounds=8,
                    **_faults("torch", controller=True))
        pre = _run(weights, "batched", rounds=8, prefetch=2,
                   **_faults("torch", controller=True))
        assert base["counters"]["replans"] > 0
        _assert_bitwise(base, pre)

    def test_fedbuff_crash_bitwise_equal(self, weights):
        b = _run(weights, "batched", strategy="fedbuff", rounds=5,
                 **_faults("torch"))
        s = _run(weights, "sequential", strategy="fedbuff", rounds=5,
                 **_faults("torch"))
        assert np.array_equal(b["w"], s["w"])
        assert b["records"] == s["records"]


def _obs_run(weights, engine, pkg="torch", obs=True, **kw):
    return _run(weights, engine, pkg=pkg, rounds=8, obs=obs,
                **_faults(pkg, channel=True, controller=True), **kw)


class TestObsEquivalence:
    def test_identical_event_sequences(self, weights):
        b = _obs_run(weights, "batched")
        s = _obs_run(weights, "sequential")
        assert b["tracer"].events == s["tracer"].events
        names = {e.name for e in b["tracer"].events}
        assert {"local_round", "upload", "eval", "arrival", "aggregate",
                "crash_lost", "upload_retry", "replan"} <= names

    def test_identical_engine_agnostic_metrics(self, weights):
        b = _obs_run(weights, "batched")
        s = _obs_run(weights, "sequential")
        assert (b["metrics"].snapshot(engine_agnostic=True)
                == s["metrics"].snapshot(engine_agnostic=True))
        eng = b["metrics"].snapshot()
        assert eng["histograms"]["engine.drain_size"]["count"] > 0
        # the batched engine never builds a per-device compressor
        assert "engine.compressor_compiles" not in eng["counters"]

    def test_faults_metrics_match_history_counters(self, weights):
        for eng in ("batched", "sequential"):
            out = _obs_run(weights, eng)
            counters = out["metrics"].snapshot()["counters"]
            for k, v in out["counters"].items():
                assert counters[f"faults.{k}"] == float(v), (eng, k)

    def test_obs_attachment_leaves_run_bitwise_unchanged(self, weights):
        with_obs = _obs_run(weights, "batched", obs=True)
        without = _obs_run(weights, "batched", obs=False)
        _assert_bitwise(with_obs, without)

    def test_record_windows_attribute_faults_per_eval(self, weights):
        out = _obs_run(weights, "batched")
        for key, total in out["counters"].items():
            assert sum(w.get(key, 0) for w in out["windows"]) == total, key
        assert any("staleness_counts" in w for w in out["windows"])

    def test_staleness_windows_per_eval(self, weights):
        sim = TS.AFLSimulator(_task("torch", weights), _fleet("torch"),
                              "periodic", round_period=1.0, seed=0,
                              engine="batched", device="cpu")
        h = sim.run(total_rounds=6, eval_every=1)
        assert sim._stal_ptr == len(sim.agg.staleness_log)
        assert all(r.mean_staleness >= 0 for r in h.records)
        sim.close()


def _strip_time(snapshot: dict) -> dict:
    return {sec: {k: v for k, v in entries.items()
                  if not k.startswith("time.")}
            for sec, entries in snapshot.items()}


def _split_events(events):
    host, values = [], []
    for e in events:
        args = tuple(a for a in e.args if a[0] not in ("accuracy", "loss"))
        host.append((e.track, e.name, e.ph, e.ts, e.dur, args))
        if e.name == "eval":
            values.append((e.arg("accuracy"), e.arg("loss")))
    return host, values


def _close(jv, tv):
    assert len(jv) == len(tv)
    for (ja, jl), (ta, tl) in zip(jv, tv):
        assert abs(ja - ta) <= ACC_TOL
        assert abs(jl - tl) <= LOSS_RTOL * abs(jl)


class TestAgainstReference:
    """The port's batched engine against `repro`'s batched engine."""

    @pytest.mark.parametrize("compressor", ["topk", "topk_threshold"])
    def test_fault_injected_fleet_matches_reference(self, weights,
                                                    compressor):
        cfg = [(0, 2, 0.05, True), (1, 5, 1.0, False), (2, 2, 0.2, True),
               (3, 2, 0.1, True)]
        out = {pkg: _obs_run(weights, "batched", pkg=pkg,
                             fleet=_fleet(pkg, cfg, compressor))
               for pkg in ("jax", "torch")}
        j, t = out["jax"], out["torch"]
        assert j["counters"]["crash_lost"] > 0 and j["counters"]["retries"] > 0
        jev, jvals = _split_events(j["tracer"].events)
        tev, tvals = _split_events(t["tracer"].events)
        assert jev == tev and len(jev) > 50
        _close(jvals, tvals)
        jsnap = _strip_time(j["metrics"].snapshot())
        assert jsnap == _strip_time(t["metrics"].snapshot())
        assert jsnap["counters"]["engine.bucket_compiles"] > 0
        assert j["counters"] == t["counters"]
        assert j["bits"] == t["bits"]
        assert j["staleness"] == t["staleness"]
        assert j["events"] == t["events"]
        assert [r[:2] + r[4:] for r in j["records"]] == \
            [r[:2] + r[4:] for r in t["records"]]
        assert j["windows"] == t["windows"]
        _close([r[2:4] for r in j["records"]], [r[2:4] for r in t["records"]])
        np.testing.assert_allclose(t["w"], j["w"], atol=2e-3)

    def test_fedbuff_matches_reference(self, weights):
        out = {pkg: _run(weights, "batched", pkg=pkg, strategy="fedbuff",
                         rounds=4, obs=True)
               for pkg in ("jax", "torch")}
        j, t = out["jax"], out["torch"]
        assert _split_events(j["tracer"].events)[0] == \
            _split_events(t["tracer"].events)[0]
        assert _strip_time(j["metrics"].snapshot()) == \
            _strip_time(t["metrics"].snapshot())
        assert j["bits"] == t["bits"] and j["staleness"] == t["staleness"]
        _close([r[2:4] for r in j["records"]], [r[2:4] for r in t["records"]])

    def test_sequential_mixed_ef_metrics_match_reference(self, weights):
        """Same k and δ with EF on and off: the reference builds one
        compressor per EF mode, so `engine.compressor_compiles` reads 2."""
        cfg = [(0, 2, 0.1, True), (1, 2, 0.1, False)]
        out = {pkg: _run(weights, "sequential", pkg=pkg, rounds=4, obs=True,
                         fleet=_fleet(pkg, cfg))
               for pkg in ("jax", "torch")}
        j, t = out["jax"], out["torch"]
        jsnap = _strip_time(j["metrics"].snapshot())
        assert jsnap["counters"]["engine.compressor_compiles"] == 2.0
        assert jsnap == _strip_time(t["metrics"].snapshot())
        assert j["bits"] == t["bits"] and j["counters"] == t["counters"]
