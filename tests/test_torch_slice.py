"""The whole slice: the port's sequential simulator and its `run_fl`
against `repro` on a fault-injected mlp_micro fleet (4 devices, 4 rounds,
error feedback on, crash windows plus a lossy channel), from the same
JAX-initialised weights, with the `topk` and `topk_threshold` compressors.

Host-side results are identical: Tracer event lists, History.counters,
per-record wire bits and staleness, engine-agnostic metrics. Accuracy and
loss come from fp32 training in two frameworks whose sums run in another
order; a near-tie in a top-k pick can then flip one coordinate of a
payload, so they agree within |Δacc| <= 0.02 (a few of the 200 test
samples) and loss rtol 1e-3.
"""
import json

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import simulator as JS  # noqa: E402
from repro.core.aggregation import SanitizerConfig as JSan  # noqa: E402
from repro.core.controller import DeviceProfile as JProfile  # noqa: E402
from repro.core.factor import Plan as JPlan  # noqa: E402
from repro import ft as JFT  # noqa: E402
from repro import obs as JObs  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import small as jsmall  # noqa: E402

from repro_torch.core import simulator as TS  # noqa: E402
from repro_torch.core.aggregation import SanitizerConfig as TSan  # noqa: E402
from repro_torch.core.controller import DeviceProfile as TProfile  # noqa: E402
from repro_torch.core.factor import Plan as TPlan  # noqa: E402
from repro_torch import ft as TFT  # noqa: E402
from repro_torch import obs as TObs  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import small as tsmall  # noqa: E402

ACC_TOL, LOSS_RTOL = 0.02, 1e-3
# (did, k, delta) — mixed k and δ, EF on every device
FLEET = [(0, 2, 0.05), (1, 4, 0.2), (2, 3, 0.1), (3, 2, 0.5)]
TASK_KW = dict(num_samples=600, test_samples=200, batch_size=16)


@pytest.fixture(scope="module")
def weights():
    t = jsmall.make_task("mlp_micro", **TASK_KW)
    return jax.tree.map(np.asarray, t.init_fn(jax.random.PRNGKey(3)))


def _run(pkg, weights, compressor):
    if pkg == "jax":
        S, Profile, Plan, FT, Obs, San = JS, JProfile, JPlan, JFT, JObs, JSan
        task = jsmall.make_task("mlp_micro", **TASK_KW)
        task.init_fn = lambda key: weights
        kw = {}
    else:
        S, Profile, Plan, FT, Obs, San = TS, TProfile, TPlan, TFT, TObs, TSan
        task = tsmall.make_task("mlp_micro", **TASK_KW)
        task.init_fn = lambda gen: tsmall.params_from_jax(weights)
        kw = {"device": "cpu"}
    specs = []
    for did, k, delta in FLEET:
        p = Profile(did, 0.01 * (1 + did), 2.0)
        specs.append(S.DeviceSpec(p, Plan(k, delta, 0.0,
                                          k * p.alpha + delta * p.beta, 1),
                                  compressor, True))
    tracer, metrics = Obs.Tracer(), Obs.MetricsRegistry()
    sim = S.AFLSimulator(
        task, specs, "periodic", round_period=1.0, seed=3,
        engine="sequential",
        failure_schedule=FT.FailureSchedule.random(
            4, 12.0, rate_per_device=1.0, mean_downtime=0.6, seed=4),
        channel=FT.LossyChannel(loss_prob=0.3, seed=7),
        sanitizer=San(tau_max=8), tracer=tracer, metrics=metrics, **kw)
    hist = sim.run(total_rounds=4, eval_every=1)
    return hist, tracer, metrics, sim


def _split_events(events):
    """Events with the eval instants' accuracy/loss args taken out (they
    are compared within tolerance), plus those values."""
    host, values = [], []
    for e in events:
        args = tuple(a for a in e.args if a[0] not in ("accuracy", "loss"))
        host.append((e.track, e.name, e.ph, e.ts, e.dur, args))
        if e.name == "eval":
            values.append((e.arg("accuracy"), e.arg("loss")))
    return host, values


def _close(jv, tv):
    for (ja, jl), (ta, tl) in zip(jv, tv):
        assert abs(ja - ta) <= ACC_TOL
        assert abs(jl - tl) <= LOSS_RTOL * abs(jl)


@pytest.mark.parametrize("compressor", ["topk", "topk_threshold"])
def test_simulator_matches_reference(weights, compressor):
    jh, jtr, jm, jsim = _run("jax", weights, compressor)
    th, ttr, tm, tsim = _run("torch", weights, compressor)
    # the fault machinery fired
    assert jh.counters["crash_lost"] > 0 and jh.counters["retries"] > 0
    jev, jvals = _split_events(jtr.events)
    tev, tvals = _split_events(ttr.events)
    assert jev == tev and len(jev) > 50
    _close(jvals, tvals)
    assert jh.counters == th.counters
    assert [(r.time, r.round, r.gbits, r.mean_staleness, r.drops, r.window)
            for r in jh.records] == \
        [(r.time, r.round, r.gbits, r.mean_staleness, r.drops, r.window)
         for r in th.records]
    _close([(r.accuracy, r.loss) for r in jh.records],
           [(r.accuracy, r.loss) for r in th.records])
    assert jm.snapshot(engine_agnostic=True) == \
        tm.snapshot(engine_agnostic=True)
    assert jsim.agg.staleness_log == tsim.agg.staleness_log
    assert jsim.events_processed == tsim.events_processed
    # the weights and EF residuals stay close after 4 rounds
    np.testing.assert_allclose(tsim.model.w, jsim.model.w, atol=2e-3)
    jres, tres = jsim.residual_snapshot()[1], tsim.residual_snapshot()[1]
    assert jres.shape == tres.shape and np.abs(tres).sum() > 0


def test_run_fl_matches_reference(weights, monkeypatch, tmp_path):
    """`run_fl` of both packages on the same flags (both run their default
    batched engine), with the port's task initialised from JAX
    weights."""
    real = tsmall.make_task

    def make_task(*a, **kw):
        task = real(*a, **kw)
        jt = jsmall.make_task(*a, **kw)
        w = jax.tree.map(np.asarray, jt.init_fn(jax.random.PRNGKey(0)))
        task.init_fn = lambda gen: tsmall.params_from_jax(w)
        return task
    monkeypatch.setattr(tsmall, "make_task", make_task)

    flags = ["--task", "mlp_micro", "--rounds", "4", "--devices", "4",
             "--samples", "600", "--test-samples", "200", "--k-max", "6",
             "--error-feedback", "--failure-rate", "1.0", "--loss-rate",
             "0.2", "--eval-every", "1", "--quiet"]
    out = {}
    for name, mod in (("jax", jtrain), ("torch", ttrain)):
        trace = str(tmp_path / f"{name}.json")
        argv = flags + ["--trace-out", trace]
        if name == "torch":
            argv += ["--device", "cpu"]
            args = ttrain.build_parser().parse_args(argv)
        else:
            args = _jax_args(argv, monkeypatch)
        res = mod.run_fl(args)
        with open(trace) as f:
            out[name] = (res, json.load(f)["traceEvents"])
    (jres, jtrace), (tres, ttrace) = out["jax"], out["torch"]
    assert set(jres) == set(tres)
    assert jres["fault_counters"]["retries"] > 0
    for key in ("rounds", "gbits", "sim_time", "fault_counters"):
        assert jres[key] == tres[key], key
    assert abs(jres["final_accuracy"] - tres["final_accuracy"]) <= ACC_TOL

    def strip(evs):
        return [{k: (v if k != "args" else {a: b for a, b in v.items()
                                            if a not in ("accuracy", "loss")})
                 for k, v in e.items()} for e in evs]
    assert strip(jtrace) == strip(ttrace)


def _jax_args(argv, monkeypatch):
    """The reference CLI's parsed flags (its parser lives inside main)."""
    captured = {}
    with monkeypatch.context() as m:
        m.setattr(jtrain, "run_fl", lambda args: captured.setdefault(
            "args", args) and {})
        jtrain.main(argv)
    return captured["args"]
