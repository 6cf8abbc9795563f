"""Training CLI (PyTorch port of `repro.launch.train`).

Two modes, with real PyTorch compute on `--device` (default `cuda`; `cpu`
for a run on a machine without a card):

1. `--mode fl` (default — the paper's setting): asynchronous federated
   training of one of the paper's tasks under any of the 5 methods, on
   the event-driven simulator (its batched engine, as the reference CLI
   runs it), with checkpoint/restart: `--ckpt-dir` saves the global
   model, its round and the per-device EF residuals after every
   `--ckpt-every` segment, in the reference's checkpoint layout, and
   `--resume` continues from the latest one (a checkpoint of either
   package).

2. `--mode datacenter`: DiLoCo-style multi-"pod" local SGD on an assigned
   architecture's smoke config: each pod runs k local momentum-SGD steps
   (one `fused_momentum` launch per step on the flat parameter buffer),
   compresses its pseudo-gradient with EF top-k at the controller-chosen
   δ, and the pods' payloads are averaged (Eq. 6). Every pod runs on the
   one device.

Same flags and the same result-JSON keys as the reference.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --task cnn_fmnist \
      --method fedluck --error-feedback --rounds 60 --ckpt-dir /tmp/ck \
      --resume
  PYTHONPATH=src python -m repro_torch.launch.train --task mlp_micro \
      --rounds 4 --devices 3 --samples 600 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --mode datacenter \
      --arch mamba2-780m --steps 4 --pods 2 --local-k 2 --rate 0.05 \
      --device cpu
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time

import numpy as np

from repro_torch.obs import log


def make_obs(args):
    """(tracer, metrics) from --trace-out/--metrics-out, else (None, None)."""
    tracer = metrics = None
    if getattr(args, "trace_out", ""):
        from repro_torch.obs import Tracer
        tracer = Tracer()
    if getattr(args, "metrics_out", ""):
        from repro_torch.obs import MetricsRegistry
        metrics = MetricsRegistry()
    return tracer, metrics


def export_obs(args, tracer, metrics, extra=None) -> None:
    """Write the trace/metrics artifacts named by the CLI flags."""
    if tracer is not None:
        from repro_torch.obs import PerfettoExporter
        PerfettoExporter().export(tracer, args.trace_out)
        log.status(f"[obs] wrote trace: {args.trace_out} "
                   f"({len(tracer)} events)")
    if metrics is not None:
        metrics.to_json(args.metrics_out, extra=extra)
        log.status(f"[obs] wrote metrics: {args.metrics_out}")


# --------------------------------------------------------------------- FL mode
def fl_ckpt_state(sim) -> dict:
    """FL checkpoint payload: global model + round + per-device EF
    residuals (without the residuals, a resumed error-feedback run
    re-drops every deferred coordinate and diverges from the
    uninterrupted run). Residuals come via `residual_snapshot`, which
    works for both engines."""
    state = {"w": np.asarray(sim.model.w),
             "round": np.asarray(sim.model.round)}
    ids, stacked = sim.residual_snapshot()
    if len(ids):
        state["residual_ids"] = ids
        state["residuals"] = stacked
    return state


def restore_fl_state(sim, state) -> None:
    sim.model.w = np.asarray(state["w"])
    sim.model.round = int(state["round"])
    if "residuals" in state:
        sim.load_residuals(np.asarray(state["residual_ids"]),
                           np.asarray(state["residuals"]))


def run_fl(args, *, engine: str = "batched") -> dict:
    """The FL simulator run the CLI's flags describe, on `engine` (the
    reference CLI's default, `batched`, or `sequential`)."""
    import torch

    from repro_torch import resolve_device
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core.aggregation import SanitizerConfig
    from repro_torch.core.simulator import (AFLSimulator, STRATEGY_FOR_METHOD,
                                            make_heterogeneous_devices,
                                            plan_devices)
    from repro_torch.data.partition import dirichlet_partition, iid_partition
    from repro_torch.ft import FailureSchedule, LossyChannel
    from repro_torch.models import small

    device = resolve_device(args.device)
    task = small.make_task(args.task, num_samples=args.samples,
                           test_samples=args.test_samples,
                           batch_size=args.batch_size, noise=args.noise)
    flat = task.init_fn(torch.Generator().manual_seed(args.seed))
    model_bits = int(flat.numel()) * 32

    profiles = make_heterogeneous_devices(
        args.devices, model_bits, base_alpha=args.base_alpha, seed=args.seed)
    specs = plan_devices(profiles, args.method, args.round_period,
                         k_bounds=(1, args.k_max), fixed_k=args.fixed_k,
                         fixed_delta=args.fixed_delta,
                         error_feedback=args.error_feedback)
    if args.noniid:
        idx = dirichlet_partition(task.dataset.labels, args.devices,
                                  alpha=1.0, seed=args.seed)
    else:
        idx = iid_partition(len(task.dataset), args.devices, seed=args.seed)

    # --failure-rate N sets the per-device crash rate; the legacy
    # --inject-failures switch keeps its historical default of 0.2
    failure = None
    if args.failure_rate > 0 or args.inject_failures:
        failure = FailureSchedule.random(
            args.devices, args.rounds * args.round_period,
            rate_per_device=args.failure_rate or 0.2, seed=args.seed)
    channel = (LossyChannel(loss_prob=args.loss_rate, seed=args.seed)
               if args.loss_rate > 0 else None)
    sanitizer = None
    if args.tau_max is not None or args.clip_norm is not None:
        sanitizer = SanitizerConfig(tau_max=args.tau_max,
                                    clip_norm=args.clip_norm)

    tracer, metrics = make_obs(args)
    sim = AFLSimulator(task, specs, STRATEGY_FOR_METHOD[args.method],
                       round_period=args.round_period, eta_l=args.eta_l,
                       eta_g=args.eta_g, seed=args.seed, client_indices=idx,
                       failure_schedule=failure, channel=channel,
                       sanitizer=sanitizer, tracer=tracer, metrics=metrics,
                       engine=engine,
                       device=device)

    mgr = CheckpointManager(args.ckpt_dir, max_to_keep=2) \
        if args.ckpt_dir else None
    if mgr and args.resume:
        latest = mgr.latest_step()
        if latest is not None:
            restore_fl_state(sim, mgr.restore(latest))
            log.status(f"[train] resumed from round {sim.model.round}")

    # run in checkpointed segments so a crash loses at most one segment;
    # each segment restarts the simulated clock, as in the reference
    seg = max(1, args.ckpt_every)
    hist_all = []
    t0 = time.perf_counter()
    while sim.model.round < args.rounds:
        target = min(args.rounds, sim.model.round + seg)
        hist = sim.run(total_rounds=target, eval_every=args.eval_every)
        hist_all.extend(hist.records)
        if mgr:
            mgr.save(sim.model.round, fl_ckpt_state(sim))
            mgr.wait()
        r = hist.records[-1]
        log.status(f"[train] round={sim.model.round} acc={r.accuracy:.3f} "
                   f"sim_t={r.time:.1f}s comm={r.gbits:.3f}Gb "
                   f"wall={time.perf_counter()-t0:.0f}s")
    if not hist_all:
        # resumed at/past the target round: nothing to train, just eval
        hist_all.extend(
            sim.run(total_rounds=sim.model.round, eval_every=1).records)
    sim.close()
    final = hist_all[-1]
    export_obs(args, tracer, metrics,
               extra={"engine": sim.engine, "task": args.task,
                      "method": args.method, "device": str(device)})
    return {"final_accuracy": final.accuracy, "rounds": sim.model.round,
            "gbits": final.gbits, "sim_time": final.time,
            "fault_counters": sim.fault_counters()}


# ------------------------------------------------------------- datacenter mode
def run_datacenter(args, cfg=None, timers=None) -> dict:
    """The datacenter run the CLI's flags describe, on `cfg` (default: the
    smoke config of `--arch`, as the reference runs it). With `timers`
    (an `obs.PhaseTimers`), each round's local rounds, compression and
    aggregation are timed into phases "local", "compress" and
    "aggregate", each ended by a device synchronisation."""
    import torch

    from repro_torch import resolve_device
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.core import compression as C
    from repro_torch.core.controller import DeviceProfile, FedLuckController
    from repro_torch.data.synthetic import SyntheticTokens
    from repro_torch.dist.steps import make_local_round_step
    from repro_torch.models.transformer import LM
    from repro_torch.optim import momentum_sgd

    device = resolve_device(args.device)
    cfg = cfg or get_config(args.arch).smoke()
    if cfg.frontend != "tokens":
        raise SystemExit("datacenter demo supports token LMs")
    lm = LM(cfg, dtype=torch.float32, remat=False)
    opt = momentum_sgd(args.eta_l, momentum=0.9)
    n_pods = args.pods

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def phase(name):
        if timers is None:
            return contextlib.nullcontext()
        return _synced_phase(timers, name, sync)

    # ---- controller picks (k, δ) per pod from measured α and link β
    ctl = FedLuckController(round_period=args.round_period,
                            k_bounds=(1, args.local_k_max),
                            delta_bounds=(1e-3, 1.0))
    # every pod starts from the same parameters; local rounds never write
    # them (`local_round` works on a copy)
    params = lm.init(torch.Generator(device=device).manual_seed(args.seed),
                     device)
    flat_w, spec = C.flatten_pytree(params)
    params = C.unflatten_pytree(flat_w, spec)
    dim = int(flat_w.numel())
    opt_states = [opt.init(params) for _ in range(n_pods)]
    residuals = [torch.zeros(dim, device=device) for _ in range(n_pods)]
    ds = SyntheticTokens(vocab=cfg.vocab, seq_len=65, num_samples=2048)

    def batches_for(k, rng):
        idx = rng.randint(0, len(ds), size=(k, args.batch_size))
        bs = [ds.batch(i) for i in idx]
        return {kk: torch.from_numpy(np.stack([b[kk] for b in bs]))
                .long().to(device) for kk in bs[0]}

    # measure α on pod 0's parameters with a fresh optimizer state (the
    # update is in place, so the pods' own states stay untouched), derive
    # β from a nominal 100 Gb/s DCN link
    rng = np.random.RandomState(args.seed)
    probe = make_local_round_step(lm, opt, 2)
    probe(params, opt.init(params), batches_for(2, rng))
    batches = batches_for(2, rng)
    sync()
    t1 = time.perf_counter()
    probe(params, opt.init(params), batches)
    sync()
    alpha = (time.perf_counter() - t1) / 2
    beta = dim * 32 / args.dcn_bps
    plans = [ctl.register(DeviceProfile(i, alpha * (1 + 0.5 * i), beta))
             for i in range(n_pods)]
    log.status("[datacenter] plans:")
    log.status(ctl.summary())

    mgr = CheckpointManager(args.ckpt_dir, max_to_keep=2) \
        if args.ckpt_dir else None

    local_round = {}
    comm_bits = 0.0
    t0 = time.perf_counter()
    for step in range(args.steps):
        agg, losses = None, []
        for i in range(n_pods):
            k = plans[i].k if not args.local_k else args.local_k
            if k not in local_round:
                local_round[k] = make_local_round_step(lm, opt, k)
            with phase("local"):
                # the pod's own w_k is not kept: the round's delta is
                opt_states[i], delta, loss = local_round[k](
                    params, opt_states[i], batches_for(k, rng))[1:]
                losses.append(float(loss))
            with phase("compress"):
                flat_d, _ = C.flatten_pytree(delta)
                rate = plans[i].delta if not args.rate else args.rate
                comp, residuals[i] = C.ef_compress(
                    C.make_compressor("topk", rate), flat_d, residuals[i])
                # payload-shape accounting: value/index bits + kept-count
                # header, matching the compact pod-sync wire format
                comm_bits += float(C.payload_bits(comp))
                dense = comp.dense()
                # running sum in pod order: numpy's mean over axis 0
                agg = dense if agg is None else agg.add_(dense)
        # Eq. 6 aggregation (the sparse all-reduce in the real deployment)
        with phase("aggregate"):
            flat_w = flat_w - args.eta_g * (agg / n_pods)
            params = C.unflatten_pytree(flat_w, spec)
        if mgr and (step + 1) % args.ckpt_every == 0:
            mgr.save(step + 1, {"w": flat_w})
            mgr.wait()
        if step % 5 == 0 or step == args.steps - 1:
            log.status(f"[datacenter] round={step} "
                       f"loss={np.mean(losses):.4f} "
                       f"comm={comm_bits/8e6:.1f}MB "
                       f"wall={time.perf_counter()-t0:.0f}s")
    return {"loss": float(np.mean(losses)), "comm_mb": comm_bits / 8e6}


@contextlib.contextmanager
def _synced_phase(timers, name, sync):
    with timers.phase(name):
        yield
        sync()


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="fl", choices=["fl", "datacenter"])
    ap.add_argument("--device", default="cuda",
                    help="torch device for training (cuda | cpu); cuda "
                         "without a card raises")
    # fl
    ap.add_argument("--task", default="cnn_fmnist")
    ap.add_argument("--method", default="fedluck")
    ap.add_argument("--rounds", type=int, default=40)
    ap.add_argument("--devices", type=int, default=10)
    ap.add_argument("--round-period", type=float, default=1.0)
    ap.add_argument("--k-max", type=int, default=30)
    ap.add_argument("--fixed-k", type=int, default=10)
    ap.add_argument("--fixed-delta", type=float, default=0.1)
    ap.add_argument("--eta-l", type=float, default=0.05)
    ap.add_argument("--eta-g", type=float, default=1.0)
    ap.add_argument("--base-alpha", type=float, default=0.02)
    ap.add_argument("--samples", type=int, default=4000)
    ap.add_argument("--test-samples", type=int, default=800)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--noise", type=float, default=None)
    ap.add_argument("--error-feedback", action="store_true")
    ap.add_argument("--noniid", action="store_true")
    ap.add_argument("--inject-failures", action="store_true")
    ap.add_argument("--failure-rate", type=float, default=0.0,
                    help="mean crash windows per device over the run "
                         "(FailureSchedule.random rate_per_device)")
    ap.add_argument("--loss-rate", type=float, default=0.0,
                    help="per-attempt upload loss probability (LossyChannel "
                         "with default retry/backoff policy)")
    ap.add_argument("--tau-max", type=int, default=None,
                    help="staleness cap: aggregation drops updates with "
                         "τ > tau-max (enables the UpdateSanitizer)")
    ap.add_argument("--clip-norm", type=float, default=None,
                    help="L2 norm outlier guard on admitted updates "
                         "(enables the UpdateSanitizer)")
    ap.add_argument("--eval-every", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="",
                    help="save a checkpoint after every segment here")
    ap.add_argument("--ckpt-every", type=int, default=10,
                    help="rounds per sim.run segment")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the latest checkpoint in --ckpt-dir")
    # datacenter
    ap.add_argument("--arch", default="mamba2-780m")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--pods", type=int, default=2)
    ap.add_argument("--local-k", type=int, default=0)
    ap.add_argument("--local-k-max", type=int, default=10)
    ap.add_argument("--rate", type=float, default=0.0)
    ap.add_argument("--dcn-bps", type=float, default=100e9)
    # observability (fl mode)
    ap.add_argument("--trace-out", default="",
                    help="write a Perfetto/Chrome trace JSON of the run")
    ap.add_argument("--metrics-out", default="",
                    help="write a metrics snapshot JSON "
                         "(repro_torch.obs.MetricsRegistry)")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress status lines (final JSON still printed)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    log.set_quiet(args.quiet)
    res = run_fl(args) if args.mode == "fl" else run_datacenter(args)
    print(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
