"""Driver of the FL cells: FedLuck's asynchronous FL round on the port's
event simulator (`repro_torch.core.simulator.AFLSimulator`, batched
engine), built as `repro_torch.launch.train.run_fl` builds it for the
configuration's task (`"task"`, one of the port's
`repro_torch.models.small` tasks), on the benchmark's own data (the
configuration's data generator) and initial model. The comparison takes
the model's loss from the configuration's model reference.

Set-up builds the simulator and runs its first segment (`segment_rounds`
rounds of `sim.run`, as the CLI's `--ckpt-every` segments), which warms
every chunk shape the schedule uses: each segment restarts the simulated
clock with every device starting at t = 0, so all segments run the same
schedule. The first `check_aggregations` aggregations of that segment are
kept for the comparison with the reference. The window runs further
segments until `--seconds` have passed, and finishes the one it is in.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from portbench.harness import compare, faults, inputs
from portbench.harness.device import Trace
from portbench.harness.spec import reference
from portbench.reference import compress, fl_sim
from portbench.reference.precision import Precision


def make_inputs(cfg: dict, tr: dict, seed: int, device) -> dict:
    """The run's data and initial model, from the seed."""
    s = inputs.seeds(seed)
    data = cfg["data"]
    gen = inputs.generator(data)
    return {
        "seeds": s,
        "train": gen.make(data, data["train_samples"], s["task"],
                          s["train"]),
        "test": gen.make(data, data["test_samples"], s["task"], s["test"]),
        "w0": inputs.weights(reference(cfg).spec(cfg), s["weights"], device,
                             cfg["init"]).cpu().numpy(),
        # the fleet is the traffic's, the same on every seed; the seed
        # deals its profiles to the device ids in another order
        "order": np.random.RandomState(s["sim"]).permutation(
            tr["devices"]),
    }


class Cell:
    def __init__(self, cell: dict, seed: int, device, *, trace: bool = False):
        import torch
        self.torch = torch
        self.cell, self.seed = cell, seed
        self.cfg, self.tr = cell["config"], cell["traffic"]
        self.device = torch.device(device)
        self.trace = trace
        self.model = reference(self.cfg)
        self.data = make_inputs(self.cfg, self.tr, seed, self.device)
        self.spec = self.model.spec(self.cfg)
        self.faults = []            # callables(cell) planted by the checks
        self.restores = []          # what undoes them
        self.first_arrival_only = False

    # ------------------------------------------------------------ program
    def build(self):
        from repro_torch.core.simulator import (AFLSimulator,
                                                STRATEGY_FOR_METHOD,
                                                make_heterogeneous_devices,
                                                plan_devices)
        from repro_torch.data.partition import iid_partition
        from repro_torch.models import small
        from repro_torch.obs import MetricsRegistry
        from repro_torch.obs.profiling import PhaseTimers

        cfg, tr, s = self.cfg, self.tr, self.data["seeds"]
        task = small.make_task(cfg["task"], num_samples=8, test_samples=8,
                               batch_size=tr["batch_size"])
        if [(tuple(p), tuple(sh)) for p, sh in task.spec] != self.spec:
            raise RuntimeError(f"the program's {cfg['task']} layout "
                               f"{task.spec} is not the configuration's "
                               f"{self.spec}")
        self.task = dataclasses.replace(
            task, dataset=self.data["train"],
            test_batch=self.data["test"].batch(
                np.arange(len(self.data["test"]))))
        dim = len(self.data["w0"])
        fleet = make_heterogeneous_devices(
            tr["devices"], dim * 32, base_alpha=tr["base_alpha"],
            alpha_spread=tr["alpha_spread"],
            bw_range=tuple(tr["bandwidth_bps"]), seed=tr["fleet_seed"])
        profiles = [dataclasses.replace(fleet[j], device_id=i)
                    for i, j in enumerate(self.data["order"])]
        specs = plan_devices(
            profiles, tr["method"], tr["round_period"],
            k_bounds=tuple(tr["k_bounds"]),
            delta_bounds=tuple(tr["delta_bounds"]),
            compressor_override=tr["compressor"],
            error_feedback=tr["error_feedback"])
        self.plans = [(sp.plan.k, sp.plan.delta) for sp in specs]
        idx = iid_partition(len(self.task.dataset), tr["devices"],
                            seed=s["sim"])
        self.timers = PhaseTimers() if self.trace else None
        self.metrics = MetricsRegistry() if self.trace else None
        for fault in self.faults:
            fault(self)
        self.sim = AFLSimulator(
            self.task, specs, STRATEGY_FOR_METHOD[tr["method"]],
            round_period=tr["round_period"], eta_l=tr["eta_l"],
            eta_g=tr["eta_g"], momentum=tr["momentum"], seed=s["sim"],
            client_indices=idx, engine=tr["engine"], device=self.device,
            timers=self.timers, metrics=self.metrics)
        self.sim.model.w = self.data["w0"].copy()
        if self.first_arrival_only:
            mean = self.sim.model.apply_mean
            self.sim.model.apply_mean = lambda u, scale=None: mean(u[:1],
                                                                   scale)

    def _segment(self) -> int:
        """One `sim.run` segment; returns the evaluations it made."""
        hist = self.sim.run(
            total_rounds=self.sim.model.round + self.tr["segment_rounds"],
            eval_every=self.tr["eval_every"])
        return len(hist.records)

    def setup(self) -> None:
        """Build, then run the first segment with the program's first
        drain and first aggregations recorded (`Capture`)."""
        self.build()
        cap = Capture(self)
        cap.install()
        try:
            self._segment()
        finally:
            cap.remove()
        if len(cap.aggs) < self.tr["check_aggregations"]:
            raise RuntimeError(f"the first segment aggregated "
                               f"{len(cap.aggs)} times, "
                               f"{self.tr['check_aggregations']} are "
                               f"compared")
        self.program = cap

    def _counts(self) -> dict:
        if self.metrics is None:
            return {}
        h = self.metrics._histograms
        return {"dispatch_s": self.timers.totals.get("dispatch", 0.0),
                "chunks": h["engine.chunk_size"].count
                if "engine.chunk_size" in h else 0,
                "row_steps": h["sim.local_k"].total
                if "sim.local_k" in h else 0.0}

    def window(self, seconds: float) -> dict:
        sim, torch = self.sim, self.torch
        r0, c0, evals, ends = sim.model.round, self._counts(), 0, []
        t0 = time.perf_counter()
        while True:
            evals += self._segment()
            ends.append(time.perf_counter() - t0)
            if ends[-1] >= seconds:
                break
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c1 = self._counts()
        return {"wall_s": wall, "rounds": sim.model.round - r0,
                "evals": evals, "segment_ends_s": ends,
                **{k: c1[k] - c0[k] for k in c1}}

    def traced(self) -> tuple[Trace, int]:
        """One more segment under the profiler, with the program's own
        annotations on."""
        from repro_torch.obs import profiling
        r0 = self.sim.model.round
        profiling.set_profiling(True)
        try:
            with Trace(self.torch) as tr:
                self._segment()
        finally:
            profiling.set_profiling(False)
        return tr, self.sim.model.round - r0

    def release(self) -> None:
        self.sim.close()
        del self.sim, self.task
        for undo in self.restores:
            undo()

    # --------------------------------------------------------- comparison
    def check(self, mode: str = "fp32") -> dict:
        """The compared numbers: the program's recorded set-up against the
        reference, stage by stage from the program's own states (mode
        "fp32"), or the same with the reference's gradients in TF32 in the
        program's place (mode "tf32", the control)."""
        torch, dev, cap = self.torch, self.device, self.program
        tr, sp, d = self.tr, self.spec, len(self.data["w0"])
        model, cfg = self.model, self.cfg
        err = lambda a, b: compare.worst_leaf_error(
            compare.leaf_diff_norms(a, b, sp), compare.leaf_norms(b, sp))
        w0 = torch.as_tensor(self.data["w0"], device=dev)
        xs = torch.as_tensor(self.data["train"].x, device=dev)
        labels = torch.as_tensor(self.data["train"].labels, device=dev)
        loaders = fl_sim.loaders(tr, len(labels), self.data["seeds"]["sim"])
        thr = tr["compressor"] == "topk_threshold"
        out = {k: [0.0] for k in ("first_grad_gap", "step_grad_gap",
                                  "momentum_gap", "payload_gap",
                                  "residual_gap", "aggregate_gap")}
        mismatch = 0
        fp32, tf32 = Precision("fp32", dev), Precision("tf32", dev)
        for chunk in cap.chunks:
            B = len(chunk["dids"])
            for i, did in enumerate(chunk["dids"]):
                row = lambda t: t.view(B, d)[i].to(dev)
                comp = {k: v.to(dev) if hasattr(v, "to") else v
                        for k, v in chunk["comps"][i].items()}
                delta = comp["g"] if thr else comp["acc"]
                mu = torch.zeros_like(w0)
                for t, (w, g) in enumerate(chunk["steps"]):
                    wt, gp = row(w), row(g)
                    mismatch += t == 0 and not torch.equal(wt, w0)
                    idx = torch.as_tensor(loaders[did].next())
                    x, y = xs[idx], labels[idx]
                    with fp32:
                        g_ref = fl_sim.grad(model, cfg, wt, sp, x, y, fp32)
                    if mode == "tf32":
                        with tf32:
                            gp = fl_sim.grad(model, cfg, wt, sp, x, y, tf32)
                    key = "first_grad_gap" if t == 0 else "step_grad_gap"
                    out[key].append(err(gp, g_ref))
                    w_next, mu = fl_sim.momentum_step(
                        wt, mu, row(g), tr["eta_l"], tr["momentum"])
                    w_prog = row(chunk["steps"][t + 1][0]) \
                        if t + 1 < len(chunk["steps"]) else w0 - delta
                    out["momentum_gap"].append(err(wt - w_prog, wt - w_next))
                k = comp["k"]
                if thr:
                    kept, res = compress.threshold_ef(comp["g"], comp["res"],
                                                      k)
                else:
                    kept, res = compress.topk_ef(comp["acc"],
                                                 torch.zeros_like(w0), k)
                out["payload_gap"].append(err(comp["kept"], kept))
                out["residual_gap"].append(err(cap.res[did].to(dev), res))
        for _, _, before, payloads, after in cap.aggs:
            ref = fl_sim.eq6(before, payloads, tr["eta_g"])
            out["aggregate_gap"].append(err(after - before, ref - before))
        sched = fl_sim.schedule(tr, d, self.data["order"], len(cap.aggs))
        mismatch += sum((a[0], a[1]) != s for a, s in zip(cap.aggs, sched))
        return {"schedule_mismatch": float(mismatch),
                **{k: float(np.max(v)) for k, v in out.items()}}

    def calibrate(self, modes) -> dict:
        """{mode: the compared numbers} of this seed: "program" (the
        program as it is), "control" (the reference in TF32 in the
        program's place) or a fault of `harness/faults.py` planted in the
        program; each from a run of its own."""
        out = {}
        for mode in modes:
            c = Cell(self.cell, self.seed, self.device)
            c.faults = [faults.FAULTS[mode]] if mode in faults.FAULTS else []
            c.setup()
            c.release()
            out[mode] = c.check("tf32" if mode == "control" else "fp32")
            del c
        return out

    def end_to_end(self, win: dict) -> dict:
        return {"fl_round_s": win["wall_s"] / win["rounds"]}

    def context(self, win: dict) -> dict:
        """What the per-layer metric readers read (beside the trace)."""
        return {"kind": "fl", "config": self.cfg, "traffic": self.tr,
                "window": win}


class Capture:
    """What the program computes in set-up, recorded on the host for the
    comparison, by wrappers installed for the first segment only:

      chunks  per chunk of the first drain (every device starts at t = 0
              from the initial model): its devices in row order, each
              local step's parameters before the update and the gradient
              the optimizer got (`fused_momentum`'s arguments), and each
              row's compression (its input, k and kept payload)
      res     each drained device's EF residual after that drain
      aggs    the first aggregations that change the model: (round,
              [(device, model round)], w before, payloads, w after)
    """

    def __init__(self, cell):
        self.cell, self.sim = cell, cell.sim
        self.want = cell.tr["check_aggregations"]
        self.chunks, self.aggs, self.res = [], [], {}
        self.live = True

    def install(self) -> None:
        from repro_torch.core import compression as C
        from repro_torch.optim import optim as O
        sim, agg, cpu = self.sim, self.sim.agg, lambda t: t.detach().cpu()
        self._saved = [(O, "fused_momentum", O.fused_momentum),
                       (C, "topk_capped", C.topk_capped),
                       (C, "topk_threshold_ef", C.topk_threshold_ef)]
        fused, capped, thresh = (f for _, _, f in self._saved)

        def fused_rec(w, mu, g, *, lr, momentum=0.9):
            if self.live and self.chunks:
                self.chunks[-1]["steps"].append((cpu(w).clone(), cpu(g)))
            return fused(w, mu, g, lr=lr, momentum=momentum)

        def capped_rec(g, k, *, k_cap):
            cc = capped(g, k, k_cap=k_cap)
            if self.live and self.chunks:
                self.chunks[-1]["comps"].append(
                    {"acc": cpu(g), "k": k, "kept": cpu(cc.dense())})
            return cc

        def thresh_rec(g, residual, rate, **kw):
            cc, new = thresh(g, residual, rate, **kw)
            if self.live and self.chunks:
                self.chunks[-1]["comps"].append(
                    {"g": cpu(g), "res": cpu(residual), "kept": cpu(cc.values),
                     "k": C.num_keep(g.numel(), rate)})
            return cc, new

        O.fused_momentum = fused_rec
        C.topk_capped, C.topk_threshold_ef = capped_rec, thresh_rec
        dispatch, process = sim._dispatch_chunk, sim._process_starts_batched
        boundary = agg.on_round_boundary

        def dispatch_rec(bkey, items, flat):
            if self.live:
                self.chunks.append({"dids": [it[1] for it in items],
                                    "steps": [], "comps": []})
            return dispatch(bkey, items, flat)

        def process_rec(starts, push):
            out = process(starts, push)
            if self.live:
                self.live = False
                self.res = {did: cpu(sim._res_stack[sim._rowof[did]]).clone()
                            for c in self.chunks for did in c["dids"]}
            return out

        def boundary_rec(t_now):
            members = sorted((a.device_id, a.model_round) for a in agg.buffer)
            payloads = [a.update.dense() if hasattr(a.update, "dense")
                        else np.asarray(a.update) for a in agg.buffer]
            before = agg.model.w.copy()
            events = boundary(t_now)
            if members and len(self.aggs) < self.want:
                self.aggs.append((agg.model.round, members, before, payloads,
                                  agg.model.w.copy()))
            return events

        sim._dispatch_chunk, sim._process_starts_batched = dispatch_rec, \
            process_rec
        agg.on_round_boundary = boundary_rec

    def remove(self) -> None:
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)
        del self.sim._dispatch_chunk, self.sim._process_starts_batched
        del self.sim.agg.on_round_boundary
