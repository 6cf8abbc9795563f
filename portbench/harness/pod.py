"""Driver of the pod cells: FedLuck's datacenter round
(`repro_torch.dist.steps.make_pod_round_step` over
`repro_torch.dist.collectives.make_pod_sync`, every pod on the one card)
on an LM of the port (`repro_torch.models.transformer.LM`, float32
compute, no rematerialisation, as `--mode datacenter` builds it), from
the benchmark's own initial model and token stream (the configuration's
data generator). The configuration names the port's architecture
(`"arch"`), which of its `ArchConfig` fields its sizes set
(`"arch_fields"`) and its model reference, which the comparison runs.

Set-up builds the round and runs its first `check_rounds` rounds, which
warm every shape the round uses and are kept for the comparison with the
reference; the window runs further rounds until `--seconds` have passed
and finishes the one it is in. Round r uses rows r·P·k·B onward of the
token pool (cycling), so the compared rounds all see different rows.
"""
from __future__ import annotations

import dataclasses
import gc
import time

import numpy as np

from portbench.harness import compare, faults, inputs
from portbench.harness.device import Trace
from portbench.harness.spec import reference
from portbench.reference import pod_round
from portbench.reference.precision import Precision


def port_arch(cfg: dict):
    """The port's `ArchConfig` of `cfg["arch"]` with the fields that
    `cfg["arch_fields"]` maps to the configuration's sizes."""
    from repro_torch.configs import get_config

    def size(key):
        v = cfg
        for k in key.split("."):
            v = v[k]
        return v
    return dataclasses.replace(get_config(cfg["arch"]), **{
        f: size(k) for f, k in cfg["arch_fields"].items()})


class SplitSync:
    """A pod sync that times itself: it synchronises the card on entry and
    on exit and keeps each call's (entry, exit) host times, so a round's
    local rounds end at entry and its sync takes exit − entry. (A copy of
    `repro_torch.launch.profile_pod.SplitSync`.)"""

    def __init__(self, sync, torch, device):
        self.sync, self.torch, self.device = sync, torch, device
        self.payload_bits_per_pod = sync.payload_bits_per_pod
        self.spans: list[tuple[float, float]] = []

    def _wait(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def __call__(self, params, deltas, residuals):
        self._wait()
        t0 = time.perf_counter()
        out = self.sync(params, deltas, residuals)
        self._wait()
        self.spans.append((t0, time.perf_counter()))
        return out


class Cell:
    def __init__(self, cell: dict, seed: int, device, *, trace: bool = False):
        import torch
        self.torch = torch
        self.cell, self.seed = cell, seed
        self.cfg, self.tr = cell["config"], cell["traffic"]
        self.device = torch.device(device)
        self.trace = trace
        self.seeds = inputs.seeds(seed)
        self.model = reference(self.cfg)
        self.spec = self.model.spec(self.cfg)
        self.dim = sum(int(np.prod(s)) for _, s in self.spec)
        tr = self.tr
        nb = -(-self.dim // tr["blk"])
        self.n_blocks = nb + (-nb % tr["shards"])
        self.padded = self.n_blocks * tr["blk"]
        self.rows_per_round = tr["pods"] * tr["local_k"] * tr["batch"]
        data = self.cfg["data"]
        self.pool = torch.as_tensor(inputs.generator(data).make(
            data, self.cfg["vocab_size"], tr["token_rows"],
            tr["seq_len"] + 1, self.seeds["tokens"]), device=self.device)
        self.faults = []            # callables(cell) planted by the checks
        self.restores = []          # what undoes them
        self.next_round = 0

    def w0(self):
        return inputs.weights(self.spec, self.seeds["weights"], self.device,
                              self.cfg["init"])

    def rows(self, r: int, p: int, i: int):
        """(tokens, labels) [B, S] of round r, pod p, local step i."""
        tr = self.tr
        first = r * self.rows_per_round + (p * tr["local_k"] + i) * tr["batch"]
        idx = (first + np.arange(tr["batch"])) % tr["token_rows"]
        seq = self.pool[idx]
        return seq[:, :-1], seq[:, 1:]

    def batches(self, r: int) -> dict:
        tr = self.tr
        seq = [[self.rows(r, p, i) for i in range(tr["local_k"])]
               for p in range(tr["pods"])]
        stack = lambda j: self.torch.stack([self.torch.stack(
            [s[j] for s in pod]) for pod in seq])
        return {"tokens": stack(0), "labels": stack(1)}

    # ------------------------------------------------------------ program
    def build(self):
        torch = self.torch
        from repro_torch.dist import collectives as col, steps
        from repro_torch.models.transformer import LM
        from repro_torch.optim import momentum_sgd

        cfg, tr = self.cfg, self.tr
        self.lm = LM(port_arch(cfg), dtype=torch.float32, remat=False)
        prog = [(tuple(p), tuple(s)) for p, s in self.lm.param_spec()]
        if prog != self.spec:
            raise RuntimeError(f"the program's {cfg['arch']} layout is not "
                               f"the configuration's: {prog} != {self.spec}")
        params = torch.zeros(self.padded, device=self.device)
        params[:self.dim] = self.w0()
        self.params = params.view(self.n_blocks, tr["blk"])
        opt = momentum_sgd(tr["lr"], momentum=tr["momentum"])
        flat = self.params.reshape(-1)[:self.dim]
        self.states = [opt.init(flat) for _ in range(tr["pods"])]
        self.residuals = torch.zeros((tr["pods"], self.n_blocks, tr["blk"]),
                                     device=self.device)
        sync = col.make_pod_sync(
            {"pod": tr["pods"], "data": tr["shards"], "model": 1},
            self.padded, rate=tr["rate"], eta_g=tr["eta_g"],
            n_blocks=self.n_blocks)
        if sync.path != tr["wire"]:
            raise RuntimeError(f"δ = {tr['rate']} takes the {sync.path} "
                               f"wire, the traffic names {tr['wire']}")
        self.sync = sync
        self.split = SplitSync(sync, torch, self.device) if self.trace \
            else None
        self.loss_of = self.lm
        for fault in self.faults:
            fault(self)
        self.step = steps.make_pod_round_step(
            self.loss_of, opt, tr["local_k"], self.split or self.sync,
            spec=self.lm.param_spec(), dim=self.dim, n_blocks=self.n_blocks)

    def round(self):
        r, self.next_round = self.next_round, self.next_round + 1
        self.params, self.states, self.residuals, loss = self.step(
            self.params, self.states, self.batches(r), self.residuals)
        return float(loss)

    def _flat(self, t):
        return t.reshape(-1)[:self.dim]

    def setup(self) -> None:
        """Build, run the compared rounds and keep what is compared: the
        losses, each pod's momentum after the first round (on the host),
        and the norms of the change and of the residuals after the
        last."""
        self.build()
        w0 = self._flat(self.params).clone()
        norms = lambda t: compare.leaf_norms(t, self.spec)
        losses = []
        for r in range(self.tr["check_rounds"]):
            losses.append(self.round())
            if r == 0:
                mu = [s["mu"].to("cpu", copy=True) for s in self.states]
        self.program = {
            "losses": losses, "mu": mu,
            "change": norms(self._flat(self.params) - w0),
            "residual": [norms(self._flat(x)) for x in self.residuals]}
        del w0

    def window(self, seconds: float) -> dict:
        torch = self.torch
        n0 = len(self.split.spans) if self.split else 0
        ends, t0 = [], time.perf_counter()
        while True:
            self.round()
            ends.append(time.perf_counter() - t0)
            if ends[-1] >= seconds:
                break
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        out = {"wall_s": time.perf_counter() - t0, "rounds": len(ends),
               "round_ends_s": ends}
        if self.split:
            out["sync_s"] = sum(b - a for a, b in self.split.spans[n0:])
        return out

    def end_to_end(self, win: dict) -> dict:
        return {"pod_round_s": win["wall_s"] / win["rounds"]}

    def traced(self):
        """Two more rounds under the profiler, with the program's own
        annotations on."""
        from repro_torch.obs import profiling
        profiling.set_profiling(True)
        try:
            with Trace(self.torch) as tr:
                for _ in range(2):
                    self.round()
        finally:
            profiling.set_profiling(False)
        return tr, 2

    def release(self) -> None:
        del self.params, self.states, self.residuals, self.step, self.sync
        del self.split, self.lm, self.loss_of
        for undo in self.restores:
            undo()

    # --------------------------------------------------------- comparison
    def reference(self, mode: str = "fp32", against=()) -> dict:
        """The reference's first rounds in `mode`: its losses, each pod's
        momentum after the first round (on the host) and its norms, and
        the norms of the change and of the residuals after the last; and
        for each candidate of `against` (per pod momenta, on the host)
        the norms of its difference from the reference's momenta, leaf by
        leaf."""
        norms = lambda t: compare.leaf_norms(t, self.spec)
        out = {"losses": []}
        w0 = self.w0()

        def observe(r, w, mus, res, losses):
            out["losses"].append(sum(losses) / len(losses))
            if r == 0:
                out["mu_norms"] = [norms(m) for m in mus]
                out["mu_diffs"] = [[compare.leaf_diff_norms(m, c, self.spec)
                                    for m, c in zip(mus, cand)]
                                   for cand in against]
                if mode != "fp32":
                    out["mu"] = [m.to("cpu", copy=True) for m in mus]
            if r == self.tr["check_rounds"] - 1:
                out["change"] = norms(w - w0)
                out["residual"] = [norms(x[:self.dim]) for x in res]

        with Precision(mode, self.device) as prec:
            pod_round.run(self.model, self.cfg, self.tr, w0, self.rows,
                          self.tr["check_rounds"], prec, observe,
                          padded=self.padded)
        return out

    @staticmethod
    def readings(prog: dict, ref: dict, i: int = 0) -> dict:
        """The compared numbers of candidate `prog`, the `i`-th that the
        reference `ref` was run against."""
        mask = compare.counted(np.sum(ref["mu_norms"], axis=0))
        gap = compare.worst_leaf_gap
        return {
            "loss_gap": float(np.max([compare.rel_gap(a, b) for a, b in
                                      zip(prog["losses"], ref["losses"])])),
            "first_grad_gap": float(np.max([
                compare.worst_leaf_error(d, n, mask)
                for d, n in zip(ref["mu_diffs"][i], ref["mu_norms"])])),
            "change_gap": gap(prog["change"], ref["change"], mask),
            "residual_gap": float(np.max([
                gap(a, b, mask) for a, b in zip(prog["residual"],
                                                ref["residual"])])),
        }

    def check(self, mode: str = "fp32") -> dict:
        """The compared numbers of the program's first rounds (mode
        "fp32"), or of the reference computed in TF32 in the program's
        place (mode "tf32", the control), against the float32
        reference."""
        cand = self.program if mode == "fp32" else self.reference(mode)
        return self.readings(cand, self.reference("fp32", [cand["mu"]]))

    def calibrate(self, modes) -> dict:
        """{mode: the compared numbers} of this seed: "program" (the
        program as it is), "control" (the reference in TF32 in the
        program's place) or a fault of `harness/faults.py` planted in the
        program, all against one float32 reference run."""
        cands = {}
        for mode in modes:
            if mode == "control":
                cands[mode] = self.reference("tf32")
                continue
            c = Cell(self.cell, self.seed, self.device)
            c.faults = [faults.FAULTS[mode]] if mode in faults.FAULTS else []
            c.setup()
            c.release()
            cands[mode] = c.program
            del c
            gc.collect()
            if self.device.type == "cuda":
                self.torch.cuda.empty_cache()
        ref = self.reference("fp32", [c["mu"] for c in cands.values()])
        return {m: self.readings(c, ref, i)
                for i, (m, c) in enumerate(cands.items())}

    def context(self, win: dict) -> dict:
        tr = self.tr
        return {"kind": "pod", "config": self.cfg, "traffic": tr,
                "window": win,
                "shapes": {"dim": self.dim, "padded": self.padded,
                           "n_blocks": self.n_blocks, "blk": tr["blk"],
                           "shards": tr["shards"],
                           "budget": max(1, min(tr["blk"],
                                                round(tr["rate"] * tr["blk"]))),
                           "tokens_per_round": self.rows_per_round
                           * tr["seq_len"]}}
