"""The plain references in portbench/reference against the port at small
sizes on the CPU (where the port's kernels run their plain versions)."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.tests.small_cells import small
from portbench.harness import inputs
from portbench.harness.pod import port_arch
from portbench.reference import cnn, compress, fl_sim, mamba2
from portbench.reference.precision import Precision

FP32 = Precision("fp32", "cpu")


def rel(a, b) -> float:
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def test_cnn_loss_and_gradient_match_the_port():
    from repro_torch.core import compression as C
    from repro_torch.models import small as port
    cfg = small("cnn_fmnist.fl_fedluck")["config"]
    task = port.make_task("cnn_fmnist", num_samples=8, test_samples=8)
    sp = cnn.spec(cfg)
    assert [(tuple(p), tuple(s)) for p, s in task.spec] == sp
    w = inputs.weights(sp, 3, "cpu", cfg["init"]).requires_grad_(True)
    ds = inputs.generator(cfg["data"]).make(cfg["data"], 16, 1, 2)
    x, y = torch.as_tensor(ds.x), torch.as_tensor(ds.labels)
    lr = cnn.loss(w, sp, cfg, x, y, FP32)
    gr, = torch.autograd.grad(lr, w)
    wp = w.detach().clone().requires_grad_(True)
    lp = task.loss_fn(C.unflatten_pytree(wp, task.spec),
                      {"image": x, "label": y})
    gp, = torch.autograd.grad(lp, wp)
    assert float(lp.detach()) == pytest.approx(float(lr.detach()), rel=1e-6)
    assert rel(gp, gr) < 1e-5


def test_mamba2_loss_and_gradient_match_the_port():
    from repro_torch.core import compression as C
    from repro_torch.models.transformer import LM
    cfg = small("mamba2-780m.pod_compact")["config"]
    arch = port_arch(cfg)
    assert (arch.d_model, arch.n_layers, arch.vocab, arch.ssm_state,
            arch.ssm_head_dim) == (64, 2, 512, 16, 16)
    lm = LM(arch, dtype=torch.float32, remat=False)
    sp = mamba2.spec(cfg)
    assert [(tuple(p), tuple(sh)) for p, sh in lm.param_spec()] == sp
    w = inputs.weights(sp, 5, "cpu", cfg["init"])
    tok = torch.as_tensor(inputs.generator(cfg["data"]).make(
        cfg["data"], cfg["vocab_size"], 2, 65, 9))
    wr = w.clone().requires_grad_(True)
    lr = mamba2.loss(wr, sp, cfg, tok[:, :-1], tok[:, 1:], FP32)
    gr, = torch.autograd.grad(lr, wr)
    wp = w.clone().requires_grad_(True)
    lp = lm.loss(C.unflatten_pytree(wp, sp),
                 {"tokens": tok[:, :-1], "labels": tok[:, 1:]})
    gp, = torch.autograd.grad(lp, wp)
    assert float(lp.detach()) == pytest.approx(float(lr.detach()), rel=1e-5)
    assert rel(gp, gr) < 1e-4


def test_plans_match_the_port():
    from repro_torch.core.simulator import (make_heterogeneous_devices,
                                            plan_devices)
    tr = small("cnn_fmnist.fl_fedluck")["traffic"]
    tr = {**tr, "devices": 10, "fleet_seed": 77}
    dim = 1663370
    ref = fl_sim.devices(tr, dim)
    prof = make_heterogeneous_devices(
        10, dim * 32, base_alpha=tr["base_alpha"],
        alpha_spread=tr["alpha_spread"], bw_range=tuple(tr["bandwidth_bps"]),
        seed=77)
    specs = plan_devices(prof, "fedluck", tr["round_period"],
                         k_bounds=tuple(tr["k_bounds"]),
                         delta_bounds=tuple(tr["delta_bounds"]))
    assert [(p.alpha, p.beta) for p in prof] == [r[:2] for r in ref]
    assert [(s.plan.k, s.plan.delta) for s in specs] == [r[2:] for r in ref]


@pytest.mark.parametrize("rate", [0.001, 0.05])
def test_ef_compressors_match_the_port(rate):
    from repro_torch.core import compression as C
    gen = torch.Generator().manual_seed(1)
    g = torch.randn(40000, generator=gen)
    r = torch.randn(40000, generator=gen) * 0.1
    k = compress.num_keep(40000, rate)
    cc, res = C.ef_compress(C.make_compressor("topk", rate), g, r)
    kept, new = compress.topk_ef(g, r, k)
    assert torch.equal(cc.dense(), kept) and torch.equal(res, new)
    cc, res = C.topk_threshold_ef(g, r, rate)
    kept, new = compress.threshold_ef(g, r, k)
    assert torch.equal(cc.values, kept) and torch.equal(res, new)


@pytest.mark.parametrize("rate,wire", [(0.01, "compact"), (0.6, "dense")])
def test_pod_wires_match_the_port(rate, wire):
    from repro_torch.dist.collectives import make_pod_sync
    nb, blk, P = 32, 64, 2
    n = nb * blk
    gen = torch.Generator().manual_seed(2)
    params = torch.randn(nb, blk, generator=gen)
    deltas = torch.randn(P, nb, blk, generator=gen)
    res = torch.randn(P, nb, blk, generator=gen) * 0.1
    sync = make_pod_sync({"pod": P, "data": 1, "model": 1}, n, rate=rate,
                         n_blocks=nb)
    assert sync.path == wire
    new_p, new_r = sync(params, deltas, res)
    budget = max(1, min(blk, round(rate * blk)))
    upd = torch.zeros(n)
    for p in range(P):
        acc = deltas[p].reshape(-1) + res[p].reshape(-1)
        if wire == "compact":
            shipped, r = compress.compact_wire(acc, blk, budget)
        else:
            shipped, r = compress.dense_wire(acc, compress.num_keep(n, rate))
        upd += shipped
        torch.testing.assert_close(r, new_r[p].reshape(-1), rtol=0,
                                   atol=1e-6)
    torch.testing.assert_close(params.reshape(-1) - upd / P,
                               new_p.reshape(-1), rtol=0, atol=1e-6)


def test_local_round_matches_the_port():
    from repro_torch.dist.steps import local_round
    from repro_torch.models import small as port
    from repro_torch.optim import momentum_sgd
    cfg = small("cnn_fmnist.fl_fedluck")["config"]
    task = port.make_task("cnn_fmnist", num_samples=8, test_samples=8)
    sp = cnn.spec(cfg)
    w0 = inputs.weights(sp, 4, "cpu", cfg["init"])
    ds = inputs.generator(cfg["data"]).make(cfg["data"], 24, 1, 3)
    xs = [torch.as_tensor(ds.x[i:i + 8]) for i in (0, 8, 16)]
    ys = [torch.as_tensor(ds.labels[i:i + 8]) for i in (0, 8, 16)]
    opt = momentum_sgd(0.05, 0.9)
    _, _, delta, _ = local_round(
        task.loss_fn, opt, w0, task.spec, opt.init(w0),
        [{"image": x, "label": y} for x, y in zip(xs, ys)])
    ref = fl_sim.local_round(cnn, cfg, w0, sp, xs, ys, 0.05, 0.9, FP32)
    assert rel(delta, ref) < 1e-5


def test_tf32_emulation_rounds_operands():
    x = torch.tensor([1.0 + 2 ** -12, 1.0 + 2 ** -9, 3.0])
    with Precision("tf32", "cpu") as p:
        assert p.r(x).tolist() == [1.0, 1.0 + 2 ** -9, 3.0]
    assert np.float32(1 + 2 ** -12) != 1.0
