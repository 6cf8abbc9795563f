"""The per-layer metric readers on hand-made windows and traces, the trace
reduction, and the FLOP and byte counting against closed forms."""
from __future__ import annotations

import types

import pytest

from portbench.tests.small_cells import small
from portbench.harness import device as dv
from portbench.harness import spec
from portbench.reference import cnn, mamba2

H100 = {"kind": "NVIDIA H100 80GB HBM3"}
R = spec.metric_reader


def trace(device, window=(0.0, 1e6)):
    """A recorded trace: device rows (name, start_us, dur_us)."""
    return types.SimpleNamespace(device=device, host=[], window=window)


def test_busy_merges_overlaps_and_clips_to_window():
    rows = [("a", 0.0, 100.0), ("b", 50.0, 100.0), ("c", 300.0, 100.0),
            ("d", 950.0, 100.0)]
    # [0, 150) + [300, 400) + [950, 1000) clipped at the window's end
    assert dv.busy_s(rows, (0.0, 1000.0)) == pytest.approx(300e-6)


def test_idle_gaps_labelled_by_innermost_host_op():
    dev = [("k", 100.0, 100.0), ("k", 600.0, 100.0)]
    host = [("outer", 0.0, 1000.0), ("aten::item", 300.0, 250.0)]
    gaps = dict(dv.idle_gaps(dev, host, (0.0, 1000.0)))
    assert gaps == pytest.approx({"aten::item": 400e-6, "outer": 400e-6})


def test_top_ops_and_kernel_times():
    rows = [("void hist_kernel<float>(...)", 0, 10.0),
            ("fused_momentum_kernel", 20, 30.0), ("hist_kernel", 60, 5.0)]
    assert dv.top_ops(rows)[0] == ["fused_momentum_kernel", 30e-6]
    kt = dv.kernel_times(rows, ("hist_kernel", "ef_topk_kernel"))
    assert kt["hist_kernel"] == pytest.approx([10e-6, 5e-6])
    assert kt["ef_topk_kernel"] == []


def test_fl_window_readers():
    win = {"wall_s": 5.0, "rounds": 10, "dispatch_s": 3.0, "chunks": 40,
           "row_steps": 750.0, "evals": 6}
    ctx = {"window": win}
    assert R("host_dispatch_s.fl").read(ctx) == pytest.approx(0.3)
    assert R("chunks_per_round.fl").read(ctx) == pytest.approx(4.0)
    assert R("host_dispatch_s.fl").read({"window": {"rounds": 0}}) is None


def test_kernel_ms_and_idle():
    rows = [("fused_momentum_kernel", 0.0, 20.0),
            ("void ef_topk_kernel<float, float>", 100.0, 15.0),
            ("void at::native::elementwise", 200.0, 65.0)]
    ctx = {"trace": trace(rows, (0.0, 1000.0)), "trace_rounds": 5,
           "window": {"wall_s": 2e-4, "rounds": 4}}
    assert R("kernel_ms.fl").read(ctx) == pytest.approx(0.035 / 5)
    # busy 100 us over 5 traced rounds, against 50 us a round untraced
    assert R("device_idle.fl").read(ctx) == pytest.approx(60.0)
    assert R("device_idle.pod").read(ctx) == pytest.approx(60.0)
    assert R("kernel_ms.fl").read(
        {"trace": trace(rows[2:]), "trace_rounds": 5}) is None
    assert R("device_idle.fl").read({**ctx, "trace": trace([])}) is None


def test_cnn_flops_closed_form():
    cfg = small("cnn_fmnist.fl_fedluck")["config"]
    mfu = R("mfu.fl")
    # conv1 28·28·32·25, conv2 14·14·64·800, fc1 3136·512, fc2 512·10
    assert cnn.forward_flops(cfg) == 2 * (627200 + 10035200 + 1605632
                                          + 5120)
    ctx = {"config": cfg, "traffic": {"batch_size": 32},
           "window": {"wall_s": 2.0, "row_steps": 100.0, "evals": 3},
           "device": H100}
    fwd = 2 * 12273152
    flops = 3 * fwd * 100 * 32 + fwd * 3 * cfg["data"]["test_samples"]
    assert mfu.read(ctx) == pytest.approx(100 * flops / (2.0 * 67e12))
    assert mfu.read({**ctx, "device": {"kind": "cpu"}}) is None


def test_mamba2_flops_closed_form():
    cfg = small("mamba2-780m.pod_compact")["config"]   # d 64, 2 layers
    # per layer: in_proj 64·(256+32+8), out_proj 128·64, conv 4·160,
    # SSD 32·16 + 32·8·16 + 2·8·16·16; head 64·512
    per = 64 * 296 + 128 * 64 + 4 * 160 + (512 + 4096 + 4096)
    assert mamba2.forward_flops(cfg) == 2 * (2 * per + 64 * 512)
    ctx = {"config": cfg, "window": {"wall_s": 3.0, "rounds": 2},
           "shapes": {"tokens_per_round": 1000}, "device": H100}
    assert R("mfu.pod").read(ctx) == pytest.approx(
        100 * 3 * 2 * (2 * per + 64 * 512) * 1000 * 2 / (3.0 * 67e12))


def test_pod_span_readers():
    ctx = {"window": {"wall_s": 10.0, "rounds": 4, "sync_s": 0.4}}
    assert R("local_s.pod").read(ctx) == pytest.approx(2.4)
    assert R("sync_s.pod").read(ctx) == pytest.approx(0.1)


def test_kernel_roofline_bytes_and_share():
    kr = R("kernel_roofline.pod")
    shapes = {"dim": 1000, "padded": 1024, "n_blocks": 16, "blk": 64,
              "budget": 1, "shards": 2}
    b = kr.launch_bytes(shapes, "compact")
    assert b == {"fused_momentum_kernel": 20000, "hist_kernel": 2048,
                 "compact_kernel": 4096 + 64 + 32, "ef_topk_kernel": 16384}
    assert kr.launch_bytes(shapes, "dense")["hist_kernel"] == 4096
    rows = [("fused_momentum_kernel", 0.0, 1.0),
            ("void hist_kernel<float>", 5.0, 2.0)]
    ctx = {"trace": trace(rows), "shapes": shapes, "device": H100,
           "traffic": {"wire": "compact"}}
    least = (20000 + 2048) / 3.35e12
    assert kr.read(ctx) == pytest.approx(100 * least / 3e-6)
