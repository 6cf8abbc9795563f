"""mfu.fl (%): the whole FL round's share of the card's float32 peak:
model FLOPs of the window's local steps (forward and backward, 3x the
forward, no recomputation) and evaluations (one forward per test sample;
the simulator takes accuracy and loss from two) over wall x peak. One
sample's forward FLOPs come from the configuration's model reference
(`forward_flops`). Moves fl_round_s."""

from portbench.harness import spec


def window_flops(ctx) -> float:
    cfg, tr, w = ctx["config"], ctx["traffic"], ctx["window"]
    fwd = spec.reference(cfg).forward_flops(cfg)
    return (3 * fwd * w["row_steps"] * tr["batch_size"]
            + fwd * w["evals"] * cfg["data"]["test_samples"])


def read(ctx):
    peak = spec.load_json(spec.PB / "peaks.json").get(ctx["device"]["kind"])
    w = ctx["window"]
    if peak is None or not w.get("row_steps"):
        return None
    return 100.0 * window_flops(ctx) / (w["wall_s"]
                                        * peak["fp32_flops_per_s"])
