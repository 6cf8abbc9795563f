"""mfu.pod (%): the whole pod round's share of the card's float32 peak:
model FLOPs of the window's rounds over wall x peak. One token's forward
FLOPs come from the configuration's model reference (`forward_flops`);
forward and backward are 3x the forward, with no recomputation. Moves
pod_round_s."""

from portbench.harness import spec


def read(ctx):
    peak = spec.load_json(spec.PB / "peaks.json").get(ctx["device"]["kind"])
    w, cfg = ctx["window"], ctx["config"]
    if peak is None or not w.get("rounds"):
        return None
    flops = 3 * spec.reference(cfg).forward_flops(cfg) \
        * ctx["shapes"]["tokens_per_round"] * w["rounds"]
    return 100.0 * flops / (w["wall_s"] * peak["fp32_flops_per_s"])
