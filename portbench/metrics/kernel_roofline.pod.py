"""kernel_roofline.pod (%): the port's four kernels against the HBM
roofline in the traced pod rounds: sum over their launches of
bytes / peak bandwidth, over the sum of their measured device times.
Each launch's bytes come from the cell's shapes (`launch_bytes`), each
input read once and each output written once. At d = 0.78 B each vector
is 3.1 GB, far past the 50 MB L2. Moves pod_round_s."""

from portbench.harness import spec
from portbench.harness.device import kernel_times


def launch_bytes(shapes: dict, wire: str) -> dict:
    """Bytes one launch of each kernel moves in a pod round of these
    shapes: fused_momentum updates w and mu from g over d coordinates;
    magnitude_hist reads the vector it counts (a shard of the padded
    vector on the compact wire, all of it on the dense wire);
    compact_blocks reads the shard and writes its residual, values,
    indices and counts; ef_topk reads g and r and writes out and r'."""
    d, n, nb = shapes["dim"], shapes["padded"], shapes["n_blocks"]
    shard = n // shapes["shards"] if wire == "compact" else n
    nbl = nb // shapes["shards"]
    return {
        "fused_momentum_kernel": 4 * 5 * d,
        "hist_kernel": 4 * shard,
        "compact_kernel": 4 * 2 * shard + 8 * nbl * shapes["budget"]
        + 4 * nbl,
        "ef_topk_kernel": 4 * 4 * n,
    }


def read(ctx):
    peak = spec.load_json(spec.PB / "peaks.json").get(ctx["device"]["kind"])
    if peak is None:
        return None
    per = launch_bytes(ctx["shapes"], ctx["traffic"]["wire"])
    times = kernel_times(ctx["trace"].device, per)
    secs = sum(sum(v) for v in times.values())
    if not secs:
        return None
    least = sum(per[k] * len(v) for k, v in times.items()) \
        / peak["hbm_bytes_per_s"]
    return 100.0 * least / secs
