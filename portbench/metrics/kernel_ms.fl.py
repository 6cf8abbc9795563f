"""kernel_ms.fl (ms/round): device time of the port's four kernels
(fused_momentum, magnitude_hist, ef_topk, compact_blocks) per
aggregation round, summed over their launches in the traced segment.
At the CNN's d = 1,663,370 a launch's vectors fit in the 50 MB L2, so
the kernels get a time here and no roofline share. Moves fl_round_s."""

from portbench.harness.device import kernel_times

KERNELS = ("fused_momentum_kernel", "hist_kernel", "ef_topk_kernel",
           "compact_kernel")


def read(ctx):
    times = kernel_times(ctx["trace"].device, KERNELS)
    if not ctx["trace_rounds"] or not any(times.values()):
        return None
    return 1e3 * sum(sum(v) for v in times.values()) / ctx["trace_rounds"]
