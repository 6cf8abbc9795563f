"""ssd_kernel_ms.pod (ms/round): device time of the port's chunked SSD
kernels (`kernels/csrc/ssd.cu`, every kernel named `ssd_*`: the Mamba-2
layers' scan, forward and backward) per traced pod round, summed over
their launches. None where no such kernel ran (a program whose SSD is the
einsum chain). Moves pod_round_s."""

from portbench.harness.device import kernel_times


def read(ctx):
    times = kernel_times(ctx["trace"].device, ("ssd_",))["ssd_"]
    if not ctx["trace_rounds"] or not times:
        return None
    return 1e3 * sum(times) / ctx["trace_rounds"]
