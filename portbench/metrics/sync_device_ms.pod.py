"""sync_device_ms.pod (ms/round): the pod sync's own device time: the
card's busy ms (the union of its operations' intervals) inside the
program's `pod.sync` spans (`dist/steps.py`, around the call of the sync
of `dist/collectives.py`), each from its first `pod_sync.*` range on, per
traced round. The benchmark's `SplitSync` drains the card at the span's
start, before that range, and at its end, so the local rounds' tail
stays out. Moves pod_round_s."""

from portbench.harness.spans import device_ms_inside


def read(ctx):
    return device_ms_inside(ctx["trace"], "pod.sync", "pod_sync.",
                            ctx["trace_rounds"])
