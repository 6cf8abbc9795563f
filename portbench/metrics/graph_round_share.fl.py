"""graph_round_share.fl (%): the share of the traced segment's FL local
rounds that replayed a CUDA graph: of the program's `local_round` spans
(`dist/steps.py`, and the batched engine's replay in
`core/simulator.py`), those inside which a graph-launch host row
(`cudaGraphLaunch*`, `cuGraphLaunch*`) starts. A replayed round is one
launch for its k steps, where an eager one launches every operator of
every step. Moves fl_round_s. None without a `local_round` span (a
program without the span, or a run without a card)."""

import bisect

from portbench.harness.spans import intervals, within

GRAPH_LAUNCH = ("cudaGraphLaunch", "cuGraphLaunch")


def share(host):
    rounds = intervals(host, "local_round")
    if not rounds:
        return None
    inside = within(rounds)
    starts = sorted(s for name, s, _ in host
                    if name.startswith(GRAPH_LAUNCH) and inside(s))
    replayed = 0
    for lo, hi in rounds:
        i = bisect.bisect_left(starts, lo)
        replayed += i < len(starts) and starts[i] < hi
    return 100.0 * replayed / len(rounds)


def read(ctx):
    return share(ctx["trace"].host)
