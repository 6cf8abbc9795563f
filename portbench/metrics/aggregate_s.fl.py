"""aggregate_s.fl (s/round): host seconds per round in the server's
aggregation (the program's `sim.aggregate` spans in `core/simulator.py`:
the sanitizer and Eq. 6 of `core/aggregation.py`, in numpy), summed over
the traced segment. The profiler instruments torch operations, which
this work has none of, so it stretches little under the trace. Moves
fl_round_s."""

from portbench.harness.spans import seconds_per_round


def read(ctx):
    return seconds_per_round(ctx["trace"], "sim.aggregate",
                             ctx["trace_rounds"])
