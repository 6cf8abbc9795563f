"""schedule_s.fl (s/round): host seconds per round in the simulator's
event loop (the program's `sim.schedule` spans in `core/simulator.py`:
heap pops, down checks, re-plans, upload outcomes, pushes and the
records of each evaluation; never a phase), summed over the traced
segment. Plain Python, so it stretches little under the trace. Moves
fl_round_s."""

from portbench.harness.spans import seconds_per_round


def read(ctx):
    return seconds_per_round(ctx["trace"], "sim.schedule",
                             ctx["trace_rounds"])
