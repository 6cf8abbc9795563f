"""launches_per_step.fl (launches/step): kernel launches per optimizer
step of the FL local rounds in the traced segment: the host's launch rows
(`cudaLaunch*`, `cuLaunch*`) that start inside the program's
`local_round` spans (`dist/steps.py`: the one-row and the vmapped path),
over the `local_round.step` spans there. A vmapped step counts once for
all its rows. Moves fl_round_s: each launch costs the host its launch
overhead."""

from portbench.harness.spans import launches_per_step


def read(ctx):
    return launches_per_step(ctx["trace"])
