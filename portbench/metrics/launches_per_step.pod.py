"""launches_per_step.pod (launches/step): kernel launches per local step
of the pod round's LM (forward, backward, the gradient's concatenation
and fused_momentum) in the traced rounds: the host's launch rows
(`cudaLaunch*`, `cuLaunch*`) that start inside the program's
`local_round` spans (`dist/steps.py`), over the `local_round.step` spans
there. Moves pod_round_s."""

from portbench.harness.spans import launches_per_step


def read(ctx):
    return launches_per_step(ctx["trace"])
