"""ssm_fwd_launches.pod (launches/layer): kernel launches per forward of
one Mamba-2 mixer layer (its norms, SSD and MLP where it has one) of the
pod round's LM in the traced rounds: the host's launch rows
(`cudaLaunch*`, `cuLaunch*`) that start inside the program's
`lm.layer.ssm` spans (`models/transformer.py`, around each layer's
forward, not its backward), over those spans. Moves pod_round_s."""

from portbench.harness.spans import launches_per_step


def read(ctx):
    return launches_per_step(ctx["trace"], "lm.layer.ssm", "lm.layer.ssm")
