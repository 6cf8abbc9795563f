"""attn_fwd_launches.pod (launches/layer): kernel launches per forward of
one attention-mixer layer (its norms, projections, attention and MLP) of
the pod round's LM in the traced rounds: the host's launch rows
(`cudaLaunch*`, `cuLaunch*`) that start inside the program's
`lm.layer.attention` spans (`models/transformer.py`), over those spans.
Moves pod_round_s."""

from portbench.harness.spans import launches_per_step


def read(ctx):
    return launches_per_step(ctx["trace"], "lm.layer.attention",
                             "lm.layer.attention")
