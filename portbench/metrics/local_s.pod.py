"""local_s.pod (s/round): wall seconds per pod round outside the pod
sync: the local rounds (forward, backward and fused_momentum of the LM
on every pod) and the round's host work, i.e. the round's wall minus the
sync span that the benchmark's `SplitSync` measures. Moves pod_round_s."""


def read(ctx):
    w = ctx["window"]
    if not w.get("rounds") or "sync_s" not in w:
        return None
    return (w["wall_s"] - w["sync_s"]) / w["rounds"]
