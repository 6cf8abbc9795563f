"""sync_s.pod (s/round): wall seconds per pod round inside the pod sync
(`dist.collectives.make_pod_sync`: EF accumulate, threshold solve,
selection, the Eq. 6 mean), between the card synchronisations with which
the benchmark's `SplitSync` brackets it. Moves pod_round_s."""


def read(ctx):
    w = ctx["window"]
    if not w.get("rounds") or "sync_s" not in w:
        return None
    return w["sync_s"] / w["rounds"]
