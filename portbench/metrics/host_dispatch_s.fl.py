"""host_dispatch_s.fl (s/round): host seconds per aggregation round that
the simulator spends in its `dispatch` phase (`obs.PhaseTimers` in
`core/simulator.py`: building and enqueueing every chunk of a drain, no
wait for the card), over the window. Moves fl_round_s."""


def read(ctx):
    w = ctx["window"]
    if not w.get("rounds") or "dispatch_s" not in w:
        return None
    return w["dispatch_s"] / w["rounds"]
