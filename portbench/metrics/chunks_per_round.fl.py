"""chunks_per_round.fl (chunks/round): chunks the batched engine
dispatches per aggregation round (the count of the simulator's
`engine.chunk_size` histogram), over the window. Each chunk is one
local-round launch sequence, so fewer chunks mean fewer host launches.
Moves fl_round_s."""


def read(ctx):
    w = ctx["window"]
    if not w.get("rounds") or "chunks" not in w:
        return None
    return w["chunks"] / w["rounds"]
