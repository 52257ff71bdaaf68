"""Host time of the waits ``frame_syncs`` counts, per frame, in
milliseconds."""

from vkbench import spans


def read(trace):
    p = spans.view(trace)
    if p is None or not p.frames or not p.count("vkv.render"):
        return None
    return sum(w["dur"] for w in p.waits_under("vkv.render")) / 1e3 / p.frames
