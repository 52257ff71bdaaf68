"""Runtime calls that made the host wait for the device (names ending in
``Synchronize``, and the synchronous ``cudaMemcpy``) while it was inside
the program's ``vkv.render`` span, per frame (``spans.py``)."""

from vkbench import spans


def read(trace):
    p = spans.view(trace)
    if p is None or not p.frames or not p.count("vkv.render"):
        return None
    return len(p.waits_under("vkv.render")) / p.frames
