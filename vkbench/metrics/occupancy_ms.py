"""Device time of the operations launched inside the program's
``vkv.tf_update.occupancy`` span (the occupancy map of a TF edit, before
the distance kernels), per edit, in milliseconds (``spans.py``)."""

from vkbench import spans


def read(trace):
    p = spans.view(trace)
    ops = p.ops_under("vkv.tf_update.occupancy") if p is not None else []
    return sum(o["dur"] for o in ops) / 1e3 / p.edits \
        if ops and p.edits else None
