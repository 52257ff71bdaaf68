"""Device time of the operations launched inside ``vkv.kernel.*`` spans
within the program's ``vkv.render`` span, per frame, in milliseconds: the
port's own frame kernels alone (K1, K7, K2, K8; ``spans.py``)."""

from vkbench import spans


def read(trace):
    p = spans.view(trace)
    ops = p.ops_under("vkv.render", kernel=True) if p is not None else []
    return sum(o["dur"] for o in ops) / 1e3 / p.frames \
        if ops and p.frames else None
