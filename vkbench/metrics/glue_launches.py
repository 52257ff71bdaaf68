"""Device operations (kernels, copies, sets) launched inside the
program's ``vkv.render`` span and outside every ``vkv.kernel.*`` span, per
frame: the torch glue round the port's own kernels (``spans.py``)."""

from vkbench import spans


def read(trace):
    p = spans.view(trace)
    ops = p.ops_under("vkv.render", kernel=False) if p is not None else []
    return len(ops) / p.frames if ops and p.frames else None
