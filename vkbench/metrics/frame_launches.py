"""Device operations (kernels, copies, sets) launched inside the
``vkbench.render`` range, per frame: the frame's glue and kernels."""


def read(trace):
    n = trace.count("vkbench.render")
    ops = trace.ops_in("vkbench.render")
    return len(ops) / n if n and ops else None
