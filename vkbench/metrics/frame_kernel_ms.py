"""Device time of the operations launched inside the ``vkbench.render``
range, per frame, in milliseconds."""


def read(trace):
    n = trace.count("vkbench.render")
    ops = trace.ops_in("vkbench.render")
    return sum(o["dur"] for o in ops) / 1e3 / n if n and ops else None
