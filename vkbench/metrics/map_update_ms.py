"""Device time of the operations launched inside the ``vkbench.edit``
range (``Engine.update_transfer_function``: the occupancy and distance
maps), per edit, in milliseconds."""


def read(trace):
    n = trace.count("vkbench.edit")
    ops = trace.ops_in("vkbench.edit")
    return sum(o["dur"] for o in ops) / 1e3 / n if n and ops else None
