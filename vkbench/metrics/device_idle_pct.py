"""Share of the profiled sub-window in which no device operation ran,
in percent: 100 x (1 - union of device activity / window)."""


def read(trace):
    t0, t1 = trace.window
    if t1 <= t0 or not trace.ops:
        return None
    return 100.0 * (1.0 - trace.busy_us() / (t1 - t0))
