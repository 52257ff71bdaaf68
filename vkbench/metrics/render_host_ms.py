"""Mean host time of a call to ``Engine.render``, from the call until it
returns, with no synchronise: the engine, the host plan and the frame's
launches, on the host clock of the traced run's interactions outside the
profiled sub-window."""


def read(trace):
    host = trace.context.get("render_host_ms") or []
    return sum(host) / len(host) if host else None
