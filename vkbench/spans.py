"""The program's own spans in a traced run, for the per-layer readers that
split the frame and the TF edit by stage.

``vkvolume_tpu_torch`` opens ``record_function`` ranges named ``vkv.*``
round its stages while a profiler records (its ``utils/timing.py``):
``vkv.render`` round ``Engine.render``, ``vkv.tf_update`` round
``Engine.update_transfer_function``, their stages inside them, and
``vkv.kernel.<key>`` round each launch of one of its own kernels. Spans
nest; the engine runs one call at a time on one thread, so a span's
ancestors name the request. This module reads, from the profiler of the
run's ``trace.Profiler``:

* the program's spans inside the window's ``vkbench.render`` and
  ``vkbench.edit`` ranges (the lead interactions do not count);
* the CUDA runtime calls that make the host wait: names ending in
  ``Synchronize``, and the synchronous ``cudaMemcpy``;
* each device operation (kernel, copy, set) with the chain of spans that
  held its launch's host time stamp, outermost first.

``trace.py`` keeps only the benchmark's ranges, and a profiler saves its
Chrome trace once; so the events are read again from the profiler itself
(``kineto_results.events()``, the same records on the same clock), which
the harness keeps alive while its readers run. The profiler is taken to
be the run's when its ``vkbench.*`` ranges are the ``Trace``'s, and the
times are shifted onto the ``Trace``'s clock. A trace with no program
span (a tree older than the spans) or no device operation (a CPU run)
gives None, and the readers then report nothing.

    python3 vkbench/spans.py --workload <cell> --seed <n> --seconds <s>

runs one traced run of a cell and prints its breakdown with the idle gaps
named by the program's spans, and each span's time.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import gc
import json
import os
import sys

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from vkbench import trace as trace_mod  # noqa: E402

PREFIX = "vkv."
KERNEL = "vkv.kernel."
WINDOW = ("vkbench.render", "vkbench.edit")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
CATS = ("user_annotation",) + RUNTIME_CATS + trace_mod.DEVICE_CATS
_harness_breakdown = trace_mod.breakdown


def is_wait(name: str) -> bool:
    """A runtime call that blocks the host until the device catches up."""
    return name.endswith("Synchronize") or name == "cudaMemcpy"


@dataclasses.dataclass
class Program:
    """The program's spans, waits and operations of one traced window.
    Times in microseconds on the ``Trace``'s clock."""

    spans: list     # (name, ts, end), sorted by ts
    waits: list     # dicts: name, ts, dur, chain
    ops: list       # dicts: name, cat, ts, dur, chain
    frames: int     # vkbench.render ranges in the window
    edits: int      # vkbench.edit ranges

    def count(self, name: str) -> int:
        return sum(1 for s in self.spans if s[0] == name)

    def ops_under(self, name: str, kernel: bool | None = None) -> list:
        """The operations launched inside span ``name``; with ``kernel``,
        only those launched inside (True) or outside (False) every
        ``vkv.kernel.*`` span."""
        return [o for o in self.ops if name in o["chain"] and (
            kernel is None
            or kernel == any(n.startswith(KERNEL) for n in o["chain"]))]

    def waits_under(self, name: str) -> list:
        return [w for w in self.waits if name in w["chain"]]


def _nest(spans: list):
    """A function from a host time stamp to the names of the ``spans``
    (nested, sorted by start) holding it, outermost first."""
    parent = []
    stack = []
    for i, (_, ts, end) in enumerate(spans):
        while stack and spans[stack[-1]][2] <= ts:
            stack.pop()
        parent.append(stack[-1] if stack else -1)
        stack.append(i)
    starts = [s[1] for s in spans]

    def chain(t: float) -> tuple:
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0 and spans[i][2] < t:
            i = parent[i]
        names = []
        while i >= 0:
            names.append(spans[i][0])
            i = parent[i]
        return tuple(reversed(names))

    return chain


def read_events(events: list, trace) -> Program | None:
    """A ``Program`` from Chrome-format events (``ph`` "X": ``cat``,
    ``name``, ``ts``, ``dur``, ``args.correlation``) of the profiler that
    made ``trace``; None when the events' ``vkbench.*`` ranges or device
    operations are not the trace's, or the window holds no program span or
    no device operation."""
    ranges, spans, runtime, device = [], [], [], []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in CATS:
            continue
        cat, name = e["cat"], e["name"]
        ts, dur = float(e["ts"]), float(e["dur"])
        if cat == "user_annotation":
            if name in trace_mod.RANGES:
                ranges.append((name, ts, ts + dur))
            elif name.startswith(PREFIX):
                spans.append((name, ts, ts + dur))
        elif cat in RUNTIME_CATS:
            runtime.append(e)
        else:
            device.append(e)
    ranges.sort(key=lambda r: r[1])
    theirs = trace.ranges
    if not ranges or [r[0] for r in ranges] != [r[0] for r in theirs]:
        return None
    if any(abs((a[2] - a[1]) - (b[2] - b[1])) > 0.01
           for a, b in zip(ranges, theirs)):
        return None
    shift = theirs[0][1] - ranges[0][1]
    window = [(r[1], r[2]) for r in ranges if r[0] in WINDOW]
    w_starts = [w[0] for w in window]

    def in_window(t: float) -> bool:
        i = bisect.bisect_right(w_starts, t) - 1
        return i >= 0 and window[i][1] >= t

    spans = sorted((s for s in spans if in_window(s[1])),
                   key=lambda s: (s[1], -s[2]))
    if not spans or not device or len(device) != len(trace.ops):
        return None
    chain = _nest(spans)
    launch_ts = {}
    waits = []
    for e in runtime:
        ts = float(e["ts"])
        corr = (e.get("args") or {}).get("correlation")
        if corr is not None:
            launch_ts[corr] = ts
        if is_wait(e["name"]):
            waits.append(dict(name=e["name"], ts=ts + shift,
                              dur=float(e["dur"]), chain=chain(ts)))
    ops = []
    for e in device:
        host = launch_ts.get((e.get("args") or {}).get("correlation"))
        ops.append(dict(name=e["name"], cat=e["cat"],
                        ts=float(e["ts"]) + shift, dur=float(e["dur"]),
                        chain=chain(host) if host is not None else ()))
    return Program(
        spans=[(n, a + shift, b + shift) for n, a, b in spans],
        waits=waits, ops=ops, frames=trace.count("vkbench.render"),
        edits=trace.count("vkbench.edit"))


def _events(torch_profile, trace) -> list:
    """A torch profiler's events in the Chrome format ``read_events``
    reads: user annotations on the host, the runtime's and driver's calls
    (``cu*``), and the device operations ``trace`` holds, by name (their
    categories as ``trace.py`` read them from the Chrome trace). Times
    from the first event's: whole nanoseconds since the epoch lose the
    nanoseconds in a double of microseconds."""
    from torch.autograd import DeviceType

    cats = {o["name"]: o["cat"] for o in trace.ops}
    kept = []
    for e in torch_profile.profiler.kineto_results.events():
        name, host = e.name(), e.device_type() == DeviceType.CPU
        if e.is_user_annotation():
            cat = "user_annotation" if host else None
        elif host:
            cat = "cuda_runtime" if name.startswith("cu") else None
        else:
            cat = cats.get(name)
        if cat is not None:
            kept.append((cat, name, e))
    t0 = min((e.start_ns() for _, _, e in kept), default=0)
    return [{"ph": "X", "cat": cat, "name": name,
             "ts": (e.start_ns() - t0) / 1e3, "dur": e.duration_ns() / 1e3,
             "args": {"correlation": e.correlation_id()}}
            for cat, name, e in kept]


def attach(trace, events: list) -> Program | None:
    """Reads ``events`` for ``trace`` and keeps the result on it."""
    trace._program = read_events(events, trace)
    return trace._program


def view(trace) -> Program | None:
    """The program's spans of ``trace``'s window, read once from the live
    profiler that made it."""
    if not hasattr(trace, "_program"):
        trace._program = None
        for obj in gc.get_objects():
            if type(obj) is trace_mod.Profiler and obj.prof is not None:
                try:
                    events = _events(obj.prof, trace)
                except (AttributeError, RuntimeError):
                    continue
                if attach(trace, events) is not None:
                    break
    return trace._program


def breakdown(trace) -> dict:
    """``trace.breakdown`` with each idle gap named by the innermost
    program span holding its midpoint (else the benchmark's range, as
    there), and ``spans``: for each span name, its count and seconds in
    the window: host time inside it, and of what it launched or waited
    for itself (no child span between): device time, launches, host
    time waiting."""
    out = _harness_breakdown(trace)
    prog = view(trace)
    if prog is None:
        return out
    chain = _nest([(n, a, b) for n, a, b in prog.spans])
    gaps = []
    t0, t1 = trace.window
    prev = t0
    for a, b in trace.busy_intervals() + [[t1, t1]]:
        if a > prev:
            mid = (prev + a) / 2
            names = chain(mid)
            gaps.append((names[-1] if names else trace.host_range_at(mid),
                         a - prev))
        prev = max(prev, b)
    gaps.sort(key=lambda g: -g[1])
    out["idle_gaps"] = [[n, us / 1e6] for n, us in gaps[:10]]
    rows = collections.defaultdict(lambda: [0, 0.0, 0.0, 0, 0.0])
    for n, a, b in prog.spans:
        rows[n][0] += 1
        rows[n][1] += b - a
    for o in prog.ops:
        if o["chain"]:
            rows[o["chain"][-1]][2] += o["dur"]
            rows[o["chain"][-1]][3] += 1
    for w in prog.waits:
        if w["chain"]:
            rows[w["chain"][-1]][4] += w["dur"]
    out["spans"] = [[n, c, host / 1e6, dev / 1e6, k, wait / 1e6]
                    for n, (c, host, dev, k, wait) in sorted(
                        rows.items(), key=lambda kv: -kv[1][1])]
    out["frames"], out["edits"] = prog.frames, prog.edits
    return out


def main(argv=None) -> int:
    import argparse
    from unittest import mock

    from vkbench import run

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    with mock.patch.object(run.trace_mod, "breakdown", breakdown):
        result, lines = run.run_cell(args.workload, args.seed, args.seconds,
                                     True)
    print(json.dumps({"correct": result["correct"],
                      "metrics": result["metrics"],
                      "breakdown": result["breakdown"]}), flush=True)
    for line in lines:
        print(line, file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
