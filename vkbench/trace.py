"""The traced run's reduction: a ``torch.profiler`` trace of a steady
sub-window, read into device operations attributed to the benchmark's own
ranges, with nothing of it kept on disk.

The benchmark marks each call into the program with a ``record_function``
range: ``vkbench.render`` round ``Engine.render``, ``vkbench.edit`` round
``Engine.update_transfer_function`` and ``vkbench.wait`` round the
synchronise that ends an interaction. A device operation (kernel, copy or
set) belongs to the range in which the host launched it: its runtime call
(``cudaLaunchKernel``, ``cudaMemcpyAsync``, ...) carries the same
correlation id, and its host time stamp falls inside the range. Device and
host time stamps share one clock in the trace.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RANGES = ("vkbench.render", "vkbench.edit", "vkbench.wait")


@dataclasses.dataclass
class Trace:
    """What the per-layer readers read. Times in microseconds."""

    ops: list              # dicts: name, cat, ts, dur, range (name or None)
    ranges: list           # (name, ts, end), sorted by ts
    window: tuple          # (start, end) of the profiled sub-window
    context: dict          # what the run knows besides: shapes, host times
    _starts: list = dataclasses.field(default_factory=list)

    def count(self, name: str) -> int:
        return sum(1 for r in self.ranges if r[0] == name)

    def ops_in(self, name: str) -> list:
        return [o for o in self.ops if o["range"] == name]

    def busy_intervals(self) -> list:
        """The union of the device operations' intervals inside the
        window, merged and sorted."""
        t0, t1 = self.window
        spans = sorted((max(o["ts"], t0), min(o["ts"] + o["dur"], t1))
                       for o in self.ops)
        merged = []
        for a, b in spans:
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    def busy_us(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def host_range_at(self, t: float) -> str:
        if len(self._starts) != len(self.ranges):
            self._starts = [r[1] for r in self.ranges]
        i = bisect.bisect_right(self._starts, t) - 1
        if i >= 0 and self.ranges[i][2] >= t:
            return self.ranges[i][0]
        return "vkbench.harness"


def read_chrome_trace(events: list, context: dict) -> Trace:
    """A ``Trace`` from the events of ``export_chrome_trace``."""
    launch_ts = {}
    ranges = []
    device = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        args = e.get("args") or {}
        if cat in ("cuda_runtime", "cuda_driver") and "correlation" in args:
            launch_ts[args["correlation"]] = e["ts"]
        elif cat == "user_annotation" and e.get("name") in RANGES:
            ranges.append((e["name"], float(e["ts"]),
                           float(e["ts"]) + float(e["dur"])))
        elif cat in DEVICE_CATS:
            device.append(e)
    ranges.sort(key=lambda r: r[1])
    window = ((ranges[0][1], max(r[2] for r in ranges)) if ranges
              else (0.0, 0.0))
    tr = Trace(ops=[], ranges=ranges, window=window, context=context)
    for e in device:
        host = launch_ts.get((e.get("args") or {}).get("correlation"))
        name = tr.host_range_at(host) if host is not None else None
        tr.ops.append(dict(name=e["name"], cat=e["cat"], ts=float(e["ts"]),
                           dur=float(e["dur"]),
                           range=name if name in RANGES else None))
    return tr


class Profiler:
    """``torch.profiler`` over a sub-window; ``trace()`` reads it once the
    window has closed. The Chrome trace goes to a file in the temporary
    directory only to be read back, and is deleted."""

    def __init__(self):
        self.prof = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()

    def stop(self):
        self.prof.__exit__(None, None, None)

    def trace(self, context: dict) -> Trace:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as fh:
                data = json.load(fh)
        finally:
            os.remove(path)
        events = data["traceEvents"] if isinstance(data, dict) else data
        return read_chrome_trace(events, context)


def ranged(name: str, on: bool):
    """A ``record_function`` range when profiling, else nothing."""
    if not on:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(name)


def short_name(name: str) -> str:
    """A device operation's name without its return type, anonymous
    namespaces and argument list, at most 120 characters."""
    n = name.replace("(anonymous namespace)::", "")
    n = n[5:] if n.startswith("void ") else n
    return (n.split("(")[0] or n)[:120]


def breakdown(tr: Trace) -> dict:
    """The device operations that took most time, and the longest idle
    gaps named by the range the host was in, at most 10 of each."""
    by_name = collections.defaultdict(float)
    for o in tr.ops:
        by_name[short_name(o["name"])] += o["dur"]
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = []
    t0, t1 = tr.window
    prev = t0
    for a, b in tr.busy_intervals() + [[t1, t1]]:
        if a > prev:
            gaps.append((tr.host_range_at((prev + a) / 2), a - prev))
        prev = max(prev, b)
    gaps.sort(key=lambda g: -g[1])
    return {"device_ops": [[n, us / 1e6] for n, us in ops],
            "idle_gaps": [[n, us / 1e6] for n, us in gaps[:10]]}
