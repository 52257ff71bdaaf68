"""Timing and tracing helpers — port of ``vkvolume_tpu/utils/timing.py``.

The reference's observability is std::chrono around fenced submits plus
vkb::Stats frame times (src/volume_render.cpp:210-215, 399-430, 249-251);
here it is CUDA events around queued work on the card, the host clock on
the CPU, and ``torch.profiler`` traces.

The frame and TF-edit paths open named spans (``span``, ``kernel``):
``record_function`` ranges while a torch profiler records, so they land
in its trace on the clock of the device operations they launch, and a
shared null context otherwise. Names start with ``vkv.`` (``README.md``,
"Tracing a session").
"""

from __future__ import annotations

import contextlib
import os
import statistics
import time

import torch
from torch.autograd.profiler import record_function

KERNEL_SPAN = "vkv.kernel."
_NULL = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled


def span(name: str):
    """A ``record_function(name)`` range while a torch profiler records,
    else one shared null context (no string built, nothing allocated)."""
    return record_function(name) if _profiling() else _NULL


def kernel(table: dict, key: str):
    """One launch of the port's kernel ``key``: counts it in ``table``
    (its module's ``LAUNCHES``) and returns the span ``vkv.kernel.<key>``
    to open around the launch."""
    table[key] += 1
    return record_function(KERNEL_SPAN + key) if _profiling() else _NULL


def rep_ms(fn, reps: int, inner: int, device, warmup: int = 1):
    """Per repetition, milliseconds per call of ``fn`` over ``inner``
    queued calls ended by one synchronise. Returns (card ms, host ms): on a
    CUDA device the card's ms come from events bracketing the calls, and
    the host ms are the host clock around the same calls and synchronise;
    on the CPU the card's list is None."""
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    for _ in range(warmup):
        fn()
    sync()
    card, host = [], []
    for _ in range(reps):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        if cuda:
            start.record()
        for _ in range(inner):
            fn()
        if cuda:
            end.record()
        sync()
        host.append((time.perf_counter() - t0) * 1e3 / inner)
        if cuda:
            card.append(start.elapsed_time(end) / inner)
    return (card if cuda else None), host


def time_jitted(fn, *args, warmup: int = 1, iters: int = 10,
                device="cuda", **kwargs) -> float:
    """Median seconds of one call of ``fn(*args, **kwargs)`` on ``device``,
    each call timed alone and synchronised (CUDA events on the card, the
    host clock on the CPU)."""
    card, host = rep_ms(lambda: fn(*args, **kwargs), iters, 1, device,
                        warmup)
    return statistics.median(card if card is not None else host) / 1e3


@contextlib.contextmanager
def profiler_trace(log_dir: str | None):
    """A ``torch.profiler`` trace of the block (the host, and the card when
    there is one) written as a Chrome trace to ``log_dir/trace.json``;
    nothing when ``log_dir`` is None."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
