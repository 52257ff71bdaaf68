"""The program's spans in a traced run (``spans.py``) and the readers that
read them, on a hand-made trace; on the card, a wait planted in a frame."""

import pytest

from vkbench import run, spans
from vkbench import trace as trace_mod
from vkbench.trace import read_chrome_trace

NEW = ("frame_syncs", "render_wait_ms", "glue_launches", "port_kernel_ms",
       "occupancy_ms")
OLD = ("render_host_ms", "frame_launches", "frame_kernel_ms",
       "device_idle_pct", "map_update_ms", "distance_roofline_pct")
CTX = {"render_host_ms": [4.0, 6.0], "map_shape_zyx": (2, 3, 4),
       "skipmode": 3}


def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def _events(program=True) -> list:
    """A lead frame, two frames and one edit between them: lead render
    [-200, -150) with a wait and a launch of its own; render [0, 100),
    wait [100, 300), edit [300, 340), render [340, 400), wait [400, 600).
    ``program``: with the program's spans and the runtime's waits, else
    only what a tree without spans shows."""
    ua = "user_annotation"
    ev = [_x(ua, "vkbench.lead.render", -200, 50),
          _x(ua, "vkbench.render", 0, 100),
          _x(ua, "vkbench.wait", 100, 200),
          _x(ua, "vkbench.edit", 300, 40),
          _x(ua, "vkbench.render", 340, 60),
          _x(ua, "vkbench.wait", 400, 200)]
    if program:
        ev += [_x(ua, "vkv.render", -195, 40),
               _x(ua, "vkv.render", 2, 96),
               _x(ua, "vkv.frame.rays", 5, 10),
               _x(ua, "vkv.kernel.brick_walk", 20, 10),
               _x(ua, "vkv.frame.warp", 35, 35),
               _x(ua, "vkv.tf_update", 301, 38),
               _x(ua, "vkv.tf_update.occupancy", 302, 6),
               _x(ua, "vkv.tf_update.distance", 309, 21),
               _x(ua, "vkv.kernel.scan_and_relax_multi", 310, 5),
               _x(ua, "vkv.kernel.relax_z_direct_multi", 316, 4),
               _x(ua, "vkv.render", 341, 58),
               _x(ua, "vkv.render.skip_map", 342, 7),
               _x(ua, "vkv.kernel.resample_rows", 350, 10),
               _x(ua, "vkv.frame.pixels", 370, 25)]
        rt = "cuda_runtime"
        ev += [_x(rt, "cudaStreamSynchronize", -180, 10),     # lead
               _x(rt, "cudaStreamSynchronize", 40, 20),       # frame 1
               _x(rt, "cudaMemcpy", 75, 5),
               _x(rt, "cudaDeviceSynchronize", 110, 180),     # harness
               _x(rt, "cudaStreamSynchronize", 380, 10)]      # frame 2
    # (correlation, host ts, runtime call, device cat, name, ts, dur)
    launches = [(1, -190, "cudaLaunchKernel", "kernel", "k_lead", -170, 5),
                (2, 10, "cudaLaunchKernel", "kernel", "k_a", 100, 20),
                (3, 25, "cudaLaunchKernel", "kernel", "brick_walk_kernel",
                 120, 30),
                (4, 305, "cudaLaunchKernel", "kernel", "occupancy_op", 380,
                 40),
                (5, 312, "cudaLaunchKernel", "kernel", "scan_relax4_kernel",
                 350, 10),
                (6, 318, "cudaLaunchKernel", "kernel",
                 "void relax_lines_kernel<3, false>(x)", 360, 20),
                (7, 345, "cudaLaunchKernel", "kernel", "k_stitch", 420, 5),
                (8, 355, "cudaLaunchKernel", "kernel", "resample_pass", 425,
                 50),
                (9, 372, "cudaMemcpyAsync", "gpu_memcpy", "Memcpy HtoD",
                 475, 5)]
    for corr, host_ts, call, cat, name, ts, dur in launches:
        ev.append(_x("cuda_runtime", call, host_ts, 2, corr))
        ev.append(_x(cat, name, ts, dur, corr))
    return ev


def _trace(program=True):
    ev = _events(program)
    tr = read_chrome_trace(ev, dict(CTX))
    spans.attach(tr, ev)
    return tr


@pytest.mark.parametrize("name, want", [
    # waits in vkv.render: 20 + 5 us in frame 1, 10 us in frame 2
    ("frame_syncs", 3 / 2),
    ("render_wait_ms", (20 + 5 + 10) / 1e3 / 2),
    # k_a; then the stitch and the copy
    ("glue_launches", 3 / 2),
    # brick_walk_kernel, resample_pass
    ("port_kernel_ms", (30 + 50) / 1e3 / 2),
    ("occupancy_ms", 40 / 1e3),
])
def test_reader(name, want):
    assert run.load_metric(name).read(_trace()) == pytest.approx(want)


@pytest.mark.parametrize("name", NEW)
def test_reader_without_program_spans(name):
    """A tree without spans (the parent of this benchmark's spans), a CPU
    run (no device operation) and a trace of another profiler give
    nothing."""
    assert run.load_metric(name).read(_trace(program=False)) is None
    cpu = [e for e in _events() if e["cat"] in ("user_annotation",
                                                "cuda_runtime")]
    tr = read_chrome_trace(cpu, dict(CTX))
    spans.attach(tr, cpu)
    assert run.load_metric(name).read(tr) is None
    other = [dict(e, dur=e["dur"] + 1) if e["name"] == "vkbench.edit" else e
             for e in _events()]
    tr = read_chrome_trace(_events(), dict(CTX))
    spans.attach(tr, other)
    assert run.load_metric(name).read(tr) is None


@pytest.mark.parametrize("name", OLD)
def test_old_readers_unchanged_by_program_spans(name):
    read = run.load_metric(name).read
    assert read(_trace()) == read(_trace(program=False))
    assert read(_trace()) is not None


def test_chain_and_window():
    p = spans.view(_trace())
    assert p.frames == 2 and p.edits == 1
    assert p.count("vkv.render") == 2            # not the lead's
    by_name = {o["name"]: o["chain"] for o in p.ops}
    assert by_name["k_lead"] == ()
    assert by_name["brick_walk_kernel"] == ("vkv.render",
                                            "vkv.kernel.brick_walk")
    assert by_name["scan_relax4_kernel"] == (
        "vkv.tf_update", "vkv.tf_update.distance",
        "vkv.kernel.scan_and_relax_multi")
    assert by_name["Memcpy HtoD"] == ("vkv.render", "vkv.frame.pixels")
    assert [w["chain"][-1] for w in p.waits if w["chain"]] == [
        "vkv.frame.warp", "vkv.render", "vkv.frame.pixels"]


def test_breakdown_names_gaps_by_program_span():
    """Busy [100, 150) and [350, 480) in [0, 600): the gap [0, 100) has
    its midpoint in ``vkv.frame.warp``; the others lie in
    ``vkbench.wait``, outside every program span."""
    b = spans.breakdown(_trace())
    assert b["idle_gaps"] == [["vkbench.wait", pytest.approx(200e-6)],
                              ["vkbench.wait", pytest.approx(120e-6)],
                              ["vkv.frame.warp", pytest.approx(100e-6)]]
    assert b["device_ops"] == trace_mod.breakdown(_trace())["device_ops"]
    rows = {r[0]: r[1:] for r in b["spans"]}
    assert rows["vkv.render"] == [2, pytest.approx(154e-6),
                                  pytest.approx(0.0), 0,
                                  pytest.approx(5e-6)]
    assert rows["vkv.tf_update.occupancy"][1:4] == [
        pytest.approx(6e-6), pytest.approx(40e-6), 1]
    # Without program spans, the harness's breakdown as it is.
    assert spans.breakdown(_trace(program=False)) == trace_mod.breakdown(
        _trace(program=False))


def test_view_finds_the_live_profiler():
    """On the CPU: the run's ``trace.Profiler`` is found among the live
    objects and its events read; with no device operation, nothing."""
    import torch

    from vkvolume_tpu_torch.utils import timing

    prof = trace_mod.Profiler()
    prof.start()
    with trace_mod.ranged("vkbench.render", True):
        with timing.span("vkv.render"):
            torch.ones(8).sum()
    prof.stop()
    tr = prof.trace(dict(CTX))
    assert tr.count("vkbench.render") == 1
    assert spans.view(tr) is None and tr._program is None
    events = spans._events(prof.prof, tr)
    names = [e["name"] for e in events if e["cat"] == "user_annotation"]
    assert names == ["vkbench.render", "vkv.render"]
    tr.ops.append(dict(name="k", cat="kernel", ts=0.0, dur=1.0, range=None))
    assert spans.read_events(events + [_x("kernel", "k", 0, 1)],
                             tr).count("vkv.render") == 1


@pytest.mark.cuda
def test_planted_wait_counts_once(cuda_device, monkeypatch):
    """On the card: a ``torch.cuda.synchronize()`` planted in each frame's
    pixel stage (inside ``vkv.render``) raises ``frame_syncs`` by exactly
    1; the frame's launches split into glue and the port's kernels."""
    import torch

    from vkvolume_tpu_torch.bench.harness import (benchmark_camera,
                                                  make_engine)
    from vkvolume_tpu_torch.render import sweep_frame

    eng, _, _, _ = make_engine("beetle", 2, 4, scale=0.25, device="cuda",
                               benchmark_mode=False)
    cam = benchmark_camera(1.0)

    def window():
        eng.render(cam, 256, 256)
        torch.cuda.synchronize()
        prof = trace_mod.Profiler()
        prof.start()
        for _ in range(3):
            with trace_mod.ranged("vkbench.render", True):
                eng.render(cam, 256, 256)
            with trace_mod.ranged("vkbench.wait", True):
                torch.cuda.synchronize()
        prof.stop()
        tr = prof.trace(dict(CTX))
        got = {m: run.load_metric(m).read(tr)
               for m in NEW[:4] + ("frame_launches", "frame_kernel_ms")}
        p = spans.view(tr)
        got["kernels"] = len(p.ops_under("vkv.render", kernel=True)) / 3
        return got

    plain = window()
    stage = sweep_frame._pixel_stage

    def planted(*a, **k):
        torch.cuda.synchronize()
        return stage(*a, **k)

    monkeypatch.setattr(sweep_frame, "_pixel_stage", planted)
    more = window()
    assert eng.last_renderer == "pallas"
    print(plain, more)
    assert more["frame_syncs"] == plain["frame_syncs"] + 1
    assert more["render_wait_ms"] > plain["render_wait_ms"]
    for got in (plain, more):
        assert got["kernels"] == 4             # K1's two, K2 twice
        assert got["glue_launches"] + got["kernels"] == got["frame_launches"]
        assert 0 < got["port_kernel_ms"] < got["frame_kernel_ms"]
