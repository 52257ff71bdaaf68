"""The port's spans (``utils/timing.py``: ``span``, ``kernel``): named
``record_function`` ranges on the frame and TF-edit paths while a torch
profiler records, nothing otherwise. On the CPU (plain versions; no
kernel launches, so no ``vkv.kernel.*`` span here — the benchmark's
``cuda`` tests hold those on the card)."""

import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vkvolume_tpu_torch.bench.harness import benchmark_camera, make_engine
from vkvolume_tpu_torch.utils import timing
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

W = H = 128

FRAME = ["vkv.frame.rays", "vkv.frame.grid_fields", "vkv.frame.brick_inputs",
         "vkv.frame.epilogue", "vkv.frame.warp", "vkv.frame.pixels"]


def _engine(**kw):
    kw.setdefault("benchmark_mode", False)
    eng, _, _, _ = make_engine("beetle", 2, 4, scale=0.05, device="cpu",
                               **kw)
    return eng


def _edit(eng):
    vol = eng.volumes[0]
    vol.options.intensity_min += 0.01
    eng.update_transfer_function(vol)


def _tree(prof) -> list:
    """The ``vkv.*`` spans as (name, [child names]) in start order, each
    child the span's nearest ``vkv.*`` descendant."""
    spans = sorted((e for e in prof.events() if e.name.startswith("vkv.")),
                   key=lambda e: e.time_range.start)
    children = {id(e): [] for e in spans}
    roots = []
    for e in spans:
        parent = e.cpu_parent
        while parent is not None and not parent.name.startswith("vkv."):
            parent = parent.cpu_parent
        if parent is None:
            roots.append(e)
        else:
            children[id(parent)].append(e.name)
    return [(e.name, children[id(e)]) for e in roots]


def _raise(name):
    raise AssertionError(f"record_function({name!r}) with no profiler")


def test_spans_off_enter_no_record_function(monkeypatch):
    """With no profiler recording, an edit and two frames (a new pose,
    then the same) never call ``record_function``; ``kernel`` still
    counts."""
    eng = _engine()
    monkeypatch.setattr(timing, "record_function", _raise)
    _edit(eng)
    cam = benchmark_camera(1.0, azimuth=35.0)
    eng.render(cam, W, H)
    eng.render(cam, W, H)
    assert eng.last_renderer == "pallas"
    assert timing.span("vkv.a") is timing.span("vkv.b")
    table = {"k": 0}
    with timing.kernel(table, "k"):
        pass
    assert table == {"k": 1}


def test_kernel_span_under_profiler():
    table = {"k": 3}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timing.kernel(table, "k"):
            torch.ones(4).sum()
    assert table == {"k": 4}
    assert [e.name for e in prof.events()
            if e.name.startswith("vkv.")] == ["vkv.kernel.k"]


def test_edit_and_frame_spans_nest():
    """An edit, a frame at a new pose (plan and stitched skip map), then
    the same pose again (both cached), under one profiler."""
    eng = _engine()
    eng.render(benchmark_camera(1.0), W, H)     # the volume's transposes
    cam = benchmark_camera(1.0, azimuth=35.0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _edit(eng)
        eng.render(cam, W, H)
        eng.render(cam, W, H)
    assert eng.last_renderer == "pallas"
    assert _tree(prof) == [
        ("vkv.tf_update", ["vkv.tf_update.bake", "vkv.tf_update.occupancy",
                           "vkv.tf_update.distance"]),
        ("vkv.render", ["vkv.render.plan", "vkv.render.skip_map"] + FRAME),
        ("vkv.render", FRAME),
    ]


def test_benchmark_mode_edit_spans():
    """Benchmark mode counts the occupied voxels, then builds the maps
    once warm and 4 x ``timed_runs`` times."""
    eng = _engine(benchmark_mode=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.update_transfer_function(eng.volumes[0], timed_runs=1)
    (name, kids), = _tree(prof)
    assert name == "vkv.tf_update"
    assert kids == (["vkv.tf_update.bake", "vkv.tf_update.count"]
                    + ["vkv.tf_update.occupancy",
                       "vkv.tf_update.distance"] * 5)


@pytest.mark.parametrize("renderer, edge_repair, want", [
    ("marcher", False, ["vkv.render.march"]),
    ("sweep", False, ["vkv.render.sweep_xla"]),
    ("pallas", True, FRAME + ["vkv.render.edge_repair"]),
])
def test_other_routes_one_span_each(renderer, edge_repair, want):
    eng = _engine(renderer=renderer)
    eng.options.edge_repair = edge_repair
    eng.render(benchmark_camera(1.0), W, H)     # plan and maps cached
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.render(benchmark_camera(1.0), W, H)
    assert _tree(prof) == [("vkv.render", want)]


def test_load_times_its_map_build_to_a_synchronise(monkeypatch):
    """Outside benchmark mode ``add_volume``'s ``map_update_ms`` ends at a
    synchronise (the CLI's "Updated occupancy/distance map" line), not
    when the build is queued."""
    from vkvolume_tpu_torch.engine import engine as engine_mod

    calls = []

    def slow_sync(self):
        calls.append(time.perf_counter())
        time.sleep(0.05)

    monkeypatch.setattr(engine_mod.Engine, "_sync", slow_sync)
    eng, stats, _, _ = make_engine("beetle", 2, 4, scale=0.05, device="cpu",
                                   benchmark_mode=False)
    assert calls and stats.map_update_ms >= 50.0
    _edit(eng)          # an interactive edit stays queued: no synchronise
    assert len(calls) == 2      # the gradient map's and the maps'
