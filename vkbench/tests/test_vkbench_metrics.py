"""Each per-layer reader on a hand-made trace."""

import pytest

from vkbench import roofline, run
from vkbench.trace import breakdown, read_chrome_trace


def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def _trace(context=None):
    """Two frames and one edit: render [0, 100), wait [100, 300), edit
    [300, 340), render [340, 400), wait [400, 600). Device ops: two
    launched in the first render (20 + 30 us), three in the edit (the
    distance kernels 10 + 20 us and an occupancy op 40 us), one in the
    second render (50 us)."""
    ev = [_x("user_annotation", "vkbench.render", 0, 100),
          _x("user_annotation", "vkbench.wait", 100, 200),
          _x("user_annotation", "vkbench.edit", 300, 40),
          _x("user_annotation", "vkbench.render", 340, 60),
          _x("user_annotation", "vkbench.wait", 400, 200),
          _x("user_annotation", "unrelated", 0, 600)]
    launches = [(1, 10, "k_a", 150, 20), (2, 20, "k_b", 170, 30),
                (3, 305, "scan_relax4_kernel", 350, 10),
                (4, 310, "void relax_lines_kernel<3, false>(x)", 360, 20),
                (5, 320, "occupancy_op", 380, 40),
                (6, 350, "k_c", 420, 50)]
    for corr, host_ts, name, ts, dur in launches:
        ev.append(_x("cuda_runtime", "cudaLaunchKernel", host_ts, 5, corr))
        ev.append(_x("kernel", name, ts, dur, corr))
    ev.append({"ph": "f", "cat": "ac2g", "ts": 1})
    ctx = {"render_host_ms": [4.0, 6.0], "map_shape_zyx": (2, 3, 4),
           "skipmode": 3}
    ctx.update(context or {})
    return read_chrome_trace(ev, ctx)


@pytest.mark.parametrize("name, want", [
    ("render_host_ms", 5.0),
    ("frame_launches", 1.5),
    ("frame_kernel_ms", (20 + 30 + 50) / 1e3 / 2),
    ("map_update_ms", (10 + 20 + 40) / 1e3),
    # busy: [150, 200) and [350, 470) inside the window [0, 600).
    ("device_idle_pct", 100.0 * (1 - 170 / 600)),
    ("distance_roofline_pct",
     100.0 * roofline.edit_bound_ms((2, 3, 4), 3) / 0.030),
])
def test_reader(name, want):
    assert run.load_metric(name).read(_trace()) == pytest.approx(want)


@pytest.mark.parametrize("name", ["map_update_ms", "distance_roofline_pct",
                                  "frame_launches", "frame_kernel_ms",
                                  "device_idle_pct", "render_host_ms"])
def test_reader_finds_nothing(name):
    """A trace with nothing to read gives no value, never 0."""
    empty = read_chrome_trace([], {"render_host_ms": [],
                                   "map_shape_zyx": (2, 3, 4),
                                   "skipmode": 3})
    assert run.load_metric(name).read(empty) is None


def test_roofline_none_without_distance_map():
    assert run.load_metric("distance_roofline_pct").read(
        _trace({"skipmode": 1})) is None


def test_roofline_of_beetle_map():
    """K3 + K4 at the beetle's map: both bound by bytes, (1 + 4) + (4 + 8)
    bytes a cell over 3.35 TB/s."""
    cells = 124 * 208 * 208
    assert roofline.edit_bound_ms((124, 208, 208), 3) == pytest.approx(
        17 * cells / 3.35e12 * 1e3)


def test_breakdown():
    b = breakdown(_trace())
    assert b["device_ops"][0] == ["k_c", pytest.approx(50e-6)]
    assert len(b["device_ops"]) == 6
    # Gaps: [0, 150) under render/wait, [200, 350), [470, 600).
    gaps = b["idle_gaps"]
    assert [g[1] for g in gaps] == pytest.approx([150e-6, 150e-6,
                                                  130e-6])
    assert {g[0] for g in gaps} <= {"vkbench.render", "vkbench.wait",
                                    "vkbench.edit"}
