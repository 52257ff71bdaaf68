"""The routes of this slice through the whole frame: the port's Engine
(``device="cpu"``: the kernels' plain versions) against the JAX package's
Engine with its Pallas frame in interpret mode, on the same volume, TF and
camera. Each view plans another route:

* the brick sweep (K1) and the single-pass warp (K8);
* the brick sweep and the gather warp of a ``warp_xla`` plan;
* the per-slab sweep (K7, ``--sampling 0.5`` with an intensity-only TF:
  fewer slabs than voxel planes) and K8;
* the benchmark orbit (``--benchmark 2 --orbit 10``): the gather warp,
  then K8 with the sample-count channel (four channels);
* a plan with a 512-lane brick rect and fewer slabs than voxel planes,
  which the engine narrows to a 256-lane re-plan (K7, gather warp).

The synthetic beetle is at scale 0.1; the narrowed view needs a volume at
least 384 voxels wide along u (an ellipsoid shell, 32 x 64 x 512). The
plans must match field for field, the routes and ``renderer_counts`` must
be the JAX engine's, and the images agree within 2e-3 on >= 99.9 % of the
pixels (the JAX interpret frames sum the tent in another order, the port
warps two-pass frames u16-encoded) and within 1e-4 in mean alpha."""

import contextlib
import functools
import io

import numpy as np
import pytest

from vkvolume_tpu import cli as jcli
from vkvolume_tpu import utils as jutils
from vkvolume_tpu.bench.harness import benchmark_camera as j_bench_camera
from vkvolume_tpu.camera import fit_distance as j_fit_distance
from vkvolume_tpu.camera import orbit_camera as j_orbit_camera
from vkvolume_tpu.engine import Engine as JEngine
from vkvolume_tpu.engine import from_array as j_from_array
from vkvolume_tpu.options import RenderOptions as JRenderOptions
from vkvolume_tpu.options import SkippingType as JSkip
from vkvolume_tpu.options import VolumeOptions as JVolumeOptions
from vkvolume_tpu.render import sweep_pallas
from vkvolume_tpu_torch import cli as tcli
from vkvolume_tpu_torch.engine import Engine as TEngine
from vkvolume_tpu_torch.engine import from_array as t_from_array
from vkvolume_tpu_torch.options import RenderOptions as TRenderOptions
from vkvolume_tpu_torch.options import SkippingType as TSkip
from vkvolume_tpu_torch.options import VolumeOptions as TVolumeOptions
from vkvolume_tpu_torch.render import (sweep_bricks, sweep_frame,
                                       sweep_slabs, warp_cuda)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

BEETLE = ["--synth", "beetle", "--synth-scale", "0.1"]
PLAN_KEYS = ("Hi", "Wi", "R_sweep", "R_warp", "R_brick", "tile_h", "rect_w",
             "RECT_A", "warp_variant", "sgn_p")


@pytest.fixture
def jax_interpret(monkeypatch):
    """The JAX engine's Pallas frame in interpret mode (on the CPU it would
    otherwise take the XLA sweep), without its persistent compile cache."""
    monkeypatch.setattr(jutils, "enable_compile_cache", lambda *a, **k: None)
    monkeypatch.setattr(sweep_pallas, "_frame_jit", functools.partial(
        sweep_pallas._frame_jit, interpret=True))


@pytest.fixture
def routes(monkeypatch):
    """Which sweep and which warp each port frame took: the wrappers' calls,
    recorded in order."""
    calls = []

    def spy(mod, name, tag):
        fn = getattr(mod, name)

        def wrapped(*a, **k):
            calls.append(tag)
            return fn(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)

    spy(sweep_bricks, "sweep_bricks_kernel", "K1")
    spy(sweep_slabs, "sweep_slabs_kernel", "K7")
    spy(warp_cuda, "resample_rows", "K2")
    spy(warp_cuda, "warp_to_pixels", "K8")
    spy(warp_cuda, "warp_to_pixels_plain", "plain warp")
    return calls


def _frames(calls):
    """The recorded calls split into frames (each starts with its sweep)."""
    out = []
    for c in calls:
        if c in ("K1", "K7"):
            out.append([])
        out[-1].append(c)
    return out


def _route(calls):
    """(sweep, warp) of one frame's recorded calls."""
    sweep = [c for c in calls if c in ("K1", "K7")]
    assert len(sweep) == 1, calls
    if "K2" in calls:
        warp = "K2"
    elif "K8" in calls:
        warp = "K8"                  # runs its plain version on the CPU
    else:
        warp = "gather"
        assert calls.count("plain warp") == 1, calls
    return sweep[0], warp


def _poses(engine):
    return [p for k, p in engine.volumes[0]._sweep_cache.items()
            if isinstance(k, tuple) and k[0] == "pose"]


def _plan_fields(plan):
    return {k: plan.get(k) for k in PLAN_KEYS} | {
        "warp_xla": bool(plan.get("warp_xla"))}


def _compare_frames(got, want):
    got = got.color.numpy()
    want = np.asarray(want.color)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert (want[..., 3] > 0).mean() > 0.02          # real content
    bad = (np.abs(got - want).max(axis=-1) > 2e-3).mean()
    assert bad <= 1e-3, bad
    assert abs(got[..., 3].mean() - want[..., 3].mean()) <= 1e-4


def _cli_engines(args):
    """The port's and the JAX package's CLI set-ups of ``args``, volumes
    added (the JAX one with the jax_interpret fixture active)."""
    teng, tvols = tcli.setup_engine(tcli.build_parser().parse_args(
        args + ["--device", "cpu"]))
    jeng, jvols = jcli.setup_engine(jcli.build_parser().parse_args(args))
    for t, j in zip(tvols, jvols):
        teng.add_volume(t)
        jeng.add_volume(j)
    return teng, jeng


def _cli_camera(w, h, az):
    aspect = w / h
    return j_orbit_camera(
        radius=j_fit_distance(50.0, np.deg2rad(60.0), aspect) * 1.3,
        azimuth_deg=az, elevation_deg=20.0, aspect=aspect)


# (extra CLI flags, width, height, azimuth of the CLI's still camera,
#  expected (sweep, warp)).
CLI_VIEWS = [
    ([], 384, 256, 30.0, ("K1", "K8")),
    ([], 256, 256, 30.0, ("K1", "gather")),
    (["--sampling", "0.5", "--gmax", "0"], 384, 256, 30.0, ("K7", "K8")),
]


@pytest.mark.parametrize("flags,w,h,az,route", CLI_VIEWS)
def test_cli_view_matches_jax_engine(jax_interpret, routes, flags, w, h, az,
                                     route):
    teng, jeng = _cli_engines(BEETLE + ["--width", str(w), "--height",
                                        str(h)] + flags)
    cam = _cli_camera(w, h, az)
    jout = jeng.render(cam, w, h)
    assert jeng.last_renderer == "pallas"
    tout = teng.render(cam, w, h)
    assert _route(routes) == route
    assert teng.last_renderer == "pallas"
    (tpose,), (jpose,) = _poses(teng), _poses(jeng)
    assert _plan_fields(tpose["plan"]) == _plan_fields(jpose["plan"])
    assert teng.renderer_counts == jeng.renderer_counts
    assert teng.renderer_counts.get("pallas_xla_warp", 0) == (
        route[1] == "gather")
    _compare_frames(tout, jout)


def test_benchmark_orbit_matches_jax_engine(jax_interpret, routes):
    """``--benchmark 2 --orbit 10`` from azimuth 50 at 256x128: a warm frame
    and azimuth 50 take the gather warp, azimuth 60 K8 with four channels
    (the sample count: ERT off, clip distance 1)."""
    args = BEETLE + ["--width", "256", "--height", "128", "--benchmark", "2",
                     "--azimuth", "50", "--orbit", "10"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        teng, _, tout = tcli.run(args + ["--device", "cpu"])
    assert "ran 2 frames, averaged " in buf.getvalue()
    assert [_route(f) for f in _frames(routes)] == [
        ("K1", "gather"), ("K1", "gather"), ("K1", "K8")]
    assert teng.renderer_counts == {"pallas": 3, "sweep": 0, "marcher": 0,
                                    "pallas_xla_warp": 2}
    jeng, jvols = jcli.setup_engine(jcli.build_parser().parse_args(args))
    jeng.add_volume(jvols[0])
    for az in (50.0, 60.0):
        jout = jeng.render(j_bench_camera(2.0, az, 20.0), 256, 128)
    assert jeng.renderer_counts["pallas_xla_warp"] == 1
    tplans = sorted((_plan_fields(p["plan"]) for p in _poses(teng)), key=str)
    jplans = sorted((_plan_fields(p["plan"]) for p in _poses(jeng)), key=str)
    assert tplans == jplans
    _compare_frames(tout, jout)
    np.testing.assert_array_equal(tout.num_volume_samples.numpy(),
                                  np.asarray(jout.num_volume_samples))


def _shell(shape, seed=0):
    """An ellipsoid shell filling the box, with a little noise (u8)."""
    rng = np.random.default_rng(seed)
    zz, yy, xx = np.meshgrid(*(np.linspace(-1.0, 1.0, n) for n in shape),
                             indexing="ij")
    r = np.sqrt(zz ** 2 + yy ** 2 + xx ** 2)
    shell = np.clip(1.0 - np.abs(r - 0.8) / 0.12, 0.0, 1.0)
    vol = shell * 200.0 + rng.random(shape) * 20.0
    return vol.astype(np.uint8)


def test_narrowed_plan_matches_jax_engine(jax_interpret, routes):
    """A 512-lane brick-rect plan with fewer slabs than voxel planes
    (sampling 0.5): both engines re-plan the view at 256 lanes and sweep it
    per slab (K7), then warp by gather."""
    shape, w, h, az = (32, 64, 512), 256, 128, 20.0
    data = _shell(shape)
    kw = dict(intensity_min=0.1, gradient_min=0.0, gradient_max=0.0,
              sampling_factor=0.5)
    jeng = JEngine(JRenderOptions(skipping_type=JSkip.DISTANCE),
                   renderer="pallas")
    jv = j_from_array(data, JVolumeOptions(**kw), block_size=4)
    teng = TEngine(TRenderOptions(skipping_type=TSkip.DISTANCE),
                   device="cpu")
    tv = t_from_array(data, TVolumeOptions(**kw), block_size=4, device="cpu")
    for v in (jv, tv):
        # The CLI's fit to the viewport.
        lin = np.asarray(v.image_transform, np.float64)[:3, :3]
        v.set_scale(tuple(100.0 / np.linalg.norm(lin, axis=0)))
    jeng.add_volume(jv)
    teng.add_volume(tv)
    cam = _cli_camera(w, h, az)
    jout = jeng.render(cam, w, h)
    tout = teng.render(cam, w, h)
    assert _route(routes) == ("K7", "gather")
    (tpose,), (jpose,) = _poses(teng), _poses(jeng)
    assert tpose["plan"]["rect_w"] == jpose["plan"]["rect_w"] == 512
    assert _plan_fields(tpose["plan"]) == _plan_fields(jpose["plan"])
    narrow = tpose["plan_narrow"]
    assert narrow["rect_w"] == 256 and narrow.get("warp_xla")
    assert _plan_fields(narrow) == _plan_fields(jpose["plan_narrow"])
    assert teng.renderer_counts == jeng.renderer_counts
    assert teng.renderer_counts["pallas_xla_warp"] == 1
    _compare_frames(tout, jout)


def test_full_scale_narrow_replan_matches_jax_planner():
    """The CLI's ``--azimuth 80 --sampling 0.25`` on the full-scale beetle
    (494 x 832 x 832): the view plans a 384-lane rect, and the 256-lane
    re-plan (Hi 832, Wi 2560, R_sweep 32, R_warp 192, no RECT_A: K7 + K8)
    is the JAX planner's. Host planning only: no volume data."""
    from vkvolume_tpu.render import ray_setup as jrs
    from vkvolume_tpu_torch.accel.occupancy import effective_block_size
    from vkvolume_tpu_torch.render import ray_setup as trs
    from vkvolume_tpu_torch.utils import math3d

    dsh = (494, 832, 832)
    shape_for = lambda q: {2: dsh, 1: (dsh[1], dsh[0], dsh[2]),
                           0: (dsh[2], dsh[0], dsh[1])}[q]
    # from_array's image transform and the CLI's fit to the viewport.
    extent = np.asarray([832.0, 832.0, 494.0])
    image = math3d.scale(extent)
    node = math3d.scale(tuple(100.0 / extent))
    cam = _cli_camera(1280, 720, 80.0)
    bs = np.asarray(effective_block_size((832, 832, 494), (208, 208, 124)),
                    np.float32)
    ju = jrs.make_uniforms(cam, node, image, 50.0, bs)
    tu = trs.make_uniforms(cam, node, image, 50.0, bs)
    jview, jplan = sweep_pallas.select_view_plan(ju, 720, 1280, shape_for)
    tview, tplan = sweep_frame.select_view_plan(tu, 720, 1280, shape_for)
    assert _plan_fields(tplan) == _plan_fields(jplan)
    p = tview["p_axis"]
    assert tplan["rect_w"] > 256
    jn = sweep_pallas.plan_from_stats(jview, ju, p, shape_for(p), 720, 1280,
                                      max_rect=256)
    tn = sweep_frame.plan_from_stats(tview, tu, p, shape_for(p), 720, 1280,
                                     max_rect=256)
    assert _plan_fields(tn) == _plan_fields(jn)
    assert (tn["Hi"], tn["Wi"], tn["R_sweep"], tn["R_warp"], tn["RECT_A"]) \
        == (832, 2560, 32, 192, None)
