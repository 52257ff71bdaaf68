"""The frame glue's plain twins (``render/frame_cuda.py``: ``grid_plain``,
``positions_plain``, ``epilogue_plain``) against what the w-grid frame
computes on its plain route, bit for bit, on the CPU: the grid fields
``_frame_body`` hands the brick sweep (``w_grid`` → ``grid_fields``), the
warp's positions of its pixel rays (``make_rays`` → ``pixel_grid_coords``
→ ``warp_positions``) and its channel stack (the brick sweep's
``RenderOutput`` stacked as ``_frame_body`` stacks it), each from the
geometry ``glue_geometry`` builds from the frame's own arguments. The
poses take the two-pass warp's variants B and A and the single-pass warp
(K8) on the synthetic beetle at scale 0.1. The kernels themselves run
only on the card (``test_torch_frame_glue_cuda.py``)."""

import dataclasses

import numpy as np
import pytest
import torch

from vkvolume_tpu_torch.bench.harness import benchmark_camera, make_engine
from vkvolume_tpu_torch.options import Test
from vkvolume_tpu_torch.render import frame_cuda, sweep_bricks, sweep_frame
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SIZE = 256
# Azimuth (elevation 20) -> the warp its plan takes at SIZE x SIZE.
POSES = {30.0: "B", 50.0: "A", 60.0: "K8"}
GEOMETRY_KEYS = ("p_axis", "sgn_p", "Hi", "Wi", "height", "width", "RECT_A",
                 "warp_variant", "n_slabs")


@pytest.fixture(scope="module")
def engine():
    eng, _, _, _ = make_engine("beetle", 3, 4, scale=0.1, test=Test.NONE,
                               ert=True, device="cpu")
    return eng


@pytest.fixture(scope="module")
def frames(engine):
    """Per pose, what one CPU frame computed on its plain route: the
    ``_frame_body`` keyword arguments, the grid fields handed to the brick
    sweep, K1's outputs, the channel stack and the pixel stage's rays."""
    out = {}
    spied = ((sweep_frame, "_frame_body"), (sweep_bricks, "sweep_bricks"),
             (sweep_bricks, "sweep_bricks_kernel"),
             (sweep_frame, "_pixel_stage"))
    saved = [getattr(mod, name) for mod, name in spied]
    for az in POSES:
        got = {}

        def body(*a, **k):
            got["packed"], got["body"] = a[3], k
            return saved[0](*a, **k)

        def sweep(*a, **k):
            got["grid"] = a[5]
            return saved[1](*a, **k)

        def k1(inp):
            got["k1"] = saved[2](inp)
            return got["k1"]

        def pixel(chans, rays, *a, **k):
            got["chans"], got["rays"] = chans, rays
            return saved[3](chans, rays, *a, **k)

        for (mod, name), fn in zip(spied, (body, sweep, k1, pixel)):
            setattr(mod, name, fn)
        try:
            engine.render(benchmark_camera(1.0, az), SIZE, SIZE)
        finally:
            for (mod, name), fn in zip(spied, saved):
                setattr(mod, name, fn)
        assert engine.last_renderer == "pallas"
        k = got["body"]
        got["geom"] = sweep_frame.glue_geometry(
            got["packed"], **{n: k[n] for n in GEOMETRY_KEYS},
            vol_shape=engine.volumes[0]._sweep_cache[k["p_axis"]].shape)
        out[az] = got
    return out


def _equal(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("az", POSES)
def test_grid_plain_is_the_frames_grid(frames, az):
    f = frames[az]
    assert f["geom"].warp == POSES[az]
    want = f["grid"]
    got = frame_cuda.grid_plain(f["geom"], "cpu")
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        _equal(g, w)
    assert got[5].dtype == torch.bool and bool(got[5].any())


@pytest.mark.parametrize("az", POSES)
def test_positions_plain_are_the_frames_positions(frames, az):
    f = frames[az]
    geom = f["geom"]
    gp, hcoef = geom.unpacked()[2:]
    gx, gy = sweep_frame.pixel_grid_coords(f["rays"], gp, geom.p_axis)
    got = frame_cuda.positions_plain(geom, "cpu")
    _equal(got.gx, gx)
    assert bool((gx > -5.0).any())
    if geom.warp == "K8":
        _equal(got.gy, gy)
        assert got.pos1 is None and got.pos2 is None
        return
    assert got.gy is None
    pos1, pos2 = sweep_frame.warp_positions(
        gx, gy, gp, hcoef, Hi=geom.Hi, Wi=geom.Wi, warp_variant=geom.warp)
    _equal(got.pos1, pos1)
    _equal(got.pos2, pos2)


@pytest.mark.parametrize("az", POSES)
def test_epilogue_plain_is_the_frames_stack(frames, az):
    f = frames[az]
    lum, alpha, firsts, _ = f["k1"]
    got = frame_cuda.epilogue_plain(f["geom"], lum, alpha, firsts)
    _equal(got, f["chans"])
    assert bool((got[1] > 0.0).any()) and bool((got[2] > 0.0).any())


def test_cpu_frame_launches_no_glue_kernel(engine):
    before = dict(frame_cuda.LAUNCHES)
    for az in POSES:
        engine.render(benchmark_camera(1.0, az), SIZE, SIZE)
        assert engine.last_renderer == "pallas"
    assert frame_cuda.LAUNCHES == before


def test_kernels_refuse_a_cpu_device(frames):
    geom = frames[50.0]["geom"]
    for launch in (frame_cuda.frame_grid, frame_cuda.frame_positions):
        with pytest.raises(ValueError, match="CUDA"):
            launch(geom, "cpu")
    maps = torch.zeros((geom.Hi, geom.Wi))
    with pytest.raises(ValueError, match="CUDA"):
        frame_cuda.frame_epilogue(geom, maps, maps, maps)


@pytest.mark.parametrize("change,match", [
    (dict(warp="C"), "warp"), (dict(p_axis=3), "p_axis"),
    (dict(sgn=0), "sgn"), (dict(Hi=0), "grid"),
    (dict(packed=np.zeros(5, np.float32)), "packed")])
def test_geometry_refuses_what_the_kernels_cannot_take(frames, change,
                                                       match):
    geom = dataclasses.replace(frames[50.0]["geom"], **change)
    with pytest.raises(ValueError, match=match):
        geom.scalars


def test_launch_scalars_carry_the_pose(frames):
    geom = frames[50.0]["geom"]
    s = geom.scalars
    np.testing.assert_array_equal(np.ctypeslib.as_array(s.s), geom.packed)
    assert (s.Hi, s.Wi, s.row0, s.H, s.W, s.Hp) == (
        geom.Hi, geom.Wi, 0, SIZE, SIZE, 256)
    assert (s.p_axis, s.sgn, s.warp) == (geom.p_axis, geom.sgn, 0)
    assert s.kappa_scale == np.float32(geom.dim_max) / np.float32(
        geom.n_slabs)
