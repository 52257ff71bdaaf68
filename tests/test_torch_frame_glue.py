"""The frame glue's functions (``render/sweep_frame.py``: ``frame_grid``,
``frame_positions``, ``frame_epilogue``) on CPU tensors against their
building blocks and against what the w-grid frame computed, bit for bit:
the grid fields K1 reads (``w_grid`` → ``grid_fields``), the warp's
positions of the image's pixel rays (``make_rays`` →
``pixel_grid_coords`` → ``warp_positions``) and the channel stack (K1's
lum and alpha, ``first_hit_depth``), each from the geometry the frame
built. The poses take the two-pass warp's variants B and A and the
single-pass warp (K8) on the synthetic beetle at scale 0.1. Also: the raw
launchers (``render/frame_cuda.py``) refuse the CPU, what their launch
scalars carry, the module's imports, and the one test for the brick sweep
(``brick_route``) against the tests it replaced. The kernels themselves
run only on the card (``test_torch_frame_glue_cuda.py``)."""

import ast
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from vkvolume_tpu_torch.accel.occupancy import effective_block_size
from vkvolume_tpu_torch.bench.harness import benchmark_camera, make_engine
from vkvolume_tpu_torch.camera import fit_distance, orbit_camera
from vkvolume_tpu_torch.options import Test
from vkvolume_tpu_torch.render import (frame_cuda, ray_setup, sweep_bricks,
                                       sweep_frame)
from vkvolume_tpu_torch.utils import math3d
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SIZE = 256
# Azimuth (elevation 20) -> the warp its plan takes at SIZE x SIZE.
POSES = {30.0: "B", 50.0: "A", 60.0: "K8"}


@pytest.fixture(scope="module")
def engine():
    eng, _, _, _ = make_engine("beetle", 3, 4, scale=0.1, test=Test.NONE,
                               ert=True, device="cpu")
    return eng


@pytest.fixture(scope="module")
def frames(engine):
    """Per pose, what one CPU frame computed: the glue's geometry, K1's
    inputs and outputs, the channel stack and the warp's positions."""
    out = {}
    spied = ((sweep_frame, "frame_epilogue"),
             (sweep_bricks, "sweep_bricks_kernel"),
             (sweep_frame, "_pixel_stage"))
    saved = [getattr(mod, name) for mod, name in spied]
    for az in POSES:
        got = {}

        def epilogue(geom, *maps):
            got["geom"] = geom
            return saved[0](geom, *maps)

        def k1(inp):
            got["inp"], got["k1"] = inp, saved[1](inp)
            return got["k1"]

        def pixel(chans, positions, *a, **k):
            got["chans"], got["positions"] = chans, positions
            return saved[2](chans, positions, *a, **k)

        for (mod, name), fn in zip(spied, (epilogue, k1, pixel)):
            setattr(mod, name, fn)
        try:
            engine.render(benchmark_camera(1.0, az), SIZE, SIZE)
        finally:
            for (mod, name), fn in zip(spied, saved):
                setattr(mod, name, fn)
        assert engine.last_renderer == "pallas"
        out[az] = got
    return out


def _equal(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("az", POSES)
def test_grid_plain_is_the_frames_grid(frames, az):
    """``frame_grid`` on the CPU: ``w_grid`` then ``grid_fields``, and the
    fields K1 read."""
    f = frames[az]
    geom, inp = f["geom"], f["inp"]
    assert geom.warp == POSES[az] and geom.row0 == 0
    u, _, gp, _ = ray_setup.unpack_frame_scalars(geom.packed)
    wu, wv = sweep_frame.w_grid(gp, geom.Hi, geom.Wi, "cpu")
    s_lo, s_hi, cov, kappa = sweep_bricks.grid_fields(
        u, wu, wv, geom.sgn, geom.p_axis, geom.dim_max, geom.n_slabs)
    got = sweep_frame.frame_grid(geom, "cpu")
    assert len(got) == 6
    for g, w, k1 in zip(got, (wu, wv, s_lo, s_hi, kappa, cov),
                        (inp.wu, inp.wv, inp.s_lo, inp.s_hi, inp.kappa,
                         inp.cov)):
        _equal(g, w)
        _equal(g, k1)
    assert got[5].dtype == torch.bool and bool(got[5].any())


@pytest.mark.parametrize("az", POSES)
def test_positions_plain_are_the_frames_positions(frames, az):
    """``frame_positions`` on the CPU: the pose's pixel rays, their grid
    positions and the warp's, and what the frame's warp read."""
    f = frames[az]
    geom = f["geom"]
    u, _, gp, hcoef = ray_setup.unpack_frame_scalars(geom.packed)
    rays = ray_setup.make_rays(u, geom.height, geom.width, "cpu")
    gx, gy = sweep_frame.pixel_grid_coords(rays, gp, geom.p_axis)
    got = sweep_frame.frame_positions(geom, "cpu")
    for g, w in zip(got, f["positions"]):
        assert (g is None) == (w is None)
        if g is not None:
            _equal(g, w)
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
    """``frame_epilogue`` on the CPU: K1's lum and alpha and the first-hit
    depth over the w-grid, and the stack the frame warped."""
    f = frames[az]
    geom = f["geom"]
    lum, alpha, firsts, _ = f["k1"]
    u, pvm, gp, _ = ray_setup.unpack_frame_scalars(geom.packed)
    wu, wv = sweep_frame.w_grid(gp, geom.Hi, geom.Wi, "cpu")
    depth = sweep_bricks.first_hit_depth(u, pvm, geom.p_axis, wu, wv, alpha,
                                         firsts)
    got = sweep_frame.frame_epilogue(geom, lum, alpha, firsts)
    _equal(got, torch.stack([lum, alpha, depth]))
    _equal(got, f["chans"])
    assert bool((got[1] > 0.0).any()) and bool((got[2] > 0.0).any())


def test_cpu_frame_launches_no_glue_kernel(engine):
    before = dict(frame_cuda.LAUNCHES)
    for az in POSES:
        engine.render(benchmark_camera(1.0, az), SIZE, SIZE)
        assert engine.last_renderer == "pallas"
    assert frame_cuda.LAUNCHES == before


def test_kernels_refuse_a_cpu_device(frames):
    """The raw launchers raise on the CPU; the frame's functions of the
    same names run the plain versions there."""
    f = frames[50.0]
    geom = f["geom"]
    for launch in (frame_cuda.frame_grid, frame_cuda.frame_positions):
        with pytest.raises(ValueError, match="CUDA"):
            launch(geom, "cpu")
    maps = torch.zeros((geom.Hi, geom.Wi))
    with pytest.raises(ValueError, match="CUDA"):
        frame_cuda.frame_epilogue(geom, maps, maps, maps)
    for g, w in zip(sweep_frame.frame_grid(geom, "cpu"),
                    sweep_frame.grid_plain(geom, "cpu")):
        _equal(g, w)
    for g, w in zip(sweep_frame.frame_positions(geom, "cpu"),
                    sweep_frame.positions_plain(geom, "cpu")):
        assert (g is None) == (w is None)
        if g is not None:
            _equal(g, w)
    lum, alpha, firsts, _ = f["k1"]
    _equal(sweep_frame.frame_epilogue(geom, lum, alpha, firsts),
           sweep_frame.epilogue_plain(geom, lum, alpha, firsts))


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


def test_frame_cuda_imports_neither_sweep_module():
    """The launchers' module sits below the frame: it imports neither
    ``sweep_frame`` nor ``sweep_bricks`` (no import cycle in render/)."""
    src = pathlib.Path(frame_cuda.__file__).read_text()
    names = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.ImportFrom):
            names.add(node.module or "")
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
    assert names, "no imports found"
    assert not {n for n in names
                if n.split(".")[-1] in ("sweep_frame", "sweep_bricks")}


# (the volume's (z, y, x) shape, image sizes): the full-scale beetle and
# kingsnake, the beetle at scale 0.1 (some views plan no brick rect) and a
# 32 x 64 x 512 shell (512-lane rects).
PLANNED = (((494, 832, 832), ((1280, 720), (1200, 1200))),
           ((795, 1024, 1024), ((1280, 720), (1200, 1200))),
           ((49, 83, 83), ((256, 256), (384, 256))),
           ((32, 64, 512), ((256, 128),)))


def _planner_plans():
    """The planner's plans of orbits round the ``PLANNED`` volumes (host
    planning only), each with its voxel planes along its axis."""
    plans = []
    for dsh, sizes in PLANNED:
        shape_for = lambda q, d=dsh: ray_setup.axis_shape(d, q)
        extent = np.asarray(dsh[::-1], np.float64)
        image = math3d.scale(extent)
        node = math3d.scale(tuple(100.0 / extent))
        bs = np.asarray(effective_block_size(
            tuple(int(e) for e in extent),
            tuple(int(e) // 4 for e in extent)), np.float32)
        for w, h in sizes:
            for az in range(0, 180, 20):
                for el in (20.0, 50.0):
                    cam = orbit_camera(
                        radius=fit_distance(50.0, np.deg2rad(60.0), w / h)
                        * 1.3, azimuth_deg=float(az), elevation_deg=el,
                        aspect=w / h)
                    u = ray_setup.make_uniforms(cam, node, image, 50.0, bs)
                    view, plan = sweep_frame.select_view_plan(
                        u, h, w, shape_for)
                    if plan is not None:
                        plans.append((plan, shape_for(view["p_axis"])[0]))
    return plans


def test_brick_route_agrees_with_the_tests_it_replaced():
    """``brick_route`` against the four tests it replaced, over the
    planner's plans, slab counts below, at and above the voxel planes and
    1-8 ranks: the frame's own test, the engine's texture-TF test, the
    engine's wide-rect re-plan (which left out the rect and ``tile_h``
    terms: the planner keeps a wide rect only with a brick rect whose
    ``tile_h`` divides ``Hi``) and ``render_frame_sharded``'s re-plan."""
    plans = _planner_plans()
    wide = [p for p, _ in plans if p.get("rect_w", 256) > 256]
    assert len(plans) > 50 and wide, (len(plans), len(wide))
    assert any(p.get("R_brick") is None for p, _ in plans)
    for plan, Np in plans:
        R_brick, Hi = plan.get("R_brick"), plan["Hi"]
        tile_h, rect_w = plan.get("tile_h", 8), plan.get("rect_w", 256)
        for n_slabs in (Np // 2, Np - 1, Np, 2 * Np):
            for ranks in (1, 2, 4, 8):
                got = sweep_frame.brick_route(plan, n_slabs, Np, ranks)
                frame = (R_brick is not None and n_slabs >= Np
                         and (Hi // ranks) % tile_h == 0)
                assert got == frame
                assert (rect_w > 256 and not got) == (rect_w > 256 and (
                    n_slabs < Np or bool((Hi // ranks) % tile_h)))
            got = sweep_frame.brick_route(plan, n_slabs, Np)
            texture = not (R_brick is None or n_slabs < Np
                           or Hi % tile_h)
            assert got == texture
            assert (rect_w > 256 and not got) == (rect_w > 256
                                                  and n_slabs < Np)
