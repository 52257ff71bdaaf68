"""K8 (the single-pass warp) test helpers: the pixel positions that real K8
frames hand it, from the plan alone (numpy host plan + the port's rays; no
volume, no sweep); the positions of the small kernel cases; and the host
statement of the kernel's per-tile path, which the card tests hold the
kernel's tile counters to.

The views are the CLI's: its camera, its node scale (the volume fitted
to a 100-unit cube) and its block size. ``narrow`` re-plans a wide-rect
view at 256 lanes, as the engine does when there are fewer slabs than
voxel planes (the side view at ``--sampling 0.25``). The orbit views are
the five poses of ``--benchmark 20 --orbit 5`` whose plan takes K8."""

import numpy as np

from vkvolume_tpu_torch import cli
from vkvolume_tpu_torch.bench.harness import benchmark_camera
from vkvolume_tpu_torch.render import ray_setup, sweep_frame
from vkvolume_tpu_torch.utils import math3d

BEETLE = (494, 832, 832)
# name: (volume shape, width, height, camera, azimuth, narrow, channels)
VIEWS = {
    "cli_small": ((49, 83, 83), 384, 256, "cli", 30.0, False, 3),
    "side": (BEETLE, 1280, 720, "cli", 80.0, True, 3),
    **{f"orbit_{az}": (BEETLE, 1280, 720, "benchmark", float(az), False, 4)
       for az in (80, 85, 90, 95, 100)},
}

# csrc/warp_pixels.cu: kTileH x kTileW pixel tiles, two kTileW / 2 wide
# halves each, and the staging budget kStageBytes.
TILE_H, TILE_W, STAGE_BYTES = 16, 32, 27 * 1024
PATHS = ("empty", "staged", "two_passes", "direct")


def k8_view(name: str, device="cpu"):
    """(gx, gy, Hi, Wi, C) of the view's K8 warp; asserts that its plan
    takes the single-pass warp."""
    shape, w, h, kind, az, narrow, C = VIEWS[name]
    d, hh, ww = shape
    cam = (cli.cli_camera(w, h, az) if kind == "cli"
           else benchmark_camera(w / h, az, 20.0))
    u = ray_setup.make_uniforms(
        cam, math3d.scale((100.0 / ww, 100.0 / hh, 100.0 / d)),
        math3d.scale((float(ww), float(hh), float(d))), 1.0,
        np.asarray((4.0, 4.0, 4.0), np.float32))

    def shape_for(q):
        return {2: shape, 1: (hh, d, ww), 0: (ww, d, hh)}[q]

    view, plan = sweep_frame.select_view_plan(u, h, w, shape_for)
    p = view["p_axis"]
    if narrow:
        plan = sweep_frame.plan_from_stats(view, u, p, shape_for(p), h, w,
                                           max_rect=256)
    assert plan["R_warp"] is not None and plan["RECT_A"] is None, name
    gp = (plan["wu0"], plan["dwu"], plan.get("cu", 0.0), plan["wv0"],
          plan["dwv"], plan.get("cv", 0.0))
    gx, gy = sweep_frame.pixel_grid_coords(
        ray_setup.make_rays(u, h, w, device), gp, p)
    return gx.contiguous(), gy.contiguous(), plan["Hi"], plan["Wi"], C


def k8_positions(kind, H, W, Hi, Wi, rng):
    """gx, gy (numpy f32) of one small K8 case, a tenth of the pixels and
    the first tile row uncovered: "random" over the whole grid and a
    little past its edges (every covered tile direct), with a pixel on
    each grid corner and two past the edges; else over a 44 x 16-texel
    patch inside the grid ("patch": both halves staged in one pass), past
    its far edges ("corner") or its near ones ("origin"), or over a 66 x
    18-texel patch ("wide": each half fits the budget alone, not both)."""
    if kind == "random":
        gx = rng.uniform(-3.0, Wi + 2.0, (H, W))
        gy = rng.uniform(-3.0, Hi + 2.0, (H, W))
    else:
        pw, ph = (66.0, 18.0) if kind == "wide" else (44.0, 16.0)
        inside = (rng.uniform(0, max(Wi - pw + 2, 1)),
                  rng.uniform(0, max(Hi - ph + 2, 1)))
        x0, y0 = {"corner": (Wi - 20.0, Hi - 6.0),
                  "origin": (-20.0, -8.0)}.get(kind, inside)
        gx = x0 + rng.uniform(-2.0, pw - 2.0, (H, W))
        gy = y0 + rng.uniform(-2.0, ph - 2.0, (H, W))
    gx, gy = gx.astype(np.float32), gy.astype(np.float32)
    gx[rng.random((H, W)) < 0.1] = -10.0
    gx[:TILE_H] = -10.0
    if kind == "random" and H > TILE_H + 1 and W > 5:
        gx[TILE_H + 1, :6] = (0.0, Wi - 1.0, 0.0, Wi - 1.0, -4.0, Wi + 7.0)
        gy[TILE_H + 1, :6] = (0.0, 0.0, Hi - 1.0, Hi - 1.0, Hi + 3.0, -6.0)
    return gx, gy


def _half_floats(gx, gy, Hi, Wi, C, src_vec):
    """Floats of one half tile's rect in shared memory, all C planes (0:
    no covered pixel): the covered pixels' clamped footprint, its columns
    widened to 16-byte pieces when ``src_vec``, rows padded to an odd
    number of pieces."""
    inside = gx > -5.0
    if not inside.any():
        return 0
    xs = np.clip(gx[inside], 0.0, Wi - 1.0)
    ys = np.clip(gy[inside], 0.0, Hi - 1.0)
    xl, yl = int(np.floor(xs.min())), int(np.floor(ys.min()))
    xh = min(int(np.floor(xs.max())) + 1, Wi - 1)
    yh = min(int(np.floor(ys.max())) + 1, Hi - 1)
    if src_vec:
        xl -= xl % 4
        xh = xl + -(-(xh - xl + 1) // 4) * 4 - 1
    pitch = -(-(xh - xl + 1) // 4) * 4
    pitch += 4 * (pitch // 4 % 2 == 0)
    return C * (yh - yl + 1) * pitch


def tile_paths(gx, gy, Hi, Wi, C, stage_bytes=STAGE_BYTES, src_vec=None):
    """K8's path for each tile, counted: "empty" (no covered pixel),
    "staged" (both halves' rects fit the budget together), "two_passes"
    (each fits alone) or "direct" (a half's does not: it reads global
    memory). ``src_vec`` (16-byte staging copies) defaults to Wi % 4 ==
    0, as for an aligned grid."""
    gx, gy = np.asarray(gx.cpu()), np.asarray(gy.cpu())
    if src_vec is None:
        src_vec = Wi % 4 == 0
    H, W = gx.shape
    hw, budget = TILE_W // 2, stage_bytes // 4
    got = dict.fromkeys(PATHS, 0)
    for ty in range(0, H, TILE_H):
        for tx in range(0, W, TILE_W):
            n = [_half_floats(gx[ty:ty + TILE_H, x:x + hw],
                              gy[ty:ty + TILE_H, x:x + hw], Hi, Wi, C,
                              src_vec) for x in (tx, tx + hw)]
            got["empty" if sum(n) == 0 else "staged" if sum(n) <= budget
                else "two_passes" if max(n) <= budget else "direct"] += 1
    return got


# The small card cases (C, Hi, Wi, H, W, positions, byte offset of gx / gy,
# of the channels): Wi a multiple of 4 and not (16-byte or 4-byte staging
# copies), W not a multiple of 4 (scalar pixel loads and stores) or of the
# tile, H not a multiple of the tile, Hi = 1, bases off 16-byte alignment;
# the first tile row uncovered.
K8_CASES = [
    (3, 72, 640, 40, 384, "random", 0, 0),
    (4, 72, 640, 40, 384, "patch", 0, 0),
    (3, 72, 641, 37, 100, "patch", 0, 0),
    (3, 72, 641, 37, 100, "random", 0, 0),
    (4, 72, 640, 40, 96, "corner", 0, 0),
    (3, 72, 641, 40, 96, "origin", 0, 0),
    (4, 9, 7, 33, 70, "patch", 0, 0), (3, 1, 640, 20, 64, "patch", 0, 0),
    (3, 1, 7, 20, 66, "random", 0, 0), (4, 50, 200, 45, 1283, "patch", 0, 0),
    (3, 72, 640, 40, 384, "patch", 4, 0),
    (3, 72, 640, 40, 384, "patch", 0, 4),
    (3, 300, 1024, 64, 96, "patch", 0, 0),
    (3, 72, 640, 40, 384, "wide", 0, 0), (4, 72, 641, 37, 100, "wide", 0, 0),
    (4, 72, 640, 40, 384, "wide", 0, 4)]
