#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from vkvolume_tpu_torch/csrc, loads the
full-scale synthetic stag beetle (494x832x832 u8) into bench.py's engine
(anisotropic-distance ESS, block size 4, ERT on) and:

  0. prints the card (nvidia-smi name and power limit), torch and CUDA
     versions, and builds the kernels;
  1. builds the engine (TF edit: occupancy + 8 octant distance maps) and
     prints map_update_ms and the occupancy;
  2. holds every kernel against its plain PyTorch version on the card at the
     main path's shapes (K3+K4 bit-exact; K1 sample counts and first-hit
     planes exact, lum and alpha within 1e-5; K2 u16 within 1 LSB, f32
     within 1e-6 of full scale) and times both;
  3. with every launch counter at 0, re-runs the TF edit and renders the
     benchmark pose at 1920x1080 (20 frames x 5 reps, CUDA events), then
     checks that K1-K4 launched, the plan took the brick sweep and the
     two-pass warp, the frame has content, and it matches the plain-PyTorch
     frame on the card;
  4. with every launch counter at 0, runs the CLI's default render in this
     process (``vkvolume_tpu_torch.cli --synth beetle --output <png>``:
     isotropic-distance ESS, gradient TF, 1280x720, the brick sweep's
     gradient + plane-pair-lerp variant), checks that K1, K2, the two-sided
     K4 and K5 launched, then holds the isotropic map bit-exact to its plain
     version, K5, the two-sided K4 and K1's variant against their plain
     versions (timing both), the frame against the plain-PyTorch frame, the
     plan (brick sweep, two-pass warp) and the PNG (>= 5 % covered); times
     ms/frame and map_update_ms; runs ``--benchmark 20`` once;
  5. prints the kernel table and, as the last line,
     {"ok": true, "device": {...}}.

Any failure raises: the script exits non-zero and prints no result. It
needs a CUDA device and the repository beside it; the synthetic volume is
cached in .cache/ and the kernels are built into build/.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

WIDTH, HEIGHT = 1920, 1080
CLI_WIDTH, CLI_HEIGHT = 1280, 720      # the CLI's default frame
CLI_BENCH_FRAMES = 20
FRAMES, REPS = 20, 5
MIN_COVERED = 0.05      # share of pixels with alpha > 0 the frame must show
FRAME_TOL = 2e-3        # per-pixel colour tolerance (tests/test_torch_frame)
FRAME_BAD_SHARE = 1e-3  # share of pixels allowed beyond it
FRAME_ALPHA_MEAN = 1e-4  # mean alpha difference allowed


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_timer(fn, n: int, warm: int = 1) -> float:
    """Mean milliseconds per call of ``fn`` on the card (CUDA events over
    ``n`` calls after ``warm`` untimed ones)."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def phase_build():
    from vkvolume_tpu_torch.utils import cuda_build

    t0 = time.perf_counter()
    cuda_build.load_kernels()
    log(f"phase 0: kernels built in {time.perf_counter() - t0:.1f} s")
    for line in cuda_build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"  ptxas: {line.strip()}")


def phase_engine(device, scale=1.0):
    import numpy as np
    from vkvolume_tpu_torch.bench.datasets import DATASETS, synthesize
    from vkvolume_tpu_torch.bench.harness import make_engine
    from vkvolume_tpu_torch.options import Test

    t0 = time.perf_counter()
    vol = synthesize(DATASETS["beetle"], seed=0, scale=scale)
    log(f"phase 1: beetle {vol.shape} {vol.dtype} in "
        f"{time.perf_counter() - t0:.1f} s")
    assert vol.dtype == np.uint8
    assert scale != 1.0 or vol.shape == (494, 832, 832)
    eng, stats, _, _ = make_engine("beetle", 3, 4, volume_u8=vol,
                                   renderer="pallas", test=Test.NONE,
                                   ert=True, device=device)
    log(f"phase 1: map_update_ms={stats.map_update_ms:.4f} "
        f"occupancy_pct={stats.occupied_voxel_percent:.4f} "
        f"maps={tuple(eng.volumes[0].dist_maps.shape)}")
    return eng, stats


def frame_pose(eng, cam):
    """The cached pose of the engine's last frame at (WIDTH, HEIGHT)."""
    v = eng.volumes[0]
    poses = [p for k, p in v._sweep_cache.items()
             if isinstance(k, tuple) and k[0] == "pose"
             and k[1][:2] == (cam.view.tobytes(), cam.proj.tobytes())]
    assert len(poses) == 1
    pose = poses[0]
    occ = [t for k, t in v._sweep_cache.items()
           if isinstance(k, tuple) and k[0] == "occ"]
    assert len(occ) == 1
    return pose, v._sweep_cache[pose["view"]["p_axis"]], occ[0]


def phase_kernels(eng, cam, timer):
    """Each kernel against its plain version at the main path's shapes."""
    import torch
    from vkvolume_tpu_torch.accel import distance, distance_cuda
    from vkvolume_tpu_torch.accel.occupancy import (_occupancy_u8,
                                                    _tf_thresholds)
    from vkvolume_tpu_torch.render import sweep_bricks, sweep_frame, warp_cuda
    from vkvolume_tpu_torch.render.ray_setup import make_rays

    rows = {}
    v = eng.volumes[0]
    o = v.options
    ti, tg = _tf_thresholds((o.intensity_min, o.intensity_max,
                             o.gradient_min, o.gradient_max))
    occ = _occupancy_u8(v.density, None, v.map_shape_zyx, ti, tg)

    # K3 + K4: bit-exact, every one of the 8 maps (and the engine's maps).
    xy_k = distance_cuda.scan_and_relax_multi(occ)
    xy_p = distance.scan_and_relax_multi(occ)
    assert torch.equal(xy_k, xy_p), "K3 differs from its plain version"
    z_k = distance_cuda.relax_z_direct_multi(xy_k)
    z_p = distance.relax_z_direct_multi(xy_p)
    for i in range(8):
        assert torch.equal(z_k[i], z_p[i]), f"K4 octant map {i} differs"
    assert torch.equal(v.dist_maps, z_p), "engine maps differ"
    rows["K3"] = dict(max_abs_err=0.0,
                      ms=timer(lambda: distance_cuda.scan_and_relax_multi(occ),
                               20),
                      plain_ms=timer(lambda: distance.scan_and_relax_multi(occ),
                                     2))
    rows["K4"] = dict(max_abs_err=0.0,
                      ms=timer(lambda: distance_cuda.relax_z_direct_multi(xy_k),
                               20),
                      plain_ms=timer(lambda: distance.relax_z_direct_multi(xy_k),
                                     2))
    log(f"phase 2: K3+K4 bit-exact on 8 maps {tuple(z_k.shape)}")

    # K1 on the frame's own grid fields and maps.
    pose, vol_t, occ_t = frame_pose(eng, cam)
    plan = pose["plan"]
    u, pvm, gp, hcoef = sweep_frame.unpack_frame_scalars(pose["packed"])
    p = pose["view"]["p_axis"]
    dev = vol_t.device
    wu_g, wv_g = sweep_frame.w_grid(gp, plan["Hi"], plan["Wi"], dev)
    sgn = 1 if plan["sgn_p"] > 0 else -1
    n_slabs = vol_t.shape[0]
    s_lo, s_hi, cov, kappa = sweep_bricks.grid_fields(
        u, wu_g, wv_g, sgn, p, max(vol_t.shape), n_slabs)
    grid = (wu_g, wv_g, s_lo, s_hi, kappa, cov)
    kw = dict(p_axis=p, ert=eng.options.early_ray_termination, n_slabs=n_slabs,
              sgn=sgn, tile_h=plan["tile_h"], dist_leap=True)
    # Sample counting on: nsamp then checks the brick walk too.
    inp = sweep_bricks.brick_inputs(vol_t, occ_t, eng._tf(v), u, grid,
                                    count_samples=True, **kw)
    lum_k, a_k, f_k, n_k = sweep_bricks.sweep_bricks_kernel(inp)
    lum_p, a_p, f_p, n_p = sweep_bricks.sweep_bricks_reference(inp)
    assert torch.equal(n_k, n_p), "K1 sample counts differ"
    assert torch.equal(f_k, f_p), "K1 first-hit planes differ"
    err = max(float((lum_k - lum_p).abs().max()),
              float((a_k - a_p).abs().max()))
    assert err <= 1e-5, f"K1 lum/alpha differ by {err}"
    assert int(n_k.sum()) > 0 and float(a_k.max()) > 0.5
    # Timed with the main path's statics.
    inp = sweep_bricks.brick_inputs(vol_t, occ_t, eng._tf(v), u, grid,
                                    count_samples=False, **kw)
    rows["K1"] = dict(max_abs_err=err,
                      ms=timer(lambda: sweep_bricks.sweep_bricks_kernel(inp),
                               10),
                      plain_ms=timer(
                          lambda: sweep_bricks.sweep_bricks_reference(inp), 1))
    log(f"phase 2: K1 exact nsamp/firsts, lum/alpha err {err:.3g}, grid "
        f"{plan['Hi']}x{plan['Wi']} tile_h={plan['tile_h']} "
        f"samples={int(n_k.sum())}")

    # K2 on the frame's pass positions and channels, u16 and f32.
    grid_out = sweep_bricks.sweep_bricks(vol_t, occ_t, eng._tf(v), u, pvm,
                                         grid, count_samples=False, **kw)
    chans = torch.stack([grid_out.color[..., 0], grid_out.color[..., 3],
                         grid_out.depth])
    rays = make_rays(u, HEIGHT, WIDTH, dev)
    gx, gy = sweep_frame.pixel_grid_coords(rays, gp, p)
    pos1, pos2 = sweep_frame.warp_positions(
        gx, gy, gp, hcoef, Hi=plan["Hi"], Wi=plan["Wi"],
        warp_variant=plan["warp_variant"])
    src1 = chans.transpose(1, 2) if plan["warp_variant"] == "B" else chans
    src1 = src1.contiguous()
    enc1 = torch.round(torch.clamp(src1 * 65535.0, 0.0, 65535.0)).to(
        torch.uint16)
    err = 0.0
    t_k = warp_cuda.resample_rows(enc1, pos1, encode_out=True)
    t_p = warp_cuda.resample_rows_reference(enc1, pos1, encode_out=True)
    d16 = int((t_k.to(torch.int32) - t_p.to(torch.int32)).abs().max())
    assert d16 <= 1, f"K2 pass 1 u16 differs by {d16} LSB"
    src2 = t_k.transpose(1, 2).contiguous()
    o_k = warp_cuda.resample_rows(src2, pos2)
    o_p = warp_cuda.resample_rows_reference(src2, pos2)
    err = float((o_k - o_p).abs().max()) / 65535.0
    assert err <= 1e-6, f"K2 pass 2 differs by {err} of full scale"
    for src, pos in ((src1, pos1), ((src2.float() / 65535.0).contiguous(),
                                    pos2)):
        d = float((warp_cuda.resample_rows(src, pos)
                   - warp_cuda.resample_rows_reference(src, pos)).abs().max())
        assert d <= 1e-6, f"K2 f32 differs by {d}"
        err = max(err, d)
    rows["K2"] = dict(
        max_abs_err=max(err, d16 / 65535.0),
        ms=timer(lambda: (warp_cuda.resample_rows(enc1, pos1,
                                                  encode_out=True),
                          warp_cuda.resample_rows(src2, pos2)), 20),
        plain_ms=timer(lambda: (
            warp_cuda.resample_rows_reference(enc1, pos1, encode_out=True),
            warp_cuda.resample_rows_reference(src2, pos2)), 3))
    log(f"phase 2: K2 u16 within {d16} LSB, f32 err {err:.3g}; positions "
        f"{tuple(pos1.shape)} -> {tuple(pos2.shape)}")
    return rows


def reset_launches():
    from vkvolume_tpu_torch.accel import distance_cuda
    from vkvolume_tpu_torch.render import sweep_bricks, warp_cuda

    for table in (distance_cuda.LAUNCHES, sweep_bricks.LAUNCHES,
                  warp_cuda.LAUNCHES):
        for k in table:
            table[k] = 0


def read_launches():
    from vkvolume_tpu_torch.accel import distance_cuda
    from vkvolume_tpu_torch.render import sweep_bricks, warp_cuda

    return {"K1": sweep_bricks.LAUNCHES["sweep_bricks"],
            "K2": warp_cuda.LAUNCHES["resample_rows"],
            "K3": distance_cuda.LAUNCHES["scan_and_relax_multi"],
            "K4": distance_cuda.LAUNCHES["relax_z_direct_multi"],
            "K4 two-sided": distance_cuda.LAUNCHES["relax_z_direct"],
            "K5": distance_cuda.LAUNCHES["scan_and_relax"]}


def plain_frame(eng, cam, width=WIDTH, height=HEIGHT):
    """The same frame with K1 and K2 swapped for their plain versions (the
    maps are the kernels', held bit-exact to the plain maps in phase 2)."""
    from vkvolume_tpu_torch.render import sweep_bricks, warp_cuda

    saved = (sweep_bricks.sweep_bricks_kernel, warp_cuda.resample_rows)
    sweep_bricks.sweep_bricks_kernel = sweep_bricks.sweep_bricks_reference
    warp_cuda.resample_rows = warp_cuda.resample_rows_reference
    try:
        return eng.render(cam, width, height)
    finally:
        sweep_bricks.sweep_bricks_kernel, warp_cuda.resample_rows = saved


def frame_reps(eng, cam, width, height):
    """ms/frame of FRAMES queued frames, REPS times (CUDA events)."""
    import torch

    reps = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(FRAMES):
            out = eng.render(cam, width, height)
        end.record()
        torch.cuda.synchronize()
        reps.append(start.elapsed_time(end) / FRAMES)
    return reps, out


def check_against_plain_frame(eng, cam, color, width, height, phase):
    """The frame within FRAME_TOL / FRAME_BAD_SHARE / FRAME_ALPHA_MEAN of
    the plain-PyTorch frame."""
    ref = plain_frame(eng, cam, width, height).color
    diff = (color - ref).abs().amax(dim=-1)
    bad = float((diff > FRAME_TOL).float().mean())
    da = abs(float(color[..., 3].mean()) - float(ref[..., 3].mean()))
    log(f"{phase}: frame vs plain-PyTorch frame: max {float(diff.max()):.3g}, "
        f"share > {FRAME_TOL}: {bad:.3g}, mean alpha diff {da:.3g}")
    assert bad <= FRAME_BAD_SHARE and da <= FRAME_ALPHA_MEAN


def phase_frame(eng, cam):
    import numpy as np
    import torch

    v = eng.volumes[0]
    reset_launches()
    # The main path: one TF edit (map rebuild), then the frames.
    st = eng.update_transfer_function(v)
    eng.render(cam, WIDTH, HEIGHT)
    torch.cuda.synchronize()
    reps, out = frame_reps(eng, cam, WIDTH, HEIGHT)
    launches = read_launches()
    frame_ms = statistics.median(reps)
    log(f"phase 3: map_update_ms={st.map_update_ms:.4f} (TF edit, 20 "
        f"builds)")
    log(f"phase 3: ms/frame median={frame_ms:.4f} reps="
        f"{[round(r, 4) for r in reps]} ({FRAMES} frames x {REPS} reps, "
        f"{WIDTH}x{HEIGHT})")
    log(f"phase 3: launches {launches}")
    assert all(launches[k] > 0 for k in ("K1", "K2", "K3", "K4")), \
        "a kernel of the path never ran"

    pose, _, _ = frame_pose(eng, cam)
    plan = pose["plan"]
    assert plan["R_brick"] is not None and plan["RECT_A"] is not None
    assert not plan.get("warp_xla")
    used = {k for k, n in eng.renderer_counts.items() if n}
    assert used == {"pallas"}, eng.renderer_counts
    color = out.color
    assert tuple(color.shape) == (HEIGHT, WIDTH, 4)
    assert bool(torch.isfinite(color).all())
    covered = float((color[..., 3] > 0).float().mean())
    log(f"phase 3: plan Hi={plan['Hi']} Wi={plan['Wi']} "
        f"tile_h={plan['tile_h']} warp={plan['warp_variant']} "
        f"p_axis={pose['view']['p_axis']}; covered share {covered:.4f}")
    assert covered >= MIN_COVERED, f"frame nearly empty ({covered})"
    check_against_plain_frame(eng, cam, color, WIDTH, HEIGHT, "phase 3")
    img = np.clip(np.round(color[..., :3].cpu().numpy() * 255.0), 0, 255)
    log(f"phase 3: u8 image mean {img.mean():.3f}")
    return frame_ms, reps, launches


def phase_cli(timer, out_dir):
    """The CLI's default render, driven in-process on the card."""
    import torch
    from vkvolume_tpu_torch import cli
    from vkvolume_tpu_torch.accel import distance, distance_cuda
    from vkvolume_tpu_torch.accel.occupancy import (_occupancy_u8,
                                                    _tf_thresholds)
    from vkvolume_tpu_torch.options import SkippingType
    from vkvolume_tpu_torch.render import sweep_bricks, sweep_frame
    from vkvolume_tpu_torch.utils.image import read_png

    png = os.path.join(out_dir, "cli_default.png")
    reset_launches()
    # The main path of this slice: load, gradient map, TF edit (isotropic
    # map through K5 and the two-sided K4), one frame (K1, K2), PNG.
    eng, _, out = cli.run(["--synth", "beetle", "--output", png])
    torch.cuda.synchronize()
    launches = read_launches()
    log(f"phase 4: launches {launches}")
    assert all(launches[k] > 0 for k in ("K1", "K2", "K4 two-sided", "K5")), \
        "a kernel of the CLI path never ran"
    assert launches["K3"] == 0 and launches["K4"] == 0

    v = eng.volumes[0]
    assert eng.options.skipping_type == SkippingType.DISTANCE
    assert tuple(v.density.shape) == (494, 832, 832)
    assert tuple(v.dist_maps.shape) == (1, 124, 208, 208)
    cam = cli.cli_camera(CLI_WIDTH, CLI_HEIGHT)
    pose, vol_t, occ_t = frame_pose(eng, cam)
    plan = pose["plan"]
    p = pose["view"]["p_axis"]
    assert plan["R_brick"] is not None and plan["RECT_A"] is not None
    assert not plan.get("warp_xla")
    tf = eng._tf(v)
    assert tf.use_gradient
    n_slabs = int(max(2, round(vol_t.shape[0] * eng._slab_oversample(
        v, vol_t.shape, tf))))
    assert n_slabs != vol_t.shape[0], "expected the plane-pair lerp"
    log(f"phase 4: plan Hi={plan['Hi']} Wi={plan['Wi']} "
        f"tile_h={plan['tile_h']} R_brick={plan['R_brick']} "
        f"RECT_A={plan['RECT_A']} warp={plan['warp_variant']} p_axis={p} "
        f"vol_t={tuple(vol_t.shape)} n_slabs={n_slabs}")

    # PNG and frame content.
    color = out.color
    assert tuple(color.shape) == (CLI_HEIGHT, CLI_WIDTH, 4)
    assert bool(torch.isfinite(color).all())
    img = read_png(png)
    assert img.shape == (CLI_HEIGHT, CLI_WIDTH, 3)
    covered = float((img.max(axis=-1) > 0).mean())
    log(f"phase 4: PNG {img.shape} covered share {covered:.4f}, u8 mean "
        f"{img.mean():.3f}")
    assert covered >= MIN_COVERED, f"PNG nearly empty ({covered})"

    rows = {}
    # The isotropic map: bit-exact to the plain transform; K5 and the
    # two-sided K4 each against their plain versions.
    o = v.options
    ti, tg = _tf_thresholds((o.intensity_min, o.intensity_max,
                             o.gradient_min, o.gradient_max))
    occ = _occupancy_u8(v.density, v.gradient, v.map_shape_zyx, ti, tg)
    assert torch.equal(v.dist_maps[0], distance.isotropic_distance(occ)), \
        "engine isotropic map differs from the plain transform"
    xy_k = distance_cuda.scan_and_relax(occ)
    assert torch.equal(xy_k, distance.scan_and_relax(occ, 0, (0,))), \
        "K5 differs from its plain version"
    z_k = distance_cuda.relax_z_direct(xy_k[0])
    assert torch.equal(z_k, distance.relax_z_direct(xy_k[0], (0,))), \
        "two-sided K4 differs from its plain version"
    rows["K5"] = dict(max_abs_err=0.0,
                      ms=timer(lambda: distance_cuda.scan_and_relax(occ), 20),
                      plain_ms=timer(lambda: distance.scan_and_relax(
                          occ, 0, (0,)), 2))
    rows["K4 two-sided"] = dict(
        max_abs_err=0.0,
        ms=timer(lambda: distance_cuda.relax_z_direct(xy_k[0]), 20),
        plain_ms=timer(lambda: distance.relax_z_direct(xy_k[0], (0,)), 2))
    log(f"phase 4: isotropic map bit-exact {tuple(z_k.shape)}, max "
        f"{int(z_k.max())}")

    # K1's gradient + lerp variant on this frame's grid fields.
    u, _, gp, _ = sweep_frame.unpack_frame_scalars(pose["packed"])
    dev = vol_t.device
    wu_g, wv_g = sweep_frame.w_grid(gp, plan["Hi"], plan["Wi"], dev)
    sgn = 1 if plan["sgn_p"] > 0 else -1
    s_lo, s_hi, cov, kappa = sweep_bricks.grid_fields(
        u, wu_g, wv_g, sgn, p, max(vol_t.shape), n_slabs)
    kw = dict(p_axis=p, ert=eng.options.early_ray_termination,
              n_slabs=n_slabs, sgn=sgn, tile_h=plan["tile_h"], dist_leap=True,
              grad_t=v._sweep_cache[("grad", p)])
    grid = (wu_g, wv_g, s_lo, s_hi, kappa, cov)
    inp = sweep_bricks.brick_inputs(vol_t, occ_t, tf, u, grid,
                                    count_samples=True, **kw)
    assert inp.params["use_gradient"] and not inp.params["aligned"]
    lum_k, a_k, f_k, n_k = sweep_bricks.sweep_bricks_kernel(inp)
    lum_p, a_p, f_p, n_p = sweep_bricks.sweep_bricks_reference(inp)
    assert torch.equal(n_k, n_p), "K1 (gradient + lerp) sample counts differ"
    assert torch.equal(f_k, f_p), "K1 (gradient + lerp) first hits differ"
    err = max(float((lum_k - lum_p).abs().max()),
              float((a_k - a_p).abs().max()))
    assert err <= 1e-5, f"K1 (gradient + lerp) lum/alpha differ by {err}"
    assert int(n_k.sum()) > 0 and float(a_k.max()) > 0.5
    inp = sweep_bricks.brick_inputs(vol_t, occ_t, tf, u, grid,
                                    count_samples=False, **kw)
    rows["K1 gradient + lerp"] = dict(
        max_abs_err=err,
        ms=timer(lambda: sweep_bricks.sweep_bricks_kernel(inp), 10),
        plain_ms=timer(lambda: sweep_bricks.sweep_bricks_reference(inp), 1))
    log(f"phase 4: K1 gradient + lerp exact nsamp/firsts, lum/alpha err "
        f"{err:.3g}, samples={int(n_k.sum())}")

    # The frame: ms/frame, and against the plain-PyTorch frame.
    check_against_plain_frame(eng, cam, color, CLI_WIDTH, CLI_HEIGHT,
                              "phase 4")
    eng.render(cam, CLI_WIDTH, CLI_HEIGHT)
    torch.cuda.synchronize()
    reps, _ = frame_reps(eng, cam, CLI_WIDTH, CLI_HEIGHT)
    frame_ms = statistics.median(reps)
    log(f"phase 4: ms/frame median={frame_ms:.4f} reps="
        f"{[round(r, 4) for r in reps]} ({FRAMES} frames x {REPS} reps, "
        f"{CLI_WIDTH}x{CLI_HEIGHT})")
    # map_update_ms: one TF edit (occupancy + isotropic map), median of
    # REPS means over 20 queued builds.
    map_reps = [timer(lambda: eng.update_transfer_function(v), 20)
                for _ in range(REPS)]
    map_ms = statistics.median(map_reps)
    log(f"phase 4: map_update_ms median={map_ms:.4f} reps="
        f"{[round(r, 4) for r in map_reps]}")

    # Benchmark mode (Test.NUM_TEXTURE_SAMPLES, ERT off) once.
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _, _, bout = cli.run(["--synth", "beetle", "--benchmark",
                              str(CLI_BENCH_FRAMES)])
    for line in buf.getvalue().splitlines():
        log(f"phase 4 --benchmark {CLI_BENCH_FRAMES}: {line}")
    assert f"ran {CLI_BENCH_FRAMES} frames, averaged " in buf.getvalue()
    assert bool(torch.isfinite(bout.color).all())
    assert int(bout.num_volume_samples.max()) > 0
    return rows, launches, frame_ms, map_ms


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    import vkvolume_tpu_torch  # noqa: F401  (fails outside the repository)
    from vkvolume_tpu_torch.bench.harness import benchmark_camera

    assert "jax" not in sys.modules
    phase_build()
    eng, _ = phase_engine("cuda")
    cam = benchmark_camera(aspect=WIDTH / HEIGHT)
    eng.render(cam, WIDTH, HEIGHT)        # populates the pose / map caches
    torch.cuda.synchronize()
    rows = phase_kernels(eng, cam, gpu_timer)
    frame_ms, _, launches = phase_frame(eng, cam)
    del eng
    with tempfile.TemporaryDirectory() as out_dir:
        cli_rows, cli_launches, cli_ms, cli_map_ms = phase_cli(gpu_timer,
                                                               out_dir)
    rows.update(cli_rows)
    assert "jax" not in sys.modules

    # (row, launch count of its path, source, TPU kernel body it replaces)
    where = {
        "K1": ("sweep_bricks (aligned, intensity TF; bench.py frame)",
               launches["K1"], "vkvolume_tpu_torch/csrc/sweep_bricks.cu",
               "vkvolume_tpu/render/sweep_bricks.py:56"),
        "K1 gradient + lerp": (
            "sweep_bricks (gradient TF, plane-pair lerp; CLI frame)",
            cli_launches["K1"], "vkvolume_tpu_torch/csrc/sweep_bricks.cu",
            "vkvolume_tpu/render/sweep_bricks.py:56"),
        "K2": ("resample_rows (2 launches per frame; ms per frame)",
               launches["K2"], "vkvolume_tpu_torch/csrc/resample_rows.cu",
               "vkvolume_tpu/render/warp_pallas.py:227"),
        "K3": ("scan_and_relax_multi (x-scan + y-relax)", launches["K3"],
               "vkvolume_tpu_torch/csrc/distance.cu",
               "vkvolume_tpu/accel/distance_pallas.py:146"),
        "K4": ("relax_z_direct_multi (z-relax, one-sided x8)",
               launches["K4"], "vkvolume_tpu_torch/csrc/distance.cu",
               "vkvolume_tpu/accel/distance_pallas.py:162"),
        "K4 two-sided": ("relax_z_direct (z-relax, two-sided; isotropic)",
                         cli_launches["K4 two-sided"],
                         "vkvolume_tpu_torch/csrc/distance.cu",
                         "vkvolume_tpu/accel/distance_pallas.py:162"),
        "K5": ("scan_and_relax (two-sided x-scan + y-relax; isotropic)",
               cli_launches["K5"], "vkvolume_tpu_torch/csrc/distance.cu",
               "vkvolume_tpu/accel/distance_pallas.py:136"),
    }
    kernels = []
    for k, (name, n, source, replaces) in where.items():
        r = rows[k]
        log(f"{k} {name}: {r['ms']:.4f} ms vs plain {r['plain_ms']:.4f} ms "
            f"(max abs err {r['max_abs_err']:.3g}, launches {n})")
        kernels.append({"name": f"{k.split()[0]} {name}", "route": "cuda",
                        "source": source, "replaces": replaces,
                        "launches": n, "max_abs_err": r["max_abs_err"],
                        "ms": r["ms"], "plain_ms": r["plain_ms"]})
    log(f"frame_ms_median {frame_ms:.4f} ({WIDTH}x{HEIGHT}, skipmode 3)")
    log(f"cli_frame_ms_median {cli_ms:.4f} cli_map_update_ms {cli_map_ms:.4f} "
        f"({CLI_WIDTH}x{CLI_HEIGHT}, skipmode 2, gradient TF)")
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
