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
     main path's shapes (K3+K4 bit-exact; K1's walk lists equal to the plain
     walk's, its sample counts and first-hit planes exact, lum and alpha
     within 1e-5 of the plain sweep; K2 per pass u16 within 1 LSB, f32
     within 1e-6 of full scale, and the whole two-pass warp of the frame's
     channels in both variants within 1 LSB of the plain warp, each call
     two kernels and no other work on the card) and times both, K2 beside
     one ``grid_sample`` per pass;
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
     ms/frame and map_update_ms; runs ``--benchmark 20`` once; then, with
     the counters at 0 again, the accel API's relaxation (K6) completes the
     isotropic map from K5's output, bit-exact to the engine's map, and K6
     is held bit-exact to its plain version on both axes and all senses;
  5. the orbit, with the counters at 0 before each run:
     (a) ``cli --synth beetle --azimuth 80 --sampling 0.25 --output <png>``:
         the engine narrows the view's 384-lane plan to a 256-lane re-plan,
         whose frame runs the per-slab sweep (K7: 416 slabs < 832 planes)
         and the single-pass warp (K8); checks both launched, the frame
         against the plain-PyTorch frame and the PNG; holds K7 (gradient
         and intensity TF) and K8 against their plain versions on this
         frame's inputs (K7 sample counts and first-hit planes exact,
         lum/alpha within 1e-5; K8 exact, every covered tile staged in
         shared memory) and times them, K8 cold (a rotation over input
         copies past the L2) and warm, beside ``grid_sample``;
     (b) ``cli --synth beetle --benchmark 20 --orbit 5`` (azimuths 30-125,
         ERT off, sample counts): prints the fps line and
         ``renderer_counts``, checks that K1, K2, K7 and K8 launched and
         that some frames took the gather warp, holds the frames at
         azimuths 35, 40 and 90 against the plain-PyTorch frames and times
         one pose of each route; then holds the orbit's largest sweeps
         against their plain versions and times them, K1's tile_h-32
         gradient + lerp variant at azimuth 90 and K7 at azimuth 40, each
         with its walk kernel alone; and K8 as in (a) on the four
         channels the azimuth-90 frame hands it;
  6. the texture TF, with the counters at 0 before each run:
     (a) ``cli --synth beetle --texture-tf --output <png>`` (the CLI frame
         through K1's texture variant and K2): checks that both launched
         and the XLA sweep did not, holds the variant bit-exact to its
         plain version on this frame's inputs (walk lists, sample counts,
         first hits, lum and alpha) and times both, the frame against the
         plain-PyTorch frame and against the closed-form frame of the same
         engine (under 1 % of pixels beyond 0.06, mean below 5e-3, not
         equal), the PNG
         (>= 5 % covered) and ms/frame;
     (b) the same pose through the XLA sweep (``renderer="sweep"``), held
         to the JAX package's cross-route tolerance against (a)'s frame,
         then the side view ``--texture-tf --azimuth 80 --sampling 0.25``
         (one "sweep" frame, no K1 or K7 launch, PNG covered): the XLA
         sweep's ms/frame of both, each the median of a few synced reps;
     (c) ``cli --synth beetle --texture-tf --benchmark 20 --orbit 5``:
         prints the fps line and ``renderer_counts``, checks that K1's
         texture variant ran on the brick poses, that the poses K7 takes
         without the texture went to the XLA sweep, and that K7 never ran;
  7. prints the kernel table (each kernel's time, its plain version's,
     the least time the card could take for the same work, and a PyTorch
     call's where one computes the same function; a kernel's time is the
     card's: the timed calls wait behind a sleep while the host issues
     them), the frame times and both paths' map_update_ms and, as the last
     line, {"ok": true, "device": {...}}.

K1 and K7 each launch two kernels, a walk that lists every tile's visited
bricks or slabs and a composite over the lists; every check holds the walk
kernel's lists equal to the plain walk's, and the composite against the
plain sweep that interleaves the two.

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
SLEEP_CYCLES = 10_000_000  # about 5 ms of the card's clock
STILL_AZIMUTH, STILL_SAMPLING = 80.0, 0.25   # phase 5a's still frame
ORBIT_POSES = {30.0: ("K1", "K2"), 35.0: ("K7", "K2"), 40.0: ("K7", "gather"),
               90.0: ("K1", "K8")}   # benchmark-orbit azimuth: its route
XLA_SWEEP_REPS = 3      # synced frames timed per XLA-sweep pose
# JAX's cross-route tolerance, texture through K1 against the XLA sweep
# (tests/test_sweep.py:328-333): share of |diff| > 0.06, mean alpha.
CROSS_TOL, CROSS_BAD_SHARE, CROSS_ALPHA_MEAN = 0.06, 0.01, 5e-3

# The least time the card could take for a kernel's work: the larger of its
# bytes (each input read once, each output written once) over the H100's
# device-memory rate and its operations over its float32 rate outside the
# tensor cores (the integer work of the distance kernels is counted at the
# same rate). Both are NVIDIA's published H100 SXM figures at 700 W.
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
# Operations per unit of work, counted from the kernels' sources. A sweep
# sample in range: index arithmetic, the intensity volume's 8 taps and
# their lerps, its TF; one whose intensity alpha is above 0 (gradient TF
# only): the gradient map's taps, lerps and TF; one that composites: powf
# counted as 20, compositing. The other units: one warped pixel, plus one
# channel; and one step of a distance map (load, compare, min, store).
OPS_IN_RANGE, OPS_GRADIENT, OPS_COMPOSITE = 65, 39, 30
# The texture TF's quantisation, what it adds to the closed form already
# in OPS_IN_RANGE / OPS_GRADIENT: per sample in range its intensity texel
# (multiply by 256, floor, clamp, multiply by 1/255); per sample past the
# intensity TF its gradient texel (gradient TF only) and the u8 truncation
# (multiply, clamp, floor, multiply). A clamp counts 2.
OPS_TEXEL, OPS_TRUNCATE = 5, 5
OPS_PER_STEP = 4
# A distance map's work, fixed by its shape and not by the data or the
# kernel: each pass of an x-scan takes one step per cell, and each output
# cell takes one step per sense of its relaxation (one test of a window
# against its neighbour's value: the least any exact method needs; a
# search per cell takes up to ceil(log2(cap + 1)) of them, a loop as long
# as the distance more). Charged alike to every kernel that builds the map.
OPS_PER_PIXEL, OPS_PER_CHANNEL = 14, 7
# A sweep's walk: per window its bounds, leap and final min; per 4-byte
# word of the window read, its padding and byte-wise min; per cell its six
# bound reductions.
OPS_PER_WINDOW, OPS_PER_WORD, OPS_PER_CELL = 40, 2, 6


def bound(nbytes: float, ops: float) -> dict:
    """bound_ms / bound_by of a kernel's work."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = ops / SCALAR_OPS_PER_S * 1e3
    return ({"bound_ms": t_b, "bound_by": "bytes"} if t_b >= t_o
            else {"bound_ms": t_o, "bound_by": "operations"})


def total(t) -> int:
    """Sum of an integer tensor."""
    import torch

    return int(t.to(torch.int64).sum())


def distance_bound(n_in: int, n_out: int, cells: int, scan_passes: int,
                   senses: int) -> dict:
    """bound_ms of a distance kernel: ``n_in`` u8 maps read and ``n_out``
    written once, of ``cells`` cells each; ``scan_passes`` x-scan passes
    and ``senses`` relaxation senses per output map (OPS_PER_STEP each per
    cell)."""
    return bound((n_in + n_out) * cells,
                 OPS_PER_STEP * cells * (scan_passes + n_out * senses))


def needed_reads(inp) -> dict:
    """Empty sector maps of the volume and the gradient map and zeroed
    sample counts, for a plain sweep's ``reads``."""
    import torch
    from vkvolume_tpu_torch.render.sweep_bricks import sector_map

    return {"vol": sector_map(inp.vol),
            "grad": None if inp.grad is None else sector_map(inp.grad),
            "passed": torch.zeros(2, dtype=torch.int64,
                                  device=inp.vol.device)}


def walk_stats(inp) -> dict:
    """Zeroed window counts and empty sector maps of the coarse maps, for
    a plain walk's ``stats``."""
    from vkvolume_tpu_torch.render.sweep_bricks import sector_map

    stats = {"windows": 0, "words": 0, "coarse": sector_map(inp.coarse)}
    if hasattr(inp, "cskip"):
        stats["cskip"] = sector_map(inp.cskip)
    return stats


def hold_sweep(inp, what: str):
    """K1 or K7 on ``inp`` (sample counting on) against its plain versions:
    the walk kernel's lists equal the plain walk's, and the compositing
    kernel over them matches the plain sweep that interleaves walk and
    compositing (sample counts and first-hit planes exact, lum and alpha
    within 1e-5). Returns (max_abs_err, nsamp, the plain sweep's reads,
    the plain walk's stats)."""
    import torch
    from vkvolume_tpu_torch.render import sweep_bricks, sweep_slabs

    if hasattr(inp, "cskip"):
        walk, walk_plain = sweep_bricks.brick_walk, sweep_bricks.brick_walk_plain
        composite = sweep_bricks.sweep_bricks_composite
        plain = sweep_bricks.sweep_bricks_reference
    else:
        walk, walk_plain = sweep_slabs.slab_walk, sweep_slabs.slab_walk_plain
        composite = sweep_slabs.sweep_slabs_composite
        plain = sweep_slabs.sweep_slabs_plain
    lists = walk(inp)
    stats = walk_stats(inp)
    want = walk_plain(inp, stats)
    assert torch.equal(lists.cnt, want.cnt), f"{what}: walk counts differ"
    assert torch.equal(lists.entries(), want.entries()), \
        f"{what}: walk lists differ"
    lum_k, a_k, f_k, n_k = composite(inp, lists)
    reads = needed_reads(inp)
    lum_p, a_p, f_p, n_p = plain(inp, reads)
    assert torch.equal(n_k, n_p), f"{what}: sample counts differ"
    assert torch.equal(f_k, f_p), f"{what}: first-hit planes differ"
    err = max(float((lum_k - lum_p).abs().max()),
              float((a_k - a_p).abs().max()))
    assert err <= 1e-5, f"{what}: lum/alpha differ by {err}"
    assert int(n_k.sum()) > 0 and float(a_k.max()) > 0.5
    log(f"  {what}: walk lists exact ({int(want.cnt.sum())} entries in "
        f"{want.cnt.numel()} tiles, {stats['windows']} windows, "
        f"{stats['words']} words in "
        f"{sum(int(stats[k].sum()) for k in ('coarse', 'cskip') if k in stats)}"
        f" map sectors), nsamp and first hits exact, lum/alpha "
        f"err {err:.3g}, samples {int(n_k.sum())} (past the intensity TF, "
        f"composited: {reads['passed'].tolist()})")
    return err, n_k, reads, stats


def walk_work(inp, stats) -> tuple:
    """(bytes, operations) of a sweep's walk: the five tile fields it
    reduces (17 B per cell), the 32-byte sectors of the coarse maps its
    windows read; per window, per word read and per cell its operations
    (``stats`` of the plain walk)."""
    cells = inp.wu.numel()
    sectors = sum(int(stats[k].sum()) for k in ("coarse", "cskip")
                  if k in stats)
    return (17 * cells + 32 * sectors,
            OPS_PER_WINDOW * stats["windows"] + OPS_PER_WORD * stats["words"]
            + OPS_PER_CELL * cells)


def walk_row(inp, stats, timer) -> dict:
    """The walk kernel's row: its time, the plain walk's, and its bound
    (``walk_work``, and the lists written: 2 B per entry, 4 B per
    tile's count)."""
    from vkvolume_tpu_torch.render import sweep_bricks, sweep_slabs

    if hasattr(inp, "cskip"):
        walk, plain = sweep_bricks.brick_walk, sweep_bricks.brick_walk_plain
    else:
        walk, plain = sweep_slabs.slab_walk, sweep_slabs.slab_walk_plain
    lists = walk(inp)
    nbytes, ops = walk_work(inp, stats)
    return dict(max_abs_err=0.0, ms=timer(lambda: walk(inp), 10),
                plain_ms=timer(lambda: plain(inp), 1, warm=0),
                **bound(nbytes + 2 * int(lists.cnt.sum())
                        + 4 * lists.cnt.numel(), ops))


def sweep_bound(inp, nsamp, reads, stats) -> dict:
    """bound_ms of a sweep (K1 or K7: walk + compositing) on ``inp``: the
    walk's work (``walk_work``); the 32-byte sectors of the volume and the
    gradient map that this run's samples need (``reads``, filled by the
    plain version: ESS leaps, ERT and the zero-intensity samples' gradient
    taps read nothing), kappa (4 B per cell) in, lum / alpha / first hit /
    count (4 B each) out; the operations of this run's samples, each
    charged only for the steps the kernel takes for it: ``nsamp`` (counted
    by the kernel) in range, ``reads["passed"]`` past the intensity TF and
    composited."""
    maps = [reads[k] for k in ("vol", "grad") if reads[k] is not None]
    needed = 32 * sum(int(s.sum()) for s in maps)
    log(f"  bound: the samples need {needed / 1e6:.3f} MB of the "
        f"{32 * sum(s.numel() for s in maps) / 1e6:.3f} MB of volume maps")
    walk_bytes, walk_ops = walk_work(inp, stats)
    past_intensity, composited = reads["passed"].tolist()
    grad = bool(inp.params["use_gradient"])
    ops = (OPS_IN_RANGE * total(nsamp) + OPS_COMPOSITE * composited
           + (OPS_GRADIENT * past_intensity if grad else 0))
    if inp.params.get("texture_tf"):
        ops += (OPS_TEXEL * total(nsamp)
                + (OPS_TEXEL * grad + OPS_TRUNCATE) * past_intensity)
    return bound(needed + 20 * inp.wu.numel() + walk_bytes, ops + walk_ops)


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_timer(fn, n: int, warm: int = 1, queued: bool = True) -> float:
    """Mean milliseconds per call of ``fn`` on the card (CUDA events over
    ``n`` calls after ``warm`` untimed ones). ``queued``: the calls wait
    behind a sleep on the card while the host issues them, so the time is
    the card's alone, not a wrapper's host time between short kernels."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    if queued:
        torch.cuda._sleep(SLEEP_CYCLES)
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
    from vkvolume_tpu_torch.bench.warp_probe import device_work
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
    # K3: two one-sided x-scans, four outputs of one y sense each; K4: 8
    # outputs of one z sense each.
    cells = occ.numel()
    rows["K3"] = dict(max_abs_err=0.0,
                      ms=timer(lambda: distance_cuda.scan_and_relax_multi(occ),
                               20),
                      plain_ms=timer(lambda: distance.scan_and_relax_multi(occ),
                                     2),
                      **distance_bound(1, 4, cells, 2, 1))
    rows["K4"] = dict(max_abs_err=0.0,
                      ms=timer(lambda: distance_cuda.relax_z_direct_multi(xy_k),
                               20),
                      plain_ms=timer(lambda: distance.relax_z_direct_multi(xy_k),
                                     2),
                      **distance_bound(4, 8, cells, 0, 1))
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
    err, n_k, reads, stats = hold_sweep(inp, "K1")
    # Timed with the main path's statics.
    inp = sweep_bricks.brick_inputs(vol_t, occ_t, eng._tf(v), u, grid,
                                    count_samples=False, **kw)
    rows["K1"] = dict(max_abs_err=err,
                      ms=timer(lambda: sweep_bricks.sweep_bricks_kernel(inp),
                               10),
                      plain_ms=timer(
                          lambda: sweep_bricks.sweep_bricks_reference(inp), 1),
                      **sweep_bound(inp, n_k, reads, stats))
    log(f"phase 2: K1 exact walk/nsamp/firsts, lum/alpha err {err:.3g}, grid "
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
    log(f"phase 2: K2 per pass: u16 within {d16} LSB, f32 err {err:.3g}; "
        f"positions {tuple(pos1.shape)} -> {tuple(pos2.shape)}")
    err = max(err, d16 / 65535.0)

    # The two-pass warp (two K2 launches, encode, transposes and decode
    # inside them) at the frame's shapes, in its variant and the other,
    # against its plain version; each call puts two kernels and nothing
    # else on the card.
    C = chans.shape[0]
    scales = [65535.0] * C
    for variant in (plan["warp_variant"], "AB".replace(plan["warp_variant"],
                                                       "")):
        fused, plain = warp_pair(variant)
        p1, p2 = sweep_frame.warp_positions(
            gx, gy, gp, hcoef, Hi=plan["Hi"], Wi=plan["Wi"],
            warp_variant=variant)
        got = fused(chans, p1, p2, scales=scales)
        d = float((got - plain(chans, p1, p2, scales=scales)).abs().max())
        assert d * 65535.0 <= 1.0 + 1e-6 * 65535.0, \
            f"two-pass warp {variant} differs by {d}"
        work = device_work(lambda: fused(chans, p1, p2, scales=scales))
        log(f"phase 2: two-pass warp {variant}: {tuple(chans.shape)} -> "
            f"{tuple(got.shape)}, err {d:.3g}; on the card per call: "
            f"{work['device_events']} events {work['names']}")
        assert work["device_events"] == 2 and work["copies"] == 0, \
            f"two-pass warp {variant}: {work}"
        if variant == plan["warp_variant"]:
            err = max(err, d)
            n1, n2 = p1.numel(), p2.numel()
            library, lib_err = warp_library(chans, p1, p2, variant)
            rows["K2"] = dict(
                max_abs_err=err,
                ms=timer(lambda: fused(chans, p1, p2, scales=scales), 20),
                plain_ms=timer(lambda: plain(chans, p1, p2, scales=scales),
                               3),
                library_ms=timer(library, 20),
                # Both passes: f32 channels and positions in, the u16
                # intermediate out and in again, f32 pixels out.
                **bound(4 * chans.numel() + 4 * n1 + 4 * C * n1 + 4 * n2
                        + 4 * C * n2, OPS_PER_CHANNEL * C * (n1 + n2)))
            log(f"phase 2: grid_sample per pass differs from the plain f32 "
                f"pass 1 by {lib_err:.3g} where it is not masked")
    return rows


def warp_pair(variant: str):
    """(the two-pass warp of ``variant``, its plain version)."""
    from vkvolume_tpu_torch.render import warp_cuda

    if variant == "B":
        return warp_cuda.warp_two_pass_b, warp_cuda.warp_two_pass_b_plain
    return warp_cuda.warp_two_pass, warp_cuda.warp_two_pass_plain


def warp_library(chans, pos1, pos2, variant: str):
    """The yardstick of the two-pass warp: one ``grid_sample`` call per
    pass computing the same lerp in f32 (rows as the batch, one-row
    inputs, ``align_corners=True``, border padding; no mask, no u16
    encoding; grids normalised once, outside the timing). Returns the
    call and its first pass's largest difference from the plain f32 pass
    where the positions are not masked."""
    import torch
    from vkvolume_tpu_torch.render import warp_cuda

    C, Hi, Wi = chans.shape
    n1, n2 = (Wi, Hi) if variant == "A" else (Hi, Wi)
    src1 = (chans.permute(1, 0, 2) if variant == "A"
            else chans.permute(2, 0, 1))[:, :, None]   # (lines, C, 1, n)

    def grid(pos, n_src):
        g = torch.zeros(pos.shape + (2,), device=pos.device)
        g[..., 0] = pos / (n_src - 1) * 2.0 - 1.0
        return g[:, None]                               # (lines, 1, n, 2)

    g1, g2 = grid(pos1, n1), grid(pos2, n2)

    def sample(src, g):
        return torch.nn.functional.grid_sample(
            src, g, mode="bilinear", padding_mode="border",
            align_corners=True)                         # (lines, C, 1, n)

    def library():
        return sample(sample(src1, g1).permute(3, 1, 2, 0), g2)

    first = sample(src1, g1)[:, :, 0].permute(1, 0, 2)  # (C, lines, n)
    want = warp_cuda.resample_pass_plain(chans, pos1,
                                         column_src=variant == "B")
    inside = (pos1 > -5.0)[None]
    err = float(torch.where(inside, first - want, 0.0).abs().max())
    assert err <= 1e-4, f"grid_sample pass 1 differs by {err}"
    return library, err


def reset_launches():
    from vkvolume_tpu_torch.accel import distance_cuda
    from vkvolume_tpu_torch.render import sweep_bricks, sweep_slabs, warp_cuda

    for table in (distance_cuda.LAUNCHES, sweep_bricks.LAUNCHES,
                  sweep_slabs.LAUNCHES, warp_cuda.LAUNCHES):
        for k in table:
            table[k] = 0


def read_launches():
    from vkvolume_tpu_torch.accel import distance_cuda
    from vkvolume_tpu_torch.render import sweep_bricks, sweep_slabs, warp_cuda

    return {"K1": sweep_bricks.LAUNCHES["sweep_bricks"],
            "K1 texture": sweep_bricks.LAUNCHES["sweep_bricks_texture"],
            "K2": warp_cuda.LAUNCHES["resample_rows"],
            "K3": distance_cuda.LAUNCHES["scan_and_relax_multi"],
            "K4": distance_cuda.LAUNCHES["relax_z_direct_multi"],
            "K4 two-sided": distance_cuda.LAUNCHES["relax_z_direct"],
            "K5": distance_cuda.LAUNCHES["scan_and_relax"],
            "K6": distance_cuda.LAUNCHES["relax"],
            "K7": sweep_slabs.LAUNCHES["sweep_slabs"],
            "K8": warp_cuda.LAUNCHES["warp_to_pixels"],
            "K1 walk": sweep_bricks.LAUNCHES["brick_walk"],
            "K7 walk": sweep_slabs.LAUNCHES["slab_walk"]}


def plain_frame(eng, cam, width=WIDTH, height=HEIGHT):
    """The same frame with K1, K2, K7 and K8 swapped for their plain
    versions (the maps are the kernels', held bit-exact to the plain maps
    in phases 2 and 4)."""
    from vkvolume_tpu_torch.render import sweep_bricks, sweep_slabs, warp_cuda

    saved = (sweep_bricks.sweep_bricks_kernel, warp_cuda.warp_two_pass,
             warp_cuda.warp_two_pass_b, sweep_slabs.sweep_slabs_kernel,
             warp_cuda.warp_to_pixels)
    sweep_bricks.sweep_bricks_kernel = sweep_bricks.sweep_bricks_reference
    warp_cuda.warp_two_pass = warp_cuda.warp_two_pass_plain
    warp_cuda.warp_two_pass_b = warp_cuda.warp_two_pass_b_plain
    sweep_slabs.sweep_slabs_kernel = sweep_slabs.sweep_slabs_plain
    warp_cuda.warp_to_pixels = warp_cuda.warp_to_pixels_plain
    try:
        return eng.render(cam, width, height)
    finally:
        (sweep_bricks.sweep_bricks_kernel, warp_cuda.warp_two_pass,
         warp_cuda.warp_two_pass_b, sweep_slabs.sweep_slabs_kernel,
         warp_cuda.warp_to_pixels) = saved


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
    assert all(launches[k] > 0 for k in ("K1", "K1 walk", "K2", "K3",
                                         "K4")), \
        "a kernel of the path never ran"
    assert launches["K1 walk"] == launches["K1"]

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
    return frame_ms, st.map_update_ms, launches


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
    assert all(launches[k] > 0 for k in ("K1", "K1 walk", "K2",
                                         "K4 two-sided", "K5")), \
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
    # K5: the two passes of the two-sided x-scan, the y-relax in two
    # senses; the two-sided K4: the z-relax in two senses.
    rows["K5"] = dict(max_abs_err=0.0,
                      ms=timer(lambda: distance_cuda.scan_and_relax(occ), 20),
                      plain_ms=timer(lambda: distance.scan_and_relax(
                          occ, 0, (0,)), 2),
                      **distance_bound(1, 1, occ.numel(), 2, 2))
    rows["K4 two-sided"] = dict(
        max_abs_err=0.0,
        ms=timer(lambda: distance_cuda.relax_z_direct(xy_k[0]), 20),
        plain_ms=timer(lambda: distance.relax_z_direct(xy_k[0], (0,)), 2),
        **distance_bound(1, 1, occ.numel(), 0, 2))
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
    err, n_k, reads, stats = hold_sweep(inp, "K1 (gradient + lerp)")
    inp = sweep_bricks.brick_inputs(vol_t, occ_t, tf, u, grid,
                                    count_samples=False, **kw)
    rows["K1 gradient + lerp"] = dict(
        max_abs_err=err,
        ms=timer(lambda: sweep_bricks.sweep_bricks_kernel(inp), 10),
        plain_ms=timer(lambda: sweep_bricks.sweep_bricks_reference(inp), 1),
        **sweep_bound(inp, n_k, reads, stats))
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
    map_reps = [timer(lambda: eng.update_transfer_function(v), 20,
                      queued=False) for _ in range(REPS)]
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
    return rows, launches, frame_ms, map_ms, eng


def phase_accel(eng, timer):
    """K6 through the accel API: one two-sided z relaxation of K5's output
    completes the isotropic map, which must be the engine's; then K6
    against its plain version on both axes and in all senses."""
    import torch
    from vkvolume_tpu_torch.accel import distance, distance_cuda
    from vkvolume_tpu_torch.accel.occupancy import (_occupancy_u8,
                                                    _tf_thresholds)

    v = eng.volumes[0]
    o = v.options
    ti, tg = _tf_thresholds((o.intensity_min, o.intensity_max,
                             o.gradient_min, o.gradient_max))
    occ = _occupancy_u8(v.density, v.gradient, v.map_shape_zyx, ti, tg)
    torch.cuda.synchronize()
    reset_launches()
    iso = distance_cuda.relax(distance_cuda.scan_and_relax(occ)[0], 0, 0)
    torch.cuda.synchronize()
    launches = read_launches()
    log(f"phase 4: accel API launches {launches}")
    assert launches["K6"] > 0, "K6 never ran"
    assert torch.equal(iso, v.dist_maps[0]), \
        "K5 + K6 isotropic map differs from the engine's"
    xy = distance_cuda.scan_and_relax(occ)[0]
    xs = distance.axis_scan(occ, 2, 0).clamp(max=255).to(torch.uint8)
    for src in (xs, xy):
        for axis in (0, 1):
            for direction in (0, 1, -1):
                assert torch.equal(
                    distance_cuda.relax(src, axis, direction),
                    distance.relax(src, axis, direction).to(torch.uint8)), \
                    f"K6 axis {axis} direction {direction} differs"
    row = dict(max_abs_err=0.0,
               ms=timer(lambda: distance_cuda.relax(xy, 0, 0), 20),
               plain_ms=timer(lambda: distance.relax(xy, 0, 0), 2),
               **distance_bound(1, 1, xy.numel(), 0, 2))
    log(f"phase 4: K6 bit-exact (axes 0 and 1, senses 0, +1, -1) on "
        f"{tuple(xs.shape)}; K5 + K6 = the engine's isotropic map")
    return {"K6": row}, launches


def route_of(launches) -> tuple:
    """(sweep, warp) of one frame from its kernel launches."""
    sweep = "K1" if launches["K1"] else "K7" if launches["K7"] else None
    warp = ("K2" if launches["K2"] else "K8" if launches["K8"]
            else "gather")
    return sweep, warp


def phase_orbit(timer, out_dir):
    """(a) the still frame through K7 + K8, (b) the benchmark orbit."""
    import torch
    from vkvolume_tpu_torch import cli
    from vkvolume_tpu_torch.bench.harness import benchmark_camera, capture
    from vkvolume_tpu_torch.bench.warp_probe import capture_k8
    from vkvolume_tpu_torch.render import (sweep_bricks, sweep_frame,
                                           sweep_slabs)
    from vkvolume_tpu_torch.render.ray_setup import make_rays
    from vkvolume_tpu_torch.utils.image import read_png

    rows = {}
    png = os.path.join(out_dir, "still.png")
    reset_launches()
    eng, _, out = cli.run(["--synth", "beetle", "--azimuth",
                           str(STILL_AZIMUTH), "--sampling",
                           str(STILL_SAMPLING), "--output", png])
    torch.cuda.synchronize()
    launches_a = read_launches()
    log(f"phase 5a: launches {launches_a}")
    assert all(launches_a[k] > 0 for k in ("K7", "K7 walk", "K8")), \
        "K7 or K8 never ran on the still frame"
    assert route_of(launches_a) == ("K7", "K8")
    v = eng.volumes[0]
    cam = cli.cli_camera(CLI_WIDTH, CLI_HEIGHT, STILL_AZIMUTH)
    pose, vol_t, occ_t = frame_pose(eng, cam)
    plan, p = pose["plan_narrow"], pose["view"]["p_axis"]
    tf = eng._tf(v)
    n_slabs = int(max(2, round(vol_t.shape[0] * eng._slab_oversample(
        v, vol_t.shape, tf))))
    log(f"phase 5a: plan rect_w {pose['plan']['rect_w']} -> narrowed "
        f"Hi={plan['Hi']} Wi={plan['Wi']} R_sweep={plan['R_sweep']} "
        f"R_warp={plan['R_warp']} RECT_A={plan['RECT_A']} p_axis={p} "
        f"vol_t={tuple(vol_t.shape)} n_slabs={n_slabs}")
    assert pose["plan"]["rect_w"] > 256 and plan["rect_w"] == 256
    assert plan["R_warp"] is not None and plan["RECT_A"] is None
    assert n_slabs < vol_t.shape[0], "expected fewer slabs than planes"
    color = out.color
    assert tuple(color.shape) == (CLI_HEIGHT, CLI_WIDTH, 4)
    assert bool(torch.isfinite(color).all())
    img = read_png(png)
    covered = float((img.max(axis=-1) > 0).mean())
    log(f"phase 5a: PNG {img.shape} covered share {covered:.4f}, u8 mean "
        f"{img.mean():.3f}")
    assert img.shape == (CLI_HEIGHT, CLI_WIDTH, 3)
    assert covered >= MIN_COVERED, f"PNG nearly empty ({covered})"
    check_against_plain_frame(eng, cam, color, CLI_WIDTH, CLI_HEIGHT,
                              "phase 5a")
    eng.render(cam, CLI_WIDTH, CLI_HEIGHT)
    torch.cuda.synchronize()
    reps, _ = frame_reps(eng, cam, CLI_WIDTH, CLI_HEIGHT)
    still_ms = statistics.median(reps)
    log(f"phase 5a: ms/frame median={still_ms:.4f} reps="
        f"{[round(r, 4) for r in reps]} ({FRAMES} frames x {REPS} reps, "
        f"{CLI_WIDTH}x{CLI_HEIGHT}, K7 + K8)")

    # K7 on this frame's own inputs: the gradient TF of the path, and the
    # intensity-only variant on the same rays and maps.
    u, pvm, gp, _ = sweep_frame.unpack_frame_scalars(pose["packed"])
    dev = vol_t.device
    wu, wv = sweep_frame.w_grid(gp, plan["Hi"], plan["Wi"], dev)
    rays = sweep_frame.grid_rays(u, wu, wv, p, plan["sgn_p"])
    grad_t = v._sweep_cache[("grad", p)]
    kw = dict(p_axis=p, ert=eng.options.early_ray_termination,
              n_slabs=n_slabs, dist_leap=True, separable=True)
    for variant, g in (("gradient", grad_t), ("intensity", None)):
        inp = sweep_slabs.slab_inputs(vol_t, occ_t, tf, rays, u, g,
                                      count_samples=True, **kw)
        assert bool(inp.params["use_gradient"]) == (g is not None)
        err, n_k, reads, stats = hold_sweep(inp, f"K7 ({variant})")
        log(f"phase 5a: K7 {variant} TF exact nsamp/firsts, lum/alpha err "
            f"{err:.3g}, samples={int(n_k.sum())}")
        if g is not None:
            timed = sweep_slabs.slab_inputs(vol_t, occ_t, tf, rays, u, g,
                                            count_samples=False, **kw)
            rows["K7"] = dict(
                max_abs_err=err,
                ms=timer(lambda: sweep_slabs.sweep_slabs_kernel(timed), 10),
                plain_ms=timer(lambda: sweep_slabs.sweep_slabs_plain(timed),
                               1),
                **sweep_bound(timed, n_k, reads, stats))

    # K8 on this frame's grid channels and pixel positions.
    grid_out = sweep_slabs.sweep_slabs(
        vol_t, occ_t, tf, rays, u, pvm, grad_t, p_axis=p,
        ert=eng.options.early_ray_termination,
        n_slabs=n_slabs, separable=True, dist_leap=True)
    chans = torch.stack([grid_out.color[..., 0], grid_out.color[..., 3],
                         grid_out.depth]).contiguous()
    gx, gy = sweep_frame.pixel_grid_coords(
        make_rays(u, CLI_HEIGHT, CLI_WIDTH, dev), gp, p)
    rows["K8"] = k8_row(chans, gx.contiguous(), gy.contiguous(), timer,
                        "phase 5a")
    del eng, grid_out, chans, gx, gy, rays, inp, timed
    torch.cuda.empty_cache()

    # (b) The benchmark orbit.
    buf = io.StringIO()
    reset_launches()
    with contextlib.redirect_stdout(buf):
        eng, _, bout = cli.run(["--synth", "beetle", "--benchmark",
                                str(CLI_BENCH_FRAMES), "--orbit", "5"])
    torch.cuda.synchronize()
    launches_b = read_launches()
    for line in buf.getvalue().splitlines():
        log(f"phase 5b --benchmark {CLI_BENCH_FRAMES} --orbit 5: {line}")
    log(f"phase 5b: renderer_counts {eng.renderer_counts}")
    log(f"phase 5b: launches {launches_b}")
    assert f"ran {CLI_BENCH_FRAMES} frames, averaged " in buf.getvalue()
    assert all(launches_b[k] > 0 for k in ("K1", "K1 walk", "K2", "K7",
                                           "K7 walk", "K8")), \
        "a kernel of the orbit never ran"
    assert eng.renderer_counts.get("pallas_xla_warp", 0) > 0
    assert eng.renderer_counts["pallas"] == CLI_BENCH_FRAMES + 1
    assert bool(torch.isfinite(bout.color).all())
    tiers = {}
    aspect = CLI_WIDTH / CLI_HEIGHT
    for az, route in ORBIT_POSES.items():
        cam = benchmark_camera(aspect, az, 20.0)
        reset_launches()
        color = eng.render(cam, CLI_WIDTH, CLI_HEIGHT).color
        torch.cuda.synchronize()
        got = route_of(read_launches())
        assert got == route, f"azimuth {az}: route {got}, expected {route}"
        ms = timer(lambda: eng.render(cam, CLI_WIDTH, CLI_HEIGHT), 5)
        tiers[az] = ms
        log(f"phase 5b: azimuth {az:.0f} {got[0]} + {got[1]}: {ms:.4f} "
            f"ms/frame ({CLI_WIDTH}x{CLI_HEIGHT}, benchmark mode)")
        if az != 30.0:
            check_against_plain_frame(eng, cam, color, CLI_WIDTH, CLI_HEIGHT,
                                      f"phase 5b azimuth {az:.0f}")

    # The orbit's largest sweeps on the inputs its frames hand them: K1's
    # gradient + lerp variant at tile_h 32 (azimuth 90) and K7 on the
    # 6 M-cell grid of azimuth 40; then each sweep's walk kernel alone.
    for az, sweep in ((90.0, "K1"), (40.0, "K7")):
        got, inp = capture(eng, benchmark_camera(aspect, az, 20.0),
                           CLI_WIDTH, CLI_HEIGHT)
        p = inp.params
        assert got == sweep and p["count_samples"] and not p["ert"]
        assert p["use_gradient"] and p.get("tile_h", 32) == 32
        err, n_k, reads, stats = hold_sweep(
            inp, f"phase 5b: {sweep} azimuth {az:.0f}")
        kernel, plain = ((sweep_bricks.sweep_bricks_kernel,
                          sweep_bricks.sweep_bricks_reference)
                         if sweep == "K1" else
                         (sweep_slabs.sweep_slabs_kernel,
                          sweep_slabs.sweep_slabs_plain))
        rows[f"{sweep} orbit"] = dict(
            max_abs_err=err, ms=timer(lambda: kernel(inp), 10),
            plain_ms=timer(lambda: plain(inp), 1, warm=0),
            **sweep_bound(inp, n_k, reads, stats))
        rows[f"{sweep} walk"] = walk_row(inp, stats, timer)
        log(f"phase 5b: {sweep} azimuth {az:.0f}: grid {p['H']}x{p['W']}, "
            f"{rows[f'{sweep} orbit']['ms']:.4f} ms (walk "
            f"{rows[f'{sweep} walk']['ms']:.4f} ms)")

    # K8 on what the orbit's azimuth-90 frame hands it (4 channels: the
    # sample count too).
    rows["K8 orbit"] = k8_row(
        *capture_k8(eng, benchmark_camera(aspect, 90.0, 20.0), CLI_WIDTH,
                    CLI_HEIGHT), timer, "phase 5b: azimuth 90")
    return rows, launches_a, launches_b, still_ms, tiers


def k8_row(chans, gx, gy, timer, phase) -> dict:
    """K8 held exact to its plain version (and ``grid_sample`` to it within
    1e-4) on one frame's inputs, every covered tile staged (the kernel's
    tile counters); its row: ``ms`` cold (a rotation over input copies
    three times the L2), ``library_ms`` the same for ``grid_sample``, both
    also logged warm; the bound from the grid sectors the taps touch, gx
    and the gy sectors that hold a covered pixel."""
    import torch
    from vkvolume_tpu_torch.bench.warp_probe import (
        cold_copies, grid_sample_positions, grid_sample_warp, k8_bytes,
        rotated_ms)
    from vkvolume_tpu_torch.render import warp_cuda

    C, Hi, Wi = chans.shape
    paths = torch.zeros(4, dtype=torch.int32, device=chans.device)
    w_k = warp_cuda.warp_to_pixels(chans, gx, gy, tile_paths=paths)
    w_p = warp_cuda.warp_to_pixels_plain(chans, gx, gy)
    err = float((w_k - w_p).abs().max())
    assert err == 0.0, f"{phase}: K8 differs by {err}"
    got = dict(zip(("empty", "staged", "two_passes", "direct"),
                   paths.tolist()))
    log(f"{phase}: K8 tiles {got}")
    tiles = -(-gx.shape[0] // 16) * -(-gx.shape[1] // 32)
    assert sum(got.values()) == tiles and got["direct"] == 0, \
        f"{phase}: K8 tiles {got} of {tiles}"
    grid = grid_sample_positions(gx, gy, Hi, Wi)
    # Lum, alpha and depth lie in [0, 1]; the sample count (4th channel)
    # reaches hundreds, and grid_sample's round trip through normalised
    # coordinates moves a tap by ~1e-4 texel: that channel is held
    # relative to its largest count.
    diff = (grid_sample_warp(chans, grid, gx) - w_p).abs().amax((1, 2))
    lib_err = float(diff[:3].max())
    assert lib_err <= 1e-4, f"{phase}: grid_sample differs by {lib_err}"
    if C == 4:
        count_err = float(diff[3]) / max(1.0, float(w_p[3].abs().max()))
        log(f"{phase}: grid_sample's sample counts differ by "
            f"{float(diff[3]):.3g}, {count_err:.3g} of the largest")
        assert count_err <= 1e-3, \
            f"{phase}: grid_sample's counts differ by {count_err}"
    nb = k8_bytes(chans, gx, gy)
    ops = (OPS_PER_PIXEL + OPS_PER_CHANNEL * C) * gx.numel()
    k8_in = cold_copies((chans, gx, gy), nb["whole"])
    lib_in = cold_copies((chans, grid, gx), nb["whole"])
    row = dict(
        max_abs_err=err,
        ms=rotated_ms(warp_cuda.warp_to_pixels, k8_in, 5 * len(k8_in)),
        plain_ms=timer(lambda: warp_cuda.warp_to_pixels_plain(chans, gx, gy),
                       5),
        library_ms=rotated_ms(grid_sample_warp, lib_in, 5 * len(lib_in)),
        **bound(nb["bound"], ops))
    warm = timer(lambda: warp_cuda.warp_to_pixels(chans, gx, gy), 20)
    lib_warm = timer(lambda: grid_sample_warp(chans, grid, gx), 20)
    old = bound(nb["whole"], ops)
    log(f"{phase}: K8 exact on ({C}, {Hi}, {Wi}) -> {tuple(gx.shape)}; "
        f"grid_sample differs from it by {lib_err:.3g}; cold {row['ms']:.4f}"
        f" ms ({len(k8_in)} input copies), warm {warm:.4f} ms (L2); "
        f"grid_sample cold {row['library_ms']:.4f}, warm {lib_warm:.4f} ms;"
        f" bound {row['bound_ms']:.4f} ms from {nb['bound']} bytes (grid "
        f"sectors the taps touch {nb['grid_sectors']}, gx {nb['gx']}, gy "
        f"sectors of covered pixels {nb['gy_sectors']}, out {nb['out']}; the"
        f" whole grid and both positions: {nb['whole']} bytes, "
        f"{old['bound_ms']:.4f} ms)")
    return row


def synced_ms(fn, reps: int = XLA_SWEEP_REPS) -> list:
    """Host milliseconds of ``reps`` calls of ``fn``, each ended by a
    synchronise (after one untimed call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def phase_texture(timer, out_dir):
    """(a) the CLI frame with the texture TF through K1's texture variant,
    (b) the XLA sweep at that pose and on the side view, (c) the texture
    orbit."""
    import torch
    from vkvolume_tpu_torch import cli
    from vkvolume_tpu_torch.render import sweep_bricks, sweep_frame
    from vkvolume_tpu_torch.utils.image import read_png

    rows, sweep_ms = {}, {}
    png = os.path.join(out_dir, "texture.png")
    reset_launches()
    eng, _, out = cli.run(["--synth", "beetle", "--texture-tf", "--output",
                           png])
    torch.cuda.synchronize()
    launches = read_launches()
    log(f"phase 6a: launches {launches}")
    assert launches["K1 texture"] > 0 and launches["K1 walk"] > 0 \
        and launches["K2"] > 0, "K1's texture variant or K2 never ran"
    assert launches["K1"] == 0 and launches["K7"] == 0
    assert eng.renderer_counts["sweep"] == 0 and eng.last_renderer == "pallas"
    v = eng.volumes[0]
    cam = cli.cli_camera(CLI_WIDTH, CLI_HEIGHT)
    pose, vol_t, occ_t = frame_pose(eng, cam)
    plan, p = pose["plan"], pose["view"]["p_axis"]
    assert plan["R_brick"] is not None and plan["RECT_A"] is not None
    tf = eng._tf(v)
    n_slabs = int(max(2, round(vol_t.shape[0] * eng._slab_oversample(
        v, vol_t.shape, tf))))
    assert tf.use_gradient and n_slabs > vol_t.shape[0]

    # K1's texture variant on this frame's inputs: exact.
    u, _, gp, _ = sweep_frame.unpack_frame_scalars(pose["packed"])
    wu_g, wv_g = sweep_frame.w_grid(gp, plan["Hi"], plan["Wi"], vol_t.device)
    sgn = 1 if plan["sgn_p"] > 0 else -1
    s_lo, s_hi, cov, kappa = sweep_bricks.grid_fields(
        u, wu_g, wv_g, sgn, p, max(vol_t.shape), n_slabs)
    grid = (wu_g, wv_g, s_lo, s_hi, kappa, cov)
    kw = dict(p_axis=p, ert=eng.options.early_ray_termination,
              n_slabs=n_slabs, sgn=sgn, tile_h=plan["tile_h"], dist_leap=True,
              grad_t=v._sweep_cache[("grad", p)], texture_tf=True)
    inp = sweep_bricks.brick_inputs(vol_t, occ_t, tf, u, grid,
                                    count_samples=True, **kw)
    err, n_k, reads, stats = hold_sweep(inp, "K1 texture (gradient + lerp)")
    assert err == 0.0, f"K1 texture: lum/alpha differ by {err}"
    inp = sweep_bricks.brick_inputs(vol_t, occ_t, tf, u, grid,
                                    count_samples=False, **kw)
    rows["K1 texture"] = dict(
        max_abs_err=err,
        ms=timer(lambda: sweep_bricks.sweep_bricks_kernel(inp), 10),
        plain_ms=timer(lambda: sweep_bricks.sweep_bricks_reference(inp), 1),
        **sweep_bound(inp, n_k, reads, stats))
    log(f"phase 6a: K1 texture exact walk/nsamp/firsts/lum/alpha, grid "
        f"{plan['Hi']}x{plan['Wi']} tile_h={plan['tile_h']} "
        f"samples={int(n_k.sum())}: {rows['K1 texture']['ms']:.4f} ms")
    del inp

    color = out.color
    assert tuple(color.shape) == (CLI_HEIGHT, CLI_WIDTH, 4)
    assert bool(torch.isfinite(color).all())
    check_against_plain_frame(eng, cam, color, CLI_WIDTH, CLI_HEIGHT,
                              "phase 6a")
    eng.options.texture_tf = False
    closed = eng.render(cam, CLI_WIDTH, CLI_HEIGHT).color
    eng.options.texture_tf = True
    # The JAX engine's closed-form-vs-texture bounds (tests/test_engine.py:
    # max 0.06, mean 5e-3 on a 32x32 frame). At this pose and size the JAX
    # package's own gap passes 0.06 at every scale its CPU run can take
    # (scripts/texture_gap.py, XLA sweep: max 0.0685 / 0.1216 / 0.0887 at
    # scale 0.25 / 0.5 / 0.75 on 0.005-0.022 % of the pixels; the port's
    # gap is the same there, and its XLA sweep's at full scale on the H100
    # puts more pixels beyond 0.06 than this frame), so the max becomes
    # the share of such pixels, held to the JAX package's cross-route
    # share (CROSS_BAD_SHARE).
    d = (closed - color).abs()
    bad = float((d.amax(dim=-1) > CROSS_TOL).float().mean())
    log(f"phase 6a: texture vs closed-form frame: max {float(d.max()):.4g} "
        f"mean {float(d.mean()):.4g} share > {CROSS_TOL}: {bad:.4g}")
    assert bad < CROSS_BAD_SHARE and float(d.mean()) < 5e-3
    assert float(d.max()) > 0.0, "the texture frame is the closed form's"
    img = read_png(png)
    covered = float((img.max(axis=-1) > 0).mean())
    log(f"phase 6a: PNG {img.shape} covered share {covered:.4f}")
    assert img.shape == (CLI_HEIGHT, CLI_WIDTH, 3)
    assert covered >= MIN_COVERED, f"PNG nearly empty ({covered})"
    eng.render(cam, CLI_WIDTH, CLI_HEIGHT)
    torch.cuda.synchronize()
    reps, _ = frame_reps(eng, cam, CLI_WIDTH, CLI_HEIGHT)
    tex_ms = statistics.median(reps)
    log(f"phase 6a: ms/frame median={tex_ms:.4f} reps="
        f"{[round(r, 4) for r in reps]} ({FRAMES} frames x {REPS} reps, "
        f"{CLI_WIDTH}x{CLI_HEIGHT}, K1 texture + K2)")

    # (b) The XLA sweep: the same pose, then the side view.
    eng.renderer = "sweep"
    reset_launches()
    swept = eng.render(cam, CLI_WIDTH, CLI_HEIGHT).color
    torch.cuda.synchronize()
    assert eng.last_renderer == "sweep" and eng.renderer_counts["sweep"] == 1
    assert not any(read_launches().values()), "the XLA sweep ran a kernel"
    d = (swept - color).abs()
    bad = float((d > CROSS_TOL).float().mean())
    da = abs(float(swept[..., 3].mean()) - float(color[..., 3].mean()))
    log(f"phase 6b: XLA sweep vs K1 texture frame: share > {CROSS_TOL}: "
        f"{bad:.4g}, mean alpha diff {da:.4g}, max {float(d.max()):.4g}")
    assert bad < CROSS_BAD_SHARE and da < CROSS_ALPHA_MEAN
    reps = synced_ms(lambda: eng.render(cam, CLI_WIDTH, CLI_HEIGHT))
    sweep_ms["cli"] = statistics.median(reps)
    log(f"phase 6b: XLA sweep ms/frame median={sweep_ms['cli']:.4f} reps="
        f"{[round(r, 4) for r in reps]} ({CLI_WIDTH}x{CLI_HEIGHT}, "
        f"{n_slabs} slabs, CLI pose)")
    del eng, out, color, closed, swept, d
    torch.cuda.empty_cache()

    png = os.path.join(out_dir, "texture_side.png")
    reset_launches()
    eng, _, out = cli.run(["--synth", "beetle", "--texture-tf", "--azimuth",
                           str(STILL_AZIMUTH), "--sampling",
                           str(STILL_SAMPLING), "--output", png])
    torch.cuda.synchronize()
    side = read_launches()
    log(f"phase 6b: side view launches {side}, renderer_counts "
        f"{eng.renderer_counts}")
    assert eng.renderer_counts["sweep"] == 1 \
        and eng.renderer_counts["pallas"] == 0
    assert side["K1"] == side["K1 texture"] == side["K7"] == 0
    assert bool(torch.isfinite(out.color).all())
    img = read_png(png)
    covered = float((img.max(axis=-1) > 0).mean())
    log(f"phase 6b: side view PNG covered share {covered:.4f}")
    assert covered >= MIN_COVERED, f"PNG nearly empty ({covered})"
    cam = cli.cli_camera(CLI_WIDTH, CLI_HEIGHT, STILL_AZIMUTH)
    reps = synced_ms(lambda: eng.render(cam, CLI_WIDTH, CLI_HEIGHT))
    sweep_ms["side"] = statistics.median(reps)
    log(f"phase 6b: XLA sweep ms/frame median={sweep_ms['side']:.4f} reps="
        f"{[round(r, 4) for r in reps]} ({CLI_WIDTH}x{CLI_HEIGHT}, side "
        f"view)")
    del eng, out
    torch.cuda.empty_cache()

    # (c) The texture orbit.
    buf = io.StringIO()
    reset_launches()
    with contextlib.redirect_stdout(buf):
        eng, _, bout = cli.run(["--synth", "beetle", "--texture-tf",
                                "--benchmark", str(CLI_BENCH_FRAMES),
                                "--orbit", "5"])
    torch.cuda.synchronize()
    orbit_launches = read_launches()
    for line in buf.getvalue().splitlines():
        log(f"phase 6c --texture-tf --benchmark {CLI_BENCH_FRAMES} "
            f"--orbit 5: {line}")
    log(f"phase 6c: renderer_counts {eng.renderer_counts}")
    log(f"phase 6c: launches {orbit_launches}")
    assert f"ran {CLI_BENCH_FRAMES} frames, averaged " in buf.getvalue()
    assert orbit_launches["K1 texture"] > 0 and orbit_launches["K1"] == 0
    assert orbit_launches["K7"] == 0
    counts = eng.renderer_counts
    assert counts["sweep"] >= 1
    assert counts["sweep"] + counts["pallas"] == CLI_BENCH_FRAMES + 1
    assert bool(torch.isfinite(bout.color).all())
    return rows, launches, orbit_launches, tex_ms, sweep_ms


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
    frame_ms, map_ms, launches = phase_frame(eng, cam)
    del eng
    with tempfile.TemporaryDirectory() as out_dir:
        cli_rows, cli_launches, cli_ms, cli_map_ms, cli_eng = phase_cli(
            gpu_timer, out_dir)
        accel_rows, accel_launches = phase_accel(cli_eng, gpu_timer)
        del cli_eng
        torch.cuda.empty_cache()
        orbit_rows, still_launches, orbit_launches, still_ms, tiers = \
            phase_orbit(gpu_timer, out_dir)
        torch.cuda.empty_cache()
        tex_rows, tex_launches, tex_orbit_launches, tex_ms, sweep_ms = \
            phase_texture(gpu_timer, out_dir)
    for more in (cli_rows, accel_rows, orbit_rows, tex_rows):
        rows.update(more)
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
        "K1 texture": (
            "sweep_bricks (texture TF + gradient TF, plane-pair lerp; CLI "
            "frame with --texture-tf)", tex_launches["K1 texture"],
            "vkvolume_tpu_torch/csrc/sweep_bricks.cu",
            "vkvolume_tpu/render/sweep_bricks.py:456"),
        "K2": ("resample_pass (the two-pass warp: 2 launches per frame; ms "
               "per frame)",
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
        "K6": ("relax (one relaxation, z two-sided; accel API)",
               accel_launches["K6"], "vkvolume_tpu_torch/csrc/distance.cu",
               "vkvolume_tpu/accel/distance_pallas.py:175"),
        "K1 orbit": (
            "sweep_bricks (gradient TF, plane-pair lerp, tile_h 32; orbit "
            "azimuth 90)", orbit_launches["K1"],
            "vkvolume_tpu_torch/csrc/sweep_bricks.cu",
            "vkvolume_tpu/render/sweep_bricks.py:56"),
        "K1 walk": ("brick_walk (K1's walk alone; orbit azimuth 90)",
                    orbit_launches["K1 walk"],
                    "vkvolume_tpu_torch/csrc/sweep_bricks.cu",
                    "vkvolume_tpu/render/sweep_bricks.py:56"),
        "K7": ("sweep_slabs (gradient TF; narrowed still frame)",
               still_launches["K7"], "vkvolume_tpu_torch/csrc/sweep_slabs.cu",
               "vkvolume_tpu/render/sweep_pallas.py:58"),
        "K7 orbit": ("sweep_slabs (gradient TF; orbit azimuth 40)",
                     orbit_launches["K7"],
                     "vkvolume_tpu_torch/csrc/sweep_slabs.cu",
                     "vkvolume_tpu/render/sweep_pallas.py:58"),
        "K7 walk": ("slab_walk (K7's walk alone; orbit azimuth 40)",
                    orbit_launches["K7 walk"],
                    "vkvolume_tpu_torch/csrc/sweep_slabs.cu",
                    "vkvolume_tpu/render/sweep_pallas.py:58"),
        "K8": ("warp_to_pixels (3 channels; narrowed still frame; ms cold)",
               still_launches["K8"], "vkvolume_tpu_torch/csrc/warp_pixels.cu",
               "vkvolume_tpu/render/warp_pallas.py:26"),
        "K8 orbit": ("warp_to_pixels (4 channels; orbit azimuth 90; ms cold)",
                     orbit_launches["K8"],
                     "vkvolume_tpu_torch/csrc/warp_pixels.cu",
                     "vkvolume_tpu/render/warp_pallas.py:26"),
    }
    kernels = []
    for k, (name, n, source, replaces) in where.items():
        r = rows[k]
        lib = r.get("library_ms")
        log(f"{k} {name}: {r['ms']:.4f} ms vs plain {r['plain_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), library "
            f"{'none' if lib is None else f'{lib:.4f} ms'} (max abs err "
            f"{r['max_abs_err']:.3g}, launches {n})")
        kernels.append({"name": f"{k.split()[0]} {name}", "route": "cuda",
                        "source": source, "replaces": replaces,
                        "launches": n, "max_abs_err": r["max_abs_err"],
                        "ms": r["ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                        "library_ms": lib})
    log(f"frame_ms_median {frame_ms:.4f} map_update_ms {map_ms:.4f} "
        f"({WIDTH}x{HEIGHT}, skipmode 3)")
    log(f"cli_frame_ms_median {cli_ms:.4f} cli_map_update_ms {cli_map_ms:.4f} "
        f"({CLI_WIDTH}x{CLI_HEIGHT}, skipmode 2, gradient TF)")
    log(f"still_k7_k8_frame_ms_median {still_ms:.4f} (azimuth "
        f"{STILL_AZIMUTH:.0f}, sampling {STILL_SAMPLING}, {CLI_WIDTH}x"
        f"{CLI_HEIGHT}); orbit ms/frame by azimuth "
        + ", ".join(f"{az:.0f}: {ms:.4f}" for az, ms in tiers.items()))
    log(f"orbit launches {orbit_launches}")
    log(f"texture_cli_frame_ms_median {tex_ms:.4f} (K1 texture + K2, "
        f"{CLI_WIDTH}x{CLI_HEIGHT}); xla_sweep_ms_median CLI pose "
        f"{sweep_ms['cli']:.4f}, side view {sweep_ms['side']:.4f} "
        f"({XLA_SWEEP_REPS} synced reps each)")
    log(f"texture orbit launches {tex_orbit_launches}")
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
