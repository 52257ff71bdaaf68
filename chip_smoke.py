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
     main path's shapes (the occupancy kernel, intensity TF, and K3+K4
     bit-exact; K1's walk lists equal to the plain walk's, its sample
     counts and first-hit planes exact, lum and alpha within 1e-5 of the
     plain sweep; K2 per pass u16 within 1 LSB, f32 within 1e-6 of full
     scale, and the whole two-pass warp of the frame's channels in both
     variants within 1 LSB of the plain warp, each call two kernels and no
     other work on the card; the frame glue's three kernels at the frame's
     pose, the grid fields bit-exact, the warp's positions within 2e-5
     relative, the epilogue's lum and alpha exact and its depth within
     1e-6) and times both, K2 beside one ``grid_sample`` per pass;
  3. with every launch counter at 0, re-runs the TF edit and renders the
     benchmark pose at 1920x1080 (20 frames x 5 reps, CUDA events), then
     checks that K1-K4 and the occupancy kernel launched, the frame glue's
     kernels once a frame, the plan took
     the brick sweep and the two-pass warp, the frame has content, and it
     matches the plain-PyTorch frame on the card;
  4. with every launch counter at 0, runs the CLI's default render in this
     process (``vkvolume_tpu_torch.cli --synth beetle --output <png>``:
     isotropic-distance ESS, gradient TF, 1280x720, the brick sweep's
     gradient + plane-pair-lerp variant), checks that K1, K2, the two-sided
     K4, K5 and the occupancy kernel launched, then holds the occupancy
     kernel (gradient TF) and the isotropic map bit-exact to their plain
     versions, K5, the two-sided K4 and K1's variant against their plain
     versions (timing both), the frame against the plain-PyTorch frame, the
     plan (brick sweep, two-pass warp) and the PNG (>= 5 % covered); times
     ms/frame and map_update_ms; runs ``--benchmark 20`` once; then, with
     the counters at 0 again, the accel API's relaxation (K6) completes the
     isotropic map from K5's output, bit-exact to the engine's map, and K6
     is held bit-exact to its plain version on both axes and all senses;
     then (phase 4c) the synthetic beetle at scale FILE_SCALE goes through
     ``bench.write_reference_format`` to a ``.uint16`` file and its
     ``.header`` in a temporary directory: ``from_file(..., device="cuda")``
     must put the synthesised u8 on the card byte for byte, and the CLI's
     frame of that file (``cli <file>``) must equal, in colour, depth and
     sample counters, the CLI engine's frame of the in-memory volume built
     with ``from_array`` and the transform the writer records (voxel size
     0.001, 90 degrees about x) and fitted as the CLI fits it; the files
     are deleted; and a default
     ``Engine(device="cuda")`` must render a DEFAULT_SIZE frame through
     the per-ray marcher (``last_renderer == "marcher"``, no sweep or warp
     launch), as the JAX engine does;
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
  8. the benchmark entry and the matrix, with the counters at 0 before
     each run:
     (a) ``python -m vkvolume_tpu_torch.bench`` with its defaults (bench.py's
         frame and 5 x 20 protocol) in a subprocess whose ``jax`` and
         ``vkvolume_tpu`` refuse to import: prints its JSON line and checks
         its keys, that every frame of both fits (aspect and stretch) went
         through the w-grid frame, that ``vs_baseline`` is the reference's
         frame time over ``frame_ms_stretch_equiv``, the stage split and
         the kernels it launched; prints the stretch / aspect ratio;
     (b) ``run_config`` at the reference protocol's 1200x1200 in benchmark
         mode (ERT off, sample counts) on the full-scale beetle, skipmodes
         0-3 at block size 4 and skipmode 3 at 2 and 6, each cut to
         MATRIX_REPS x MATRIX_FRAMES frames: no distance kernel in
         skipmodes 0 and 1, the maps equal to their plain versions, the
         frame against the plain-PyTorch frame, the CSV row printed; the
         sweep with dist_leap off (skipmode 1) and K3 + K4 at the b=2 maps
         held against their plain versions and timed;
     (c) the same for present (skipmode 3) and snake-grad (skipmode 2), at
         block size 4 and SPECIMEN_SCALE;
  9. the per-ray marcher, edge repair and the scene pass, with the
     counters at 0 before each run:
     (a) a wide-FOV camera inside the volume (mixed principal-axis signs)
         with bench.py's engine at skipmodes 2 and 3, 1280x720: the
         frame falls back to the marcher after the TF edit's distance
         kernels, and no K1, K7, K2 or K8 launches; ms/frame (median of
         3 synced frames) and loop bodies; then the card's marcher held
         against the CPU's on the same rays at scale 0.25, 256x144
         (counters equal on all but 0.1 % of the covered pixels, colour
         within 1e-4 where they are);
     (b) ``cli --synth beetle --renderer marcher --output <png>``: the
         marcher frame, its PNG and ms/frame;
     (c) ``cli --synth beetle --edge-repair --output <png>``: K1 and K2,
         then the marcher on the suspects; every repaired pixel equal in
         colour to (b)'s marcher frame and its depth within 1e-6, every
         other pixel the sweep frame's; the share of covered pixels
         beyond 8/255 of the marcher frame strictly lower with the
         repair; the sweep frame, the repair and the repaired frame
         timed;
     (d) ``cli --synth beetle --scene --output <png>``: the hall's depth
         clips the rays and the XLA sweep renders the volume (no K1, K7,
         K2 or K8); no volume hit lies behind the scene; the rasteriser
         and the whole frame timed;
 10. the API paths (``phase_api``): the float occupancy path,
     ``--gradient_test``, ``render_frame`` on caller rays, the map cache
     and the viewer, with the counters at 0 before each;
 11. the multi-device modes (``vkvolume_tpu_torch.parallel``) on the CLI's
     engine, built here and handed to the ranks (CUDA tensors through
     CUDA IPC, the volume-sharded modes' arrays as host files), 4 ranks
     sharing the card under gloo and one rank under NCCL, the counters
     at 0 before each case on every rank:
     (a) ``render_frame_sharded`` at the CLI pose, n = 2 at 1280x720 and
         n = 4 at 1280x1024, each with its planner's warp variant and the
         other one, and n = 1 under NCCL: K1 (or K7) and K2 on every rank,
         lum, alpha and depth equal to the single-device ``render_frame``
         of the same plan where both take the same sweep (else within
         FRAME_TOL); n = 4 at 1280x720 raises ValueError on every rank;
     (b) ``march_sharded`` (``--renderer marcher``'s march), n = 4: the
         sample counters equal to the single-device march on every pixel,
         colour within 1e-5, no sweep or warp launch;
     (c) ``march_volume_sharded``, n = 4: within tests/test_parallel.py's
         tolerances of the single-device march, each rank's volume and
         gradient slabs at most (Pz + 4)/D of the volume;
     (d) ``sweep_volume_sharded``, n = 4, ERT off and on: K1 on every
         rank, within 2e-3 (0.011 with ERT) of the single-device brick
         sweep of the same plan, depth on hit pixels within 1e-3, hit sets
         agreeing on 99.5 %, each rank holding only its slab;
     each case's ms (median of 3 synced calls of all its ranks) and its
     collective's bytes and ms: n ranks time-sharing one card, not a
     scaling result;
 12. the measurement protocols (``vkvolume_tpu_torch.bench``), cut, through
     their own functions, on the full-scale beetle at bench.py's pose:
     (a) ``parity``: beetle and beetle-grad at skipmodes 0-3, 1920x1080,
         against the marcher oracle (skipmode 2; no sweep or warp
         launch): the four default frames equal bit for bit, each
         skipmode's TF edit running its distance kernels and no other
         (none at 0-1), the edge-repair frame at skipmode 3 lowering both
         shares beyond 8/255 (of the image, of the covered pixels),
         printed beside the JAX package's record;
     (b) ``session``: PROTO_EDITS slider edits and the extras; each undo
         and the ESS toggle (skipmode 3) give the frame before back bit
         for bit, the other edits change it;
     (c) ``orbit``: PROTO_ORBIT_FRAMES frames a repetition, the JSON line
         and ``renderer_counts``;
     (d) ``ess_ratio``: beetle at skipmodes 0 and 3, PROTO_ESS_FRAMES
         frames a repetition, with the stage split;
     (e) ``sample_count``: beetle at skipmode 2, 1920x1080, ERT off: the
         w-grid frame through K1 (walk and compositing) and K2, the
         oracle through none of K1, K1 texture, K7, K2 or K8; every
         statistic finite and > 0 (the w-grid frame's median >= 0);
     (f) ``warp_vs_quadrature``: beetle-grad at skipmode 2, 1920x1080:
         the XLA sweep through no sweep or warp kernel, the w-grid
         frame's pixels beyond 8/255 of the oracle equal to
         docs/h100/parity.json's beetle-grad:2 row;
  7. prints the kernel table (each kernel's time, its plain version's,
     the least time the card could take for the same work, and a PyTorch
     call's where one computes the same function; a kernel's time is the
     card's: the timed calls wait behind a sleep while the host issues
     them), the frame times and both paths' map_update_ms and, as the last
     line, {"ok": true, "device": {...}}.

The plain-PyTorch frames the phases compare with swap the frame glue's
kernels for their twins too.

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
import math
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
# Phase 4c: the reference file format's round trip (a .uint16 file of
# about 86 MB at this scale) and the default engine's frame size.
FILE_SCALE = 0.5
DEFAULT_SIZE = 64
# JAX's cross-route tolerance, texture through K1 against the XLA sweep
# (tests/test_sweep.py:328-333): share of |diff| > 0.06, mean alpha.
CROSS_TOL, CROSS_BAD_SHARE, CROSS_ALPHA_MEAN = 0.06, 0.01, 5e-3
# Phase 8: the reference's benchmark matrix (scripts/benchmark.py,
# BASELINE.md) at its 1200x1200 viewport, each run cut from the
# protocol's 5 x 20 frames to MATRIX_REPS x MATRIX_FRAMES.
MATRIX_SIZE = 1200
MATRIX_FRAMES, MATRIX_REPS = 5, 2
MATRIX_RUNS = ((0, 4), (1, 4), (2, 4), (3, 4), (3, 2), (3, 6))  # beetle
SPECIMENS = (("present", 3, 4), ("snake-grad", 2, 4))   # key, skipmode, b
SPECIMEN_SCALE = 1.0
# The reference's stag-beetle fps at 1200x1200, skipmode 3, its stretch
# fit (BASELINE.md; scripts/benchmark_results_3.csv:14): the entry's
# vs_baseline is its pixel-scaled frame time over the stretch frame's.
ENTRY_REFERENCE_FPS = 672.3
# Phase 9: the per-ray marcher, edge repair and the scene pass.
INSIDE = dict(radius=10.0, azimuth_deg=45.0, elevation_deg=35.0,
              fovy_deg=120.0)   # a wide-FOV camera inside the volume
MARCH_REPS = 3          # synced marcher frames timed per path
# The card's marcher against the CPU's on a reduced beetle and the same
# rays: counters equal on every pixel, colour within MARCH_COLOR_TOL.
MARCH_SCALE, MARCH_WIDTH, MARCH_HEIGHT = 0.25, 256, 144
MARCH_COLOR_TOL = 1e-4
# The card's full ray setup (make_rays(full=True)) against the CPU's on the
# same uniforms: coverage equal, and every field no further from a float64
# evaluation than RAYS_FACTOR times the CPU's float32 result is (or one ulp
# of the field's magnitude): the matrix products of the set-up sum in
# another order on the card, so the fields differ in their last places,
# amplified where the ray's entry cancels against the camera's position.
RAYS_FACTOR = 2.0
# The JAX package's own sweep-vs-marcher gap on beetle-grad at bench.py's
# pose, 1920x1080, full scale (docs/parity_r5.json; ROADMAP C): pixels
# beyond 8/255, % of the whole image (the record's unit) and % of the
# oracle's covered pixels (its covered_px). A record, not a gate.
JAX_BEETLE_GRAD_GAP = 0.38
JAX_BEETLE_GRAD_GAP_COVERED = 3.857
# Phase 10: an inverted intensity range with a gradient term on bench.py's
# engine (imin, imax, gmin, gmax); the CLI-frame pose whose engine plan
# takes another axis than the host analysis (render_frame then plans from
# the rays' device statistics); the viewer's frame size.
INVERTED_TF = (0.5, 0.2, 0.1, 0.3)
# A second inverted TF whose lower edges lie on u8 levels (0.6 = 153/255,
# 1/3 = 85/255), as the viewer's sliders give them: there one rounding more
# or less (a fused multiply-add) flips the level's voxels. Phase 10a holds
# the card's per-voxel test to the CPU's at this TF on the volume, and at
# every such level (``fma_edge_levels``) on every u8 (intensity, gradient)
# pair, since the volume need not hold voxels on both edges.
U8_EDGE_TF = (0.6, 0.1, 1.0 / 3.0, 0.999)
DEVICE_STATS_AZIMUTH = 45.0
VIEWER_WIDTH, VIEWER_HEIGHT = 960, 540

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
# The occupancy map: per voxel a compare and an OR (a compare and an AND
# more with a gradient map).
OPS_PER_VOXEL = 2
# The frame glue (csrc/frame_glue.cu), counted from its source: per grid
# cell the grid fields; per pixel its ray and grid position; per first-pass
# position of the two-pass warp; per grid cell the epilogue's depth. Bytes:
# each output written once, the epilogue's three maps read once.
OPS_GRID_CELL, OPS_PIXEL_RAY, OPS_POSITION, OPS_EPILOGUE_CELL = 92, 126, 41, 37
# The glue kernels against their twins (tests/test_torch_frame_glue_cuda):
# positions within GLUE_POS_RTOL relative (absolute below one grid cell)
# where both cover the pixel, coverage differing on at most GLUE_COVER of
# them; the epilogue's depth within GLUE_DEPTH_TOL.
GLUE_POS_RTOL, GLUE_COVER, GLUE_DEPTH_TOL = 2e-5, 1e-4, 1e-6


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


def aniso_rows(occ, maps, timer, phase) -> tuple:
    """K3 + K4 on ``occ``: bit-exact to their plain versions, every one of
    the 8 maps, and equal to the engine's ``maps``; their rows (timed)."""
    import torch
    from vkvolume_tpu_torch.accel import distance, distance_cuda

    xy_k = distance_cuda.scan_and_relax_multi(occ)
    xy_p = distance.scan_and_relax_multi(occ)
    assert torch.equal(xy_k, xy_p), "K3 differs from its plain version"
    z_k = distance_cuda.relax_z_direct_multi(xy_k)
    z_p = distance.relax_z_direct_multi(xy_p)
    for i in range(8):
        assert torch.equal(z_k[i], z_p[i]), f"K4 octant map {i} differs"
    assert torch.equal(maps, z_p), "engine maps differ"
    # K3: two one-sided x-scans, four outputs of one y sense each; K4: 8
    # outputs of one z sense each.
    cells = occ.numel()
    k3 = dict(max_abs_err=0.0,
              ms=timer(lambda: distance_cuda.scan_and_relax_multi(occ), 20),
              plain_ms=timer(lambda: distance.scan_and_relax_multi(occ), 2),
              **distance_bound(1, 4, cells, 2, 1))
    k4 = dict(max_abs_err=0.0,
              ms=timer(lambda: distance_cuda.relax_z_direct_multi(xy_k), 20),
              plain_ms=timer(lambda: distance.relax_z_direct_multi(xy_k), 2),
              **distance_bound(4, 8, cells, 0, 1))
    log(f"{phase}: K3+K4 bit-exact on 8 maps {tuple(z_k.shape)}")
    return k3, k4


def occupancy_row(vol, grad, map_shape, ti, tg, timer, phase) -> dict:
    """The occupancy kernel on an engine's volume (and gradient map): one
    launch a map, bit-exact to its plain version on the same tensors; its
    row (timed). Bound: both inputs read once and the map written once;
    the log adds the volume-only floor and the share of the volume's
    32-byte sectors with a voxel past ``ti`` (the kernel reads the
    gradient only behind those)."""
    import torch
    from vkvolume_tpu_torch.accel import occupancy, occupancy_cuda

    before = occupancy_cuda.LAUNCHES["occupancy"]
    occ = occupancy._occupancy_u8(vol, grad, map_shape, ti, tg)
    assert occupancy_cuda.LAUNCHES["occupancy"] == before + 1
    plain = occupancy._occupancy_u8_plain(vol, grad, map_shape, ti, tg)
    assert torch.equal(occ, plain), \
        f"{phase}: the occupancy kernel differs from its plain version"
    n_in = vol.numel() * (1 if grad is None else 2)
    ops = (OPS_PER_VOXEL if grad is None else 2 * OPS_PER_VOXEL) * vol.numel()
    row = dict(max_abs_err=0.0,
               ms=timer(lambda: occupancy_cuda.occupancy_u8(
                   vol, grad, map_shape, ti, tg), 20),
               plain_ms=timer(lambda: occupancy._occupancy_u8_plain(
                   vol, grad, map_shape, ti, tg), 5),
               **bound(n_in + occ.numel(), ops))
    floor = bound(vol.numel() + occ.numel(), OPS_PER_VOXEL * vol.numel())
    sectors = (float((vol.view(-1, 32) >= ti).any(dim=1).float().mean())
               if vol.numel() % 32 == 0 else float("nan"))
    log(f"{phase}: occupancy kernel bit-exact {tuple(vol.shape)} -> "
        f"{tuple(occ.shape)} (ti {ti}, tg {tg}, gradient "
        f"{grad is not None}), {int((occ == 0).sum())} occupied cells; "
        f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bound "
        f"{row['bound_ms']:.4f} ms, volume-only floor "
        f"{floor['bound_ms']:.4f} ms; sectors past ti {sectors:.4f}")
    return row


def phase_kernels(eng, cam, timer):
    """Each kernel against its plain version at the main path's shapes."""
    import torch
    from vkvolume_tpu_torch.accel.occupancy import (_occupancy_u8,
                                                    _tf_thresholds)
    from vkvolume_tpu_torch.bench.warp_probe import device_work
    from vkvolume_tpu_torch.render import sweep_bricks, sweep_frame, warp_cuda
    from vkvolume_tpu_torch.render.ray_setup import make_rays

    rows = {}
    v = eng.volumes[0]
    o = v.options
    ti, tg = _tf_thresholds(None, (o.intensity_min, o.intensity_max,
                                   o.gradient_min, o.gradient_max))
    occ = _occupancy_u8(v.density, None, v.map_shape_zyx, ti, tg)
    rows["occupancy"] = occupancy_row(v.density, None, v.map_shape_zyx, ti,
                                      tg, timer, "phase 2")

    rows["K3"], rows["K4"] = aniso_rows(occ, v.dist_maps, timer, "phase 2")

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
    rows.update(glue_rows(eng, cam, sweep_bricks.sweep_bricks_kernel(inp)[:3],
                          timer))

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


def frame_geometry(eng, cam):
    """The glue's geometry of the engine's frame at ``cam`` (what
    ``_frame_body`` hands ``frame_grid``), from one frame."""
    from vkvolume_tpu_torch.render import sweep_frame

    got = []
    saved = sweep_frame.frame_grid

    def grid(geom, device):
        got.append((geom, device))
        return saved(geom, device)

    sweep_frame.frame_grid = grid
    try:
        eng.render(cam, WIDTH, HEIGHT)
    finally:
        sweep_frame.frame_grid = saved
    assert got, "the frame did not take the brick sweep"
    return got[-1]


def glue_rows(eng, cam, k1_out, timer) -> dict:
    """The frame glue's three kernels at the frame's pose against their
    twins on the same tensors (the grid fields bit-exact, the positions
    and the epilogue's depth within GLUE_*), and their rows (timed)."""
    import torch
    from vkvolume_tpu_torch.render import frame_cuda, sweep_frame

    geom, dev = frame_geometry(eng, cam)
    cells = geom.Hi * geom.Wi
    rows = {}

    got = frame_cuda.frame_grid(geom, dev)
    want = sweep_frame.grid_plain(geom, dev)
    for name, g, w in zip(("wu", "wv", "s_lo", "s_hi", "kappa", "cov"),
                          got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True,
                                   msg=lambda m: f"frame_grid {name}: {m}")
    rows["frame_grid"] = dict(
        max_abs_err=0.0, ms=timer(lambda: frame_cuda.frame_grid(geom, dev),
                                  20),
        plain_ms=timer(lambda: sweep_frame.grid_plain(geom, dev), 5),
        **bound(21 * cells, OPS_GRID_CELL * cells))

    got = frame_cuda.frame_positions(geom, dev)
    want = sweep_frame.positions_plain(geom, dev)
    err = cover = 0.0
    for name, g, w in zip(frame_cuda.Positions._fields, got, want):
        if g is None:
            continue
        vg, vw = g > -5.0, w > -5.0
        cover = max(cover, float((vg != vw).to(torch.float64).mean()))
        both = vg & vw
        e = ((g - w).abs() / w.abs().clamp(min=1.0))[both]
        err = max(err, float(e.max()) if e.numel() else 0.0)
    assert cover <= GLUE_COVER and err <= GLUE_POS_RTOL, \
        f"frame_positions: coverage differs on {cover}, error {err}"
    # Variant B's gx is the first rows of its gx_p.
    n_out = sum(t.numel() for t in got if t is not None) - (
        got.gx.numel() if geom.warp == "B" else 0)
    n_pos = 0 if got.pos1 is None else got.pos1.numel()
    n_pix = HEIGHT * WIDTH
    rows["frame_positions"] = dict(
        max_abs_err=err,
        ms=timer(lambda: frame_cuda.frame_positions(geom, dev), 20),
        plain_ms=timer(lambda: sweep_frame.positions_plain(geom, dev), 5),
        **bound(4 * n_out, OPS_PIXEL_RAY * n_pix + OPS_POSITION * n_pos))

    lum, alpha, firsts = k1_out
    got = frame_cuda.frame_epilogue(geom, lum, alpha, firsts)
    want = sweep_frame.epilogue_plain(geom, lum, alpha, firsts)
    assert torch.equal(got[:2], want[:2]), "frame_epilogue: lum or alpha"
    d_err = float((got[2] - want[2]).abs().max())
    assert d_err <= GLUE_DEPTH_TOL, f"frame_epilogue: depth err {d_err}"
    rows["frame_epilogue"] = dict(
        max_abs_err=d_err,
        ms=timer(lambda: frame_cuda.frame_epilogue(geom, lum, alpha,
                                                   firsts), 20),
        plain_ms=timer(lambda: sweep_frame.epilogue_plain(geom, lum, alpha,
                                                          firsts), 5),
        **bound(24 * cells, OPS_EPILOGUE_CELL * cells))
    log(f"phase 2: frame glue ({geom.warp}, grid {geom.Hi}x{geom.Wi}, image "
        f"{HEIGHT}x{WIDTH}): grid fields bit-exact, positions err "
        f"{err:.3g} (coverage differs on {cover:.3g}), epilogue lum/alpha "
        f"exact, depth err {d_err:.3g}; ms "
        + ", ".join(f"{k} {rows[k]['ms']:.4f} (plain {rows[k]['plain_ms']:.4f}"
                    f", bound {rows[k]['bound_ms']:.4f})" for k in rows))
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


def phase_file(out_dir):
    """Phase 4c: the reference format's round trip through the card and
    the CLI, then the default engine's renderer."""
    import dataclasses

    import numpy as np
    import torch
    from vkvolume_tpu_torch import cli
    from vkvolume_tpu_torch.bench import (DATASETS, synthesize,
                                          write_reference_format)
    from vkvolume_tpu_torch.engine import Engine, from_array, from_file
    from vkvolume_tpu_torch.utils import math3d

    ds = DATASETS["beetle"]
    vol = synthesize(ds, seed=0, scale=FILE_SCALE)
    path = os.path.join(out_dir, f"beetle_x{FILE_SCALE}.uint16")
    png = os.path.join(out_dir, "cli_file.png")
    t0 = time.perf_counter()
    write_reference_format(ds, vol, path)
    write_s = time.perf_counter() - t0
    try:
        assert os.path.getsize(path) == 2 * vol.size
        t0 = time.perf_counter()
        loaded = from_file(path, device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        assert loaded.density.device.type == "cuda"
        assert loaded.density.dtype == torch.uint8
        assert torch.equal(loaded.density,
                           torch.from_numpy(vol).to(loaded.density.device)), \
            "the volume read back differs from the synthesised u8"
        log(f"phase 4c: {os.path.basename(path)} {vol.shape} "
            f"{os.path.getsize(path)} bytes, written in {write_s:.2f} s, "
            f"read onto the card in {load_s:.2f} s, byte-equal")
        del loaded
        # The CLI's default frame of the file, and that of the in-memory
        # volume built apart from the file: from_array with the transform
        # the writer records (voxel size 0.001, a 90 degree turn about x)
        # and the CLI's options and fit, on the CLI's engine.
        _, _, out_f = cli.run([path, "--output", png])
        eng_m, volumes = cli.setup_engine(cli.build_parser().parse_args(
            ["--synth", "beetle", "--synth-scale", str(FILE_SCALE)]))
        v = from_array(vol, volumes[0].options,
                       block_size=volumes[0].block_size,
                       voxel_size=(0.001,) * 3, device="cuda")
        v.image_transform = math3d.rotate(np.deg2rad(90.0), (1.0, 0.0, 0.0)) \
            @ v.image_transform
        cli.fit_to_viewport(v)
        eng_m.add_volume(v)
        out_m = eng_m.render(cli.cli_camera(CLI_WIDTH, CLI_HEIGHT),
                             CLI_WIDTH, CLI_HEIGHT)
        torch.cuda.synchronize()
        assert eng_m.last_renderer == "pallas"
        for f in dataclasses.fields(out_f):
            a, b = getattr(out_f, f.name), getattr(out_m, f.name)
            assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                    else a == b), f"CLI frame of the file: {f.name} differs"
        share = covered_share(out_f.color)
        assert share >= MIN_COVERED, f"file frame nearly empty ({share})"
        log(f"phase 4c: the CLI frame of the file equals the in-memory "
            f"volume's ({CLI_WIDTH}x{CLI_HEIGHT}, covered {share:.4f})")
        del eng_m, volumes, v, out_f, out_m
    finally:
        for p in (path, path + ".header", png):
            if os.path.exists(p):
                os.remove(p)

    # The default engine: the per-ray marcher, as in the JAX package.
    eng = Engine(device="cuda")
    assert eng.renderer == "marcher"
    v = from_array(vol, block_size=4, device="cuda")
    v.set_scale((100.0 / max(vol.shape),) * 3)
    eng.add_volume(v)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out = eng.render(cli.cli_camera(DEFAULT_SIZE, DEFAULT_SIZE),
                     DEFAULT_SIZE, DEFAULT_SIZE)
    torch.cuda.synchronize()
    default_ms = (time.perf_counter() - t0) * 1e3
    launches = read_launches()
    assert eng.last_renderer == "marcher"
    assert eng.renderer_counts == {"pallas": 0, "sweep": 0, "marcher": 1}
    check_none(launches, ("K1", "K1 texture", "K1 walk", "K2", "K7",
                          "K7 walk", "K8"), "phase 4c")
    assert tuple(out.color.shape) == (DEFAULT_SIZE, DEFAULT_SIZE, 4)
    assert bool(torch.isfinite(out.color).all())
    share = covered_share(out.color)
    assert share >= MIN_COVERED, f"default-engine frame nearly empty " \
        f"({share})"
    log(f"phase 4c: default Engine -> {eng.last_renderer}, "
        f"{DEFAULT_SIZE}x{DEFAULT_SIZE} in {default_ms:.1f} ms (one synced "
        f"frame), {int(out.iterations)} bodies, covered {share:.4f}")
    return dict(write_s=write_s, load_s=load_s, default_ms=default_ms)


def reset_launches():
    from vkvolume_tpu_torch.accel import distance_cuda, occupancy_cuda
    from vkvolume_tpu_torch.render import (frame_cuda, sweep_bricks,
                                           sweep_slabs, warp_cuda)

    for table in (distance_cuda.LAUNCHES, sweep_bricks.LAUNCHES,
                  sweep_slabs.LAUNCHES, warp_cuda.LAUNCHES,
                  occupancy_cuda.LAUNCHES, frame_cuda.LAUNCHES):
        for k in table:
            table[k] = 0


def read_launches():
    from vkvolume_tpu_torch.accel import distance_cuda, occupancy_cuda
    from vkvolume_tpu_torch.render import (frame_cuda, sweep_bricks,
                                           sweep_slabs, warp_cuda)

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
            "K7 walk": sweep_slabs.LAUNCHES["slab_walk"],
            "occupancy": occupancy_cuda.LAUNCHES["occupancy"],
            **frame_cuda.LAUNCHES}


@contextlib.contextmanager
def plain_kernels():
    """K1, K2, K7, K8 and the frame glue's kernels swapped for their plain
    versions inside the block."""
    from vkvolume_tpu_torch.render import (sweep_bricks, sweep_frame,
                                           sweep_slabs, warp_cuda)

    saved = (sweep_bricks.sweep_bricks_kernel, warp_cuda.warp_two_pass,
             warp_cuda.warp_two_pass_b, sweep_slabs.sweep_slabs_kernel,
             warp_cuda.warp_to_pixels, sweep_frame.frame_grid,
             sweep_frame.frame_positions, sweep_frame.frame_epilogue)
    sweep_bricks.sweep_bricks_kernel = sweep_bricks.sweep_bricks_reference
    warp_cuda.warp_two_pass = warp_cuda.warp_two_pass_plain
    warp_cuda.warp_two_pass_b = warp_cuda.warp_two_pass_b_plain
    sweep_slabs.sweep_slabs_kernel = sweep_slabs.sweep_slabs_plain
    warp_cuda.warp_to_pixels = warp_cuda.warp_to_pixels_plain
    sweep_frame.frame_grid = sweep_frame.grid_plain
    sweep_frame.frame_positions = sweep_frame.positions_plain
    sweep_frame.frame_epilogue = sweep_frame.epilogue_plain
    try:
        yield
    finally:
        (sweep_bricks.sweep_bricks_kernel, warp_cuda.warp_two_pass,
         warp_cuda.warp_two_pass_b, sweep_slabs.sweep_slabs_kernel,
         warp_cuda.warp_to_pixels, sweep_frame.frame_grid,
         sweep_frame.frame_positions, sweep_frame.frame_epilogue) = saved


def plain_frame(eng, cam, width=WIDTH, height=HEIGHT):
    """The same frame with K1, K2, K7, K8 and the frame glue's kernels
    swapped for their plain versions (the maps are the kernels', held
    bit-exact to the plain maps in phases 2 and 4)."""
    with plain_kernels():
        return eng.render(cam, width, height)


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
                                         "K4", "occupancy")), \
        "a kernel of the path never ran"
    assert launches["K1 walk"] == launches["K1"]
    assert all(launches[k] == launches["K1"] for k in (
        "frame_grid", "frame_positions", "frame_epilogue")), \
        "the frame glue's kernels ran other than once a frame"

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
                                         "K4 two-sided", "K5",
                                         "occupancy")), \
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
    ti, tg = _tf_thresholds(None, (o.intensity_min, o.intensity_max,
                                   o.gradient_min, o.gradient_max))
    occ = _occupancy_u8(v.density, v.gradient, v.map_shape_zyx, ti, tg)
    rows["occupancy gradient"] = occupancy_row(
        v.density, v.gradient, v.map_shape_zyx, ti, tg, timer, "phase 4")
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
    ti, tg = _tf_thresholds(None, (o.intensity_min, o.intensity_max,
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


def phase_entry() -> dict:
    """(a) ``python -m vkvolume_tpu_torch.bench`` with its defaults, in a
    process whose ``jax`` and ``vkvolume_tpu`` refuse to import: its one
    JSON line, with bench.py's keys, every frame through the w-grid
    frame and the stage split filled; ``vs_baseline`` over the stretch
    fit's median, measured in the same run, every stretch frame through
    the w-grid frame too."""
    repo = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as run_dir:
        for name in ("jax", "vkvolume_tpu"):
            os.makedirs(os.path.join(run_dir, name))
            with open(os.path.join(run_dir, name, "__init__.py"), "w") as fh:
                fh.write(f"raise ImportError('{name} imported')\n")
        # The synthetic volume's cache (datasets.synthesize: .cache/).
        os.makedirs(os.path.join(repo, ".cache"), exist_ok=True)
        os.symlink(os.path.join(repo, ".cache"),
                   os.path.join(run_dir, ".cache"))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "vkvolume_tpu_torch.bench"],
            cwd=run_dir, env=dict(os.environ, PYTHONPATH=repo),
            capture_output=True, text=True)
    if proc.returncode:
        log(proc.stderr[-4000:])
        raise AssertionError(f"the bench entry exited {proc.returncode}")
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1, lines
    log(f"phase 8a: python -m vkvolume_tpu_torch.bench in "
        f"{time.perf_counter() - t0:.1f} s:")
    log(lines[0])
    r = json.loads(lines[0])
    keys = {"metric", "value", "unit", "vs_baseline", "fps", "map_update_ms",
            "occupancy_pct", "frames", "scale", "wall_s", "rep_ms",
            "rep_spread", "renderer_used", "renderer_counts", "protocol",
            "stages", "device", "power_limit"}
    assert keys <= set(r), keys - set(r)
    assert r["frame_ms_stretch_equiv"] > 0, r["frame_ms_stretch_equiv"]
    ref_ms = 1000.0 / (ENTRY_REFERENCE_FPS / (WIDTH * HEIGHT / 1200.0 ** 2))
    assert abs(r["vs_baseline"] * r["frame_ms_stretch_equiv"] - ref_ms) \
        <= 1e-9 * ref_ms, (r["vs_baseline"], r["frame_ms_stretch_equiv"])
    for counts in ("renderer_counts", "stretch_renderer_counts"):
        assert {k for k, n in r[counts].items() if n} == {"pallas"}, \
            (counts, r[counts])
    log(f"phase 8a: stretch / aspect ms/frame "
        f"{r['frame_ms_stretch_equiv']:.4f} / {r['value']:.4f} = "
        f"{r['frame_ms_stretch_equiv'] / r['value']:.4f}")
    assert set(r["stages"]) == {"plan_ms", "sweep_ms", "warp_ms"}
    assert all(r["stages"][k] > 0 for k in r["stages"])
    assert r["protocol"] == "5x20" and r["scale"] == 1.0
    for k in ("sweep_bricks", "brick_walk", "resample_rows",
              "scan_and_relax_multi", "relax_z_direct_multi", "occupancy"):
        assert r["launches"][k] > 0, f"the entry never launched {k}"
    return r


def fma_edge_levels() -> list:
    """The u8 levels L whose TF edge lo = f32(L / 255) makes the
    occupancy test's ``f32(L) * f32(1/255) - lo`` exactly 0 when each
    operation rounds on its own, but not when a fused multiply-add rounds
    once: at such an edge a fusion flips the level's voxels."""
    import numpy as np

    inv = np.float32(1.0 / 255.0)
    levels = []
    for level in range(1, 256):
        lo = np.float32(level / 255.0)
        if (np.float32(np.float32(level) * inv) - lo == 0
                and float(np.float32(level)) * float(inv) != float(lo)):
            levels.append(level)
    return levels


@contextlib.contextmanager
def plain_occupancy():
    """The occupancy kernel swapped for its plain version inside the
    block."""
    from vkvolume_tpu_torch.accel import occupancy, occupancy_cuda

    saved = occupancy_cuda.occupancy_u8
    occupancy_cuda.occupancy_u8 = occupancy._occupancy_u8_plain
    try:
        yield
    finally:
        occupancy_cuda.occupancy_u8 = saved


def plain_maps(eng):
    """(occupancy map, skip maps) of the engine's volume from the plain
    versions: the occupancy map (the integer or the float path, with the
    gradient map or on the fly, as the engine builds it), then the
    distance transforms of the engine's skipping type."""
    from vkvolume_tpu_torch.accel import distance
    from vkvolume_tpu_torch.accel.occupancy import occupancy_map
    from vkvolume_tpu_torch.options import SkippingType

    v = eng.volumes[0]
    o = v.options
    with plain_occupancy():
        occ = occupancy_map(
            v.density, v.gradient, eng._tf(v), v.map_shape_zyx,
            on_the_fly_gradient=not o.use_precomputed_gradient,
            tf_host=(o.intensity_min, o.intensity_max, o.gradient_min,
                     o.gradient_max))
    skipping_type = eng.options.skipping_type
    if skipping_type == SkippingType.ANISOTROPIC_DISTANCE:
        return occ, distance.anisotropic_distance(occ)
    if skipping_type == SkippingType.DISTANCE:
        return occ, distance.isotropic_distance(occ)[None]
    return occ, occ[None]


def matrix_run(key, skipmode, blocksize, volume, phase):
    """One ``run_config`` of the matrix at MATRIX_SIZE² in benchmark mode,
    launch counters at 0 before it: the distance kernels its skipmode
    runs (none in 0 and 1), a sweep, the maps equal to their plain
    versions, the frame against the plain-PyTorch frame. Returns (result,
    launches, engine)."""
    import torch
    from vkvolume_tpu_torch.bench.harness import benchmark_camera, run_config
    from vkvolume_tpu_torch.options import SkippingType

    t0 = time.perf_counter()
    reset_launches()
    r = run_config(key, skipmode, blocksize, width=MATRIX_SIZE,
                   height=MATRIX_SIZE, frames=MATRIX_FRAMES, reps=MATRIX_REPS,
                   volume_u8=volume, keep_engine=True, device="cuda")
    torch.cuda.synchronize()
    launches = read_launches()
    eng = r.engine
    log(f"{phase}: {key} skipmode {skipmode} b={blocksize} "
        f"{MATRIX_SIZE}x{MATRIX_SIZE} ({MATRIX_REPS}x{MATRIX_FRAMES} frames, "
        f"cut from 5x20): row {r.row()} frame_ms {r.frame_ms:.4f} rep_ms "
        f"{[round(x, 4) for x in r.rep_ms]} host "
        f"{[round(x, 4) for x in r.rep_host_ms]} renderer_counts "
        f"{r.renderer_counts}")
    log(f"{phase}: launches {launches}")
    distance_kernels = ("K3", "K4", "K4 two-sided", "K5", "K6")
    st = SkippingType(skipmode)
    if st in (SkippingType.NONE, SkippingType.BLOCK):
        assert not any(launches[k] for k in distance_kernels), \
            f"{phase}: skipmode {skipmode} ran a distance kernel"
    elif st == SkippingType.DISTANCE:
        assert launches["K5"] > 0 and launches["K4 two-sided"] > 0
    else:
        assert launches["K3"] > 0 and launches["K4"] > 0
    assert launches["K1"] + launches["K7"] > 0, f"{phase}: no sweep ran"
    assert launches["K2"] + launches["K8"] > 0 or \
        r.renderer_counts.get("pallas_xla_warp")
    assert r.renderer_used == "pallas" and r.renderer_counts["sweep"] == 0
    v = eng.volumes[0]
    assert torch.equal(v.dist_maps, plain_maps(eng)[1]), \
        f"{phase}: maps differ from their plain versions"
    cam = benchmark_camera(1.0)
    color = eng.render(cam, MATRIX_SIZE, MATRIX_SIZE).color
    assert tuple(color.shape) == (MATRIX_SIZE, MATRIX_SIZE, 4)
    assert bool(torch.isfinite(color).all())
    covered = float((color[..., 3] > 0).float().mean())
    assert covered >= MIN_COVERED, f"{phase}: frame nearly empty ({covered})"
    check_against_plain_frame(eng, cam, color, MATRIX_SIZE, MATRIX_SIZE,
                              f"{phase} {key} skipmode {skipmode} "
                              f"b={blocksize}")
    log(f"{phase}: maps {tuple(v.dist_maps.shape)} equal to the plain maps; "
        f"covered share {covered:.4f}; {time.perf_counter() - t0:.1f} s")
    r.engine = None
    return r, launches, eng


def phase_matrix(timer):
    """(a) the benchmark entry, (b) the reference's matrix at 1200x1200 on
    the beetle (skipmodes 0-3 at b=4, skipmode 3 at b=2 and 6), (c) the
    present and snake-grad specimens."""
    import torch
    from vkvolume_tpu_torch.bench.datasets import DATASETS, synthesize
    from vkvolume_tpu_torch.bench.harness import benchmark_camera, capture
    from vkvolume_tpu_torch.render import sweep_bricks, sweep_slabs

    entry = phase_entry()
    rows, launches, results = {}, {}, []
    beetle = synthesize(DATASETS["beetle"])
    for skipmode, b in MATRIX_RUNS:
        r, n, eng = matrix_run("beetle", skipmode, b, beetle, "phase 8b")
        results.append(r)
        if (skipmode, b) == (1, 4):
            # K1 or K7 with dist_leap off, on the inputs the frame hands it.
            got, inp = capture(eng, benchmark_camera(1.0), MATRIX_SIZE,
                               MATRIX_SIZE)
            err, n_k, reads, stats = hold_sweep(
                inp, f"phase 8b: {got} (skipmode 1, no leap)")
            kernel, plain = ((sweep_bricks.sweep_bricks_kernel,
                              sweep_bricks.sweep_bricks_reference)
                             if got == "K1" else
                             (sweep_slabs.sweep_slabs_kernel,
                              sweep_slabs.sweep_slabs_plain))
            rows[f"{got} no leap"] = dict(
                max_abs_err=err, ms=timer(lambda: kernel(inp), 10),
                plain_ms=timer(lambda: plain(inp), 1, warm=0),
                **sweep_bound(inp, n_k, reads, stats))
            launches[f"{got} no leap"] = n[got]
            del inp
        if (skipmode, b) == (3, 2):
            occ = plain_maps(eng)[0]
            rows["K3 b=2"], rows["K4 b=2"] = aniso_rows(
                occ, eng.volumes[0].dist_maps, timer, "phase 8b (b=2)")
            launches["K3 b=2"], launches["K4 b=2"] = n["K3"], n["K4"]
            del occ
        del eng, r
        torch.cuda.empty_cache()
    del beetle
    for key, skipmode, b in SPECIMENS:
        t0 = time.perf_counter()
        vol = synthesize(DATASETS[key], scale=SPECIMEN_SCALE)
        log(f"phase 8c: {key} {vol.shape} at scale {SPECIMEN_SCALE} "
            f"synthesised or loaded in {time.perf_counter() - t0:.1f} s")
        r, _, eng = matrix_run(key, skipmode, b, vol, "phase 8c")
        results.append(r)
        del eng, r, vol
        torch.cuda.empty_cache()
    return entry, rows, launches, results


def rays_f64(u, height: int, width: int) -> dict:
    """make_rays(full=True)'s arithmetic in float64 numpy on the same
    float32 uniforms: the reference both devices' set-ups are held to."""
    import numpy as np

    f = lambda a: np.asarray(a, np.float64)
    py, px = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    ndc = np.stack([(px + 0.5) / width * 2.0 - 1.0,
                    (py + 0.5) / height * 2.0 - 1.0,
                    np.zeros(px.shape), np.ones(px.shape)], -1)
    world = ndc @ f(u.view_proj_inv).T
    world = np.concatenate([world[..., :3] / world[..., 3:4],
                            np.ones(px.shape + (1,))], -1)
    o = f(u.cam_pos_tex)
    d = (world @ f(u.global_to_tex).T)[..., :3] - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    plane = f(u.plane_tex)
    with np.errstate(divide="ignore", invalid="ignore"):
        t0, t1 = (0.0 - o) / d, (1.0 - o) / d
        t_near = np.minimum(t0, t1).max(-1)
        t_far = np.maximum(t0, t1).min(-1)
        s_d = d @ plane[:3]
        t_plane = np.where(s_d != 0.0, -(plane[:3] @ o + plane[3]) / s_d,
                           np.inf)
        t_entry = np.where(s_d > 0.0, np.maximum(t_near, t_plane), t_near)
        entry = o + t_entry[..., None] * d
        t_min, t_max = -entry / d, (1.0 - entry) / d
        exit_ = (np.maximum(t_min, t_max).min(-1, keepdims=True) * d
                 + entry)
    ones = np.ones(px.shape + (1,))
    clip = (np.concatenate([entry - 0.5, ones], -1) @ f(u.model).T
            @ (f(u.view).T @ f(u.proj).T))
    return dict(valid=(t_entry < t_far) & (t_far > 0.0), ray_dir=d,
                entry=entry, exit=exit_,
                ray_distance=np.linalg.norm(exit_ - entry, axis=-1),
                entry_clip_zw=clip[..., 2:4])


def check_full_rays(eng, cam, width, height, ph):
    """The card's full ray setup against the CPU's for ``cam`` on the
    engine's volume: the same coverage, and every field within
    RAYS_FACTOR times the CPU's own float32 error of the float64
    reference (``rays_f64``). Returns the rays made on the CPU."""
    import numpy as np
    from vkvolume_tpu_torch.render.ray_setup import make_rays

    u = eng._uniforms(cam, eng.volumes[0])
    got, want = (make_rays(u, height, width, d, full=True)
                 for d in ("cuda", "cpu"))
    ref = rays_f64(u, height, width)
    flips = int((got.valid.cpu() != want.valid).sum())
    both = want.valid.numpy() & got.valid.cpu().numpy() & ref["valid"]
    eps = float(np.finfo(np.float32).eps)
    errs = {}
    for k in ("ray_dir", "entry", "exit", "ray_distance", "entry_clip_zw"):
        r = ref[k][both]
        unit = eps * float(np.abs(r).max())
        card, cpu = (float(np.abs(getattr(x, k).cpu().double().numpy()[both]
                                  - r).max()) / unit for x in (got, want))
        errs[k] = (card, cpu)
    log(f"{ph}: make_rays(full=True) at {width}x{height}: card vs CPU "
        f"coverage differs on {flips} of {int(want.valid.sum())} pixels; "
        f"largest error from float64, card / CPU, in ulps of the field's "
        f"magnitude: " + ", ".join(f"{k} {a:.3g} / {b:.3g}"
                                   for k, (a, b) in errs.items()))
    assert flips == 0, f"{ph}: the card's coverage differs on {flips} pixels"
    assert all(a <= RAYS_FACTOR * max(b, 1.0) for a, b in errs.values()), \
        f"{ph}: the card's ray set-up is less exact than the CPU's: {errs}"
    return want


def counted_march(eng, cam, rays):
    """The engine's marcher on ``rays`` (copied to the engine's device),
    with its sample counters on."""
    import dataclasses

    from vkvolume_tpu_torch.render.marcher import march

    v = eng.volumes[0]
    u = eng._uniforms(cam, v)
    rays = dataclasses.replace(rays, **{
        f.name: getattr(rays, f.name).to(eng.device)
        for f in dataclasses.fields(rays)})
    return march(v.density, v.gradient, v.dist_maps, eng._tf(v), rays,
                 u.block_size, eng._pvm(cam, v),
                 skipping_type=eng.options.skipping_type,
                 early_ray_termination=eng.options.early_ray_termination,
                 count_samples=True)


def covered_share(color) -> float:
    return float((color[..., 3] > 0).float().mean())


def check_none(launches, keys, phase):
    ran = {k: launches[k] for k in keys if launches[k]}
    assert not ran, f"{phase}: {ran} launched"


def phase_oracle(out_dir):
    """(a) the mixed-sign fallback to the marcher, (b) ``--renderer
    marcher``, (c) ``--edge-repair`` and (d) ``--scene``; returns the
    numbers for the summary."""
    import torch
    from vkvolume_tpu_torch import cli
    from vkvolume_tpu_torch.bench import parity
    from vkvolume_tpu_torch.bench.datasets import DATASETS, synthesize
    from vkvolume_tpu_torch.bench.harness import make_engine
    from vkvolume_tpu_torch.camera import orbit_camera
    from vkvolume_tpu_torch.engine.engine import suspect_mask
    from vkvolume_tpu_torch.options import Test
    from vkvolume_tpu_torch.render.forward import rasterize, sponza_lite
    from vkvolume_tpu_torch.utils.image import read_png

    res = {}
    W, H = CLI_WIDTH, CLI_HEIGHT
    sweeps_and_warps = ("K1", "K1 texture", "K7", "K2", "K8")
    # (a) The mixed-sign view at skipmodes 2 and 3 (bench.py's engine:
    # clip distance 1, ERT on), the TF edit included in the counts.
    beetle = synthesize(DATASETS["beetle"], seed=0)
    small = synthesize(DATASETS["beetle"], seed=0, scale=MARCH_SCALE)
    for sm, dist in ((2, ("K5", "K4 two-sided")), (3, ("K3", "K4"))):
        ph = f"phase 9a skipmode {sm}"
        reset_launches()
        eng = make_engine("beetle", sm, 4, volume_u8=beetle, test=Test.NONE,
                          ert=True, device="cuda")[0]
        cam = orbit_camera(aspect=W / H, **INSIDE)
        out = eng.render(cam, W, H)
        torch.cuda.synchronize()
        launches = read_launches()
        log(f"{ph}: launches {launches}")
        assert eng.last_renderer == "marcher", eng.last_renderer
        check_none(launches, sweeps_and_warps, ph)
        assert all(launches[k] > 0 for k in dist), \
            f"{ph}: the TF edit's distance kernels never ran"
        assert tuple(out.color.shape) == (H, W, 4)
        assert bool(torch.isfinite(out.color).all())
        cov = covered_share(out.color)
        assert cov >= MIN_COVERED, f"{ph}: frame nearly empty ({cov})"
        ms = synced_ms(lambda: eng.render(cam, W, H), MARCH_REPS)
        res[f"marcher_sm{sm}"] = (statistics.median(ms), out.iterations)
        log(f"{ph}: {W}x{H} covered share {cov:.4f}, mean alpha "
            f"{float(out.color[..., 3].mean()):.4f}, iterations "
            f"{out.iterations}, ms/frame median={statistics.median(ms):.4f} "
            f"reps={[round(r, 4) for r in ms]}")
        if sm == 2:
            check_full_rays(eng, cam, W, H, ph)
        del eng, out
        # The card's marcher against the CPU's on the reduced beetle, on
        # the same rays (the CPU's; the card's set-up is held against them
        # above and here).
        cam_s = orbit_camera(aspect=MARCH_WIDTH / MARCH_HEIGHT, **INSIDE)
        engs = [make_engine("beetle", sm, 4, volume_u8=small,
                            test=Test.NONE, ert=True, device=d)[0]
                for d in ("cuda", "cpu")]
        rays = check_full_rays(engs[0], cam_s, MARCH_WIDTH, MARCH_HEIGHT, ph)
        got, want = (counted_march(e, cam_s, rays) for e in engs)
        cov = want.color[..., 3] > 0
        same = torch.ones_like(cov)
        for k in ("num_volume_samples", "num_distance_samples",
                  "num_empty_samples"):
            same &= getattr(got, k).cpu() == getattr(want, k)
        diff = (got.color.cpu() - want.color).abs().amax(-1)
        flips = int((~same).sum())
        err = float(diff.max())
        log(f"{ph}: card vs CPU marcher at scale "
            f"{MARCH_SCALE} {MARCH_WIDTH}x{MARCH_HEIGHT}: counters "
            f"differ on {flips} pixels ({int(cov.sum())} covered), "
            f"colour err {err:.3g}, samples "
            f"{int(want.num_volume_samples.sum())} + "
            f"{int(want.num_distance_samples.sum())} skips, iterations "
            f"{got.iterations} / {want.iterations}")
        assert flips == 0 and err <= MARCH_COLOR_TOL
        assert got.iterations == want.iterations
        assert int(want.num_distance_samples.sum()) > 0
        del got, want, engs
        torch.cuda.empty_cache()
    del beetle, small

    args = ["--synth", "beetle"]
    cam = cli.cli_camera(W, H)

    def png_covered(png, ph):
        img = read_png(png)
        assert img.shape == (H, W, 3)
        c = float((img.max(axis=-1) > 0).mean())
        log(f"{ph}: PNG {img.shape} covered share {c:.4f}")
        assert c >= MIN_COVERED, f"{ph}: PNG nearly empty ({c})"

    # (b) --renderer marcher: the CLI frame through the marcher.
    ph = "phase 9b --renderer marcher"
    png = os.path.join(out_dir, "cli_marcher.png")
    reset_launches()
    eng, _, ref = cli.run(args + ["--renderer", "marcher", "--output", png])
    torch.cuda.synchronize()
    launches = read_launches()
    log(f"{ph}: launches {launches}")
    assert eng.last_renderer == "marcher"
    check_none(launches, sweeps_and_warps, ph)
    png_covered(png, ph)
    check_full_rays(eng, cam, W, H, ph)
    ms = synced_ms(lambda: eng.render(cam, W, H), MARCH_REPS)
    res["marcher_cli"] = (statistics.median(ms), ref.iterations)
    log(f"{ph}: iterations {ref.iterations}, ms/frame median="
        f"{statistics.median(ms):.4f} reps={[round(r, 4) for r in ms]}")
    del eng
    torch.cuda.empty_cache()

    # (c) --edge-repair: the CLI frame (K1, K2), then the marcher on its
    # suspects.
    ph = "phase 9c --edge-repair"
    png = os.path.join(out_dir, "cli_repair.png")
    reset_launches()
    eng, _, rep = cli.run(args + ["--edge-repair", "--output", png])
    torch.cuda.synchronize()
    launches = read_launches()
    log(f"{ph}: launches {launches}")
    assert eng.last_renderer == "pallas"
    assert all(launches[k] > 0 for k in ("K1", "K1 walk", "K2")), \
        f"{ph}: the sweep frame's kernels never ran"
    n_found, K = eng.last_repair_px
    assert 0 < n_found and K > 0
    png_covered(png, ph)
    eng.options.edge_repair = False
    plain = eng.render(cam, W, H)
    idx = suspect_mask(plain.color, plain.depth).reshape(-1).nonzero()[:, 0]
    assert idx.numel() == n_found
    idx = idx[:K]
    c_rep, c_ref = rep.color.reshape(-1, 4), ref.color.reshape(-1, 4)
    assert torch.equal(c_rep[idx], c_ref[idx]), \
        f"{ph}: repaired pixels differ from the marcher frame"
    d_err = float((rep.depth.reshape(-1)[idx]
                   - ref.depth.reshape(-1)[idx]).abs().max())
    assert d_err <= 1e-6, f"{ph}: repaired depth differs by {d_err}"
    keep = torch.ones(H * W, dtype=torch.bool, device=rep.color.device)
    keep[idx] = False
    assert torch.equal(c_rep[keep], plain.color.reshape(-1, 4)[keep])
    g_plain, g_rep = (
        parity.parity_row(c, ref.color)["pct_covered_gt_8_of_255"]
        for c in (plain.color, rep.color))
    log(f"{ph}: suspects n_found={n_found} K={K}; repaired pixels equal "
        f"to the marcher frame, depth within {d_err:.3g}; covered pixels "
        f"beyond 8/255 of the marcher frame: {g_plain:.4f} % without "
        f"repair, {g_rep:.4f} % with (the JAX package's beetle-grad "
        f"sweep-vs-marcher record at bench.py's pose, 1920x1080: "
        f"{JAX_BEETLE_GRAD_GAP} % of the image, "
        f"{JAX_BEETLE_GRAD_GAP_COVERED} % of covered pixels; a record, not "
        f"a gate)")
    assert g_rep < g_plain, f"{ph}: the repair did not close the gap"
    v = eng.volumes[0]
    sweep_ms = synced_ms(lambda: eng.render(cam, W, H), MARCH_REPS)
    repair_ms = synced_ms(lambda: eng._edge_repair(plain, v, cam, W, H, None),
                          MARCH_REPS)
    eng.options.edge_repair = True
    both_ms = synced_ms(lambda: eng.render(cam, W, H), MARCH_REPS)
    res["repair"] = dict(n_found=n_found, K=K, gap_plain=g_plain,
                         gap_repaired=g_rep,
                         sweep_ms=statistics.median(sweep_ms),
                         repair_ms=statistics.median(repair_ms),
                         frame_ms=statistics.median(both_ms))
    log(f"{ph}: ms median: sweep frame {res['repair']['sweep_ms']:.4f}, "
        f"repair alone {res['repair']['repair_ms']:.4f}, frame with repair "
        f"{res['repair']['frame_ms']:.4f} ({MARCH_REPS} synced reps each)")
    del eng, rep, ref, plain
    torch.cuda.empty_cache()

    # (d) --scene: the hall's depth clips the rays; the XLA sweep renders
    # the volume, never the w-grid frame.
    ph = "phase 9d --scene"
    png = os.path.join(out_dir, "cli_scene.png")
    reset_launches()
    eng, _, out = cli.run(args + ["--scene", "--output", png])
    torch.cuda.synchronize()
    launches = read_launches()
    log(f"{ph}: launches {launches}")
    assert eng.last_renderer == "sweep"
    check_none(launches, sweeps_and_warps, ph)
    png_covered(png, ph)
    mesh = sponza_lite()
    _, scene_depth = rasterize(mesh, cam, H, W, device="cuda")
    eng.options.depth_attachment = True
    vol = eng.render(cam, W, H, depth_image=scene_depth)
    eng.options.depth_attachment = False
    hit = (vol.color[..., 3] > 0) & (scene_depth > 0)
    behind = int((vol.depth[hit] < scene_depth[hit]).sum())
    log(f"{ph}: scene covers {float((scene_depth > 0).float().mean()):.4f} "
        f"of the frame; {int(hit.sum())} volume hits over the scene, "
        f"{behind} behind it")
    assert hit.any() and behind == 0, f"{ph}: {behind} hits behind the scene"
    assert bool((out.depth >= scene_depth).all())
    assert torch.equal(out.color, eng.render_with_scene(cam, W, H,
                                                        mesh).color)
    raster_ms = synced_ms(lambda: rasterize(mesh, cam, H, W, device="cuda"),
                          MARCH_REPS)
    scene_ms = synced_ms(lambda: eng.render_with_scene(cam, W, H, mesh),
                         MARCH_REPS)
    res["scene"] = dict(raster_ms=statistics.median(raster_ms),
                        frame_ms=statistics.median(scene_ms))
    log(f"{ph}: ms median: rasteriser {res['scene']['raster_ms']:.4f}, "
        f"whole frame {res['scene']['frame_ms']:.4f} ({MARCH_REPS} synced "
        f"reps each)")
    del eng, out, vol
    torch.cuda.empty_cache()
    return res


def phase_api(out_dir):
    """(a) an inverted TF range on bench.py's engine (the float occupancy
    path), (b) ``--gradient_test``, (c) ``render_frame`` on caller rays and
    its device-statistics plan, (d) the accel cache, (e) the viewer;
    returns the numbers for the summary and each step's launches."""
    import threading
    import urllib.request

    import numpy as np
    import torch
    from vkvolume_tpu_torch import cli
    from vkvolume_tpu_torch.accel.occupancy import (_occupancy_general,
                                                    _occupancy_u8,
                                                    _tf_thresholds,
                                                    occupancy_map,
                                                    voxel_alpha_positive)
    from vkvolume_tpu_torch.bench.datasets import DATASETS, synthesize
    from vkvolume_tpu_torch.bench.harness import benchmark_camera, make_engine
    from vkvolume_tpu_torch.options import Test
    from vkvolume_tpu_torch.render import plan as plan_mod
    from vkvolume_tpu_torch.render import sweep_frame
    from vkvolume_tpu_torch.render.ray_setup import (make_rays,
                                                     transpose_for_axis)
    from vkvolume_tpu_torch.tf.transfer_function import tf_params
    from vkvolume_tpu_torch.utils.image import read_png
    from vkvolume_tpu_torch.viewer import ViewerServer

    res, launches = {}, {}
    sweeps_and_warps = ("K1", "K1 texture", "K7", "K2", "K8")

    def png_covered(png, shape, ph):
        img = read_png(png)
        assert img.shape == shape, img.shape
        c = float((img.max(axis=-1) > 0).mean())
        log(f"{ph}: PNG {img.shape} covered share {c:.4f}")
        assert c >= MIN_COVERED, f"{ph}: PNG nearly empty ({c})"

    # (a) bench.py's engine, its TF edited to an inverted intensity range
    # with a gradient term: the float path's occupancy map, K3 + K4 x8,
    # then bench.py's frame through K1 + K2.
    ph = "phase 10a inverted TF"
    beetle = synthesize(DATASETS["beetle"], seed=0)
    eng = make_engine("beetle", 3, 4, volume_u8=beetle, test=Test.NONE,
                      ert=True, device="cuda")[0]
    v = eng.volumes[0]
    monotone = eng._tf(v)
    o = v.options
    reset_launches()
    (o.intensity_min, o.intensity_max, o.gradient_min,
     o.gradient_max) = INVERTED_TF
    st = eng.update_transfer_function(v)
    cam = benchmark_camera(aspect=WIDTH / HEIGHT)
    out = eng.render(cam, WIDTH, HEIGHT)
    torch.cuda.synchronize()
    launches["inverted TF"] = read_launches()
    log(f"{ph}: TF {INVERTED_TF}: launches {launches['inverted TF']}")
    tf = eng._tf(v)
    assert _tf_thresholds(tf) is None, "the TF range is monotone"
    assert eng.last_renderer == "pallas", eng.last_renderer
    assert all(launches["inverted TF"][k] > 0 for k in ("K1", "K1 walk", "K2",
                                                        "K3", "K4")), \
        f"{ph}: a kernel of the path never ran"
    shape = v.map_shape_zyx
    occ_card = occupancy_map(v.density, v.gradient, tf, shape)
    occ_cpu = occupancy_map(v.density.cpu(), v.gradient.cpu(), tf, shape)
    assert torch.equal(occ_card.cpu(), occ_cpu), \
        f"{ph}: the card's float-path map differs from the CPU's"
    imin, imax, gmin, gmax = U8_EDGE_TF
    edge_tf = tf_params(intensity_min=imin, intensity_max=imax,
                        gradient_min=gmin, gradient_max=gmax)
    assert _tf_thresholds(edge_tf) is None, "the TF range is monotone"
    edge_card = voxel_alpha_positive(v.density, v.gradient, edge_tf).cpu()
    edge_cpu = voxel_alpha_positive(v.density.cpu(), v.gradient.cpu(),
                                    edge_tf)
    n_flip = int((edge_card != edge_cpu).sum())
    assert n_flip == 0, \
        f"{ph}: TF {U8_EDGE_TF}: {n_flip} voxels differ on card and CPU"
    assert torch.equal(occupancy_map(v.density, v.gradient, edge_tf,
                                     shape).cpu(),
                       occupancy_map(v.density.cpu(), v.gradient.cpu(),
                                     edge_tf, shape)), \
        f"{ph}: TF {U8_EDGE_TF}: the card's map differs from the CPU's"
    on_edge = int((v.density == round(imin * 255)).sum())
    # Every u8 (intensity, gradient) pair at every edge level where a
    # fusion would flip, the intensity range inverted, the gradient range
    # either way.
    pair_v, pair_g = torch.meshgrid(torch.arange(256, dtype=torch.uint8),
                                    torch.arange(256, dtype=torch.uint8),
                                    indexing="ij")
    n_tf = 0
    for level in fma_edge_levels():
        lo = level / 255.0
        for g_max in (0.0, 0.999):
            t = tf_params(intensity_min=lo, intensity_max=0.0,
                          gradient_min=lo, gradient_max=g_max)
            on_card = voxel_alpha_positive(pair_v.cuda(), pair_g.cuda(), t)
            assert torch.equal(on_card.cpu(),
                               voxel_alpha_positive(pair_v, pair_g, t)), \
                f"{ph}: edge level {level}: the card's test differs"
            n_tf += 1
    log(f"{ph}: TF {U8_EDGE_TF} (edges on u8 levels; {on_edge} voxels at "
        f"intensity {round(imin * 255)}): per-voxel alpha > 0 and the map "
        f"equal on card and CPU ({int(edge_cpu.sum())} positive voxels); "
        f"every u8 (intensity, gradient) pair equal on card and CPU at "
        f"{n_tf} TFs, edges on each u8 level where a fused multiply-add "
        f"flips")
    del edge_card, edge_cpu
    occ_plain, maps_plain = plain_maps(eng)
    assert torch.equal(occ_plain, occ_card)
    assert torch.equal(v.dist_maps, maps_plain), \
        f"{ph}: maps differ from their plain versions"
    n_occ = int((occ_card == 0).sum())
    color = out.color
    assert bool(torch.isfinite(color).all())
    covered = float((color[..., 3] > 0).float().mean())
    assert covered >= MIN_COVERED, f"{ph}: frame nearly empty ({covered})"
    check_against_plain_frame(eng, cam, color, WIDTH, HEIGHT, ph)
    # For a monotone TF the float path equals the integer path.
    thr = _tf_thresholds(monotone)
    general = _occupancy_general(v.density, None, monotone, shape)
    integer = _occupancy_u8(v.density, None, shape, *thr)
    assert torch.equal(general, integer), f"{ph}: float != integer path"
    res["general_occ_ms"] = gpu_timer(
        lambda: _occupancy_general(v.density, v.gradient, tf, shape), 5)
    res["integer_occ_ms"] = gpu_timer(
        lambda: _occupancy_u8(v.density, None, shape, *thr), 5)
    res["inverted_map_update_ms"] = st.map_update_ms
    res["inverted_frame_ms"] = statistics.median(
        synced_ms(lambda: eng.render(cam, WIDTH, HEIGHT), MARCH_REPS))
    log(f"{ph}: occupancy map {shape} equal on card and CPU and to the "
        f"plain maps ({n_occ} occupied cells), 8 octant maps equal to "
        f"their plain versions; frame covered share {covered:.4f}; "
        f"map_update_ms {st.map_update_ms:.4f} (20 builds, benchmark mode),"
        f" float-path occupancy {res['general_occ_ms']:.4f} ms vs the "
        f"integer path's {res['integer_occ_ms']:.4f} (card, queued), frame "
        f"{res['inverted_frame_ms']:.4f} ms (median of {MARCH_REPS} synced)")
    del eng, out, color, occ_cpu
    torch.cuda.empty_cache()

    # (b) --gradient_test: gradients computed in the map build (K5 + the
    # two-sided K4); the frame, without a gradient map, takes the XLA
    # sweep.
    ph = "phase 10b --gradient_test"
    W, H = CLI_WIDTH, CLI_HEIGHT
    png = os.path.join(out_dir, "cli_gradient_test.png")
    reset_launches()
    eng, _, out = cli.run(["--synth", "beetle", "--width", str(W),
                           "--height", str(H), "--gradient_test",
                           "--output", png])
    torch.cuda.synchronize()
    launches["--gradient_test"] = read_launches()
    log(f"{ph}: launches {launches['--gradient_test']}")
    v = eng.volumes[0]
    assert v.gradient is None and eng.last_renderer == "sweep"
    assert all(launches["--gradient_test"][k] > 0
               for k in ("K5", "K4 two-sided"))
    check_none(launches["--gradient_test"], sweeps_and_warps, ph)
    assert torch.equal(v.dist_maps, plain_maps(eng)[1]), \
        f"{ph}: maps differ from their plain versions"
    png_covered(png, (H, W, 3), ph)
    cam = cli.cli_camera(W, H)
    res["on_the_fly_update_ms"] = statistics.median(synced_ms(
        lambda: eng.update_transfer_function(v), MARCH_REPS))
    res["gradient_test_frame_ms"] = statistics.median(synced_ms(
        lambda: eng.render(cam, W, H), MARCH_REPS))
    log(f"{ph}: TF edit with on-the-fly gradients "
        f"{res['on_the_fly_update_ms']:.4f} ms, XLA-sweep frame "
        f"{res['gradient_test_frame_ms']:.4f} ms (medians of {MARCH_REPS} "
        f"synced)")
    del eng, out
    torch.cuda.empty_cache()

    # (d) the accel cache: the CLI's engine saves its maps, a second engine
    # restores them (no map build) and renders the same frame.
    ph = "phase 10d accel cache"
    cache_dir = os.path.join(out_dir, "accel_cache")
    args = cli.build_parser().parse_args(["--synth", "beetle", "--width",
                                          str(W), "--height", str(H)])
    eng1, (v1,) = cli.setup_engine(args)
    eng1.accel_cache_dir = cache_dir
    t0 = time.perf_counter()
    eng1.add_volume(v1)
    torch.cuda.synchronize()
    res["cache_build_save_s"] = time.perf_counter() - t0
    eng, (v,) = cli.setup_engine(args)
    eng.accel_cache_dir = cache_dir
    reset_launches()
    t0 = time.perf_counter()
    stats = eng.add_volume(v)
    torch.cuda.synchronize()
    res["cache_restore_s"] = time.perf_counter() - t0
    out = eng.render(cam, W, H)
    torch.cuda.synchronize()
    launches["cache restore"] = read_launches()
    log(f"{ph}: launches {launches['cache restore']}")
    assert stats.map_update_ms is None, f"{ph}: the maps were rebuilt"
    check_none(launches["cache restore"], ("K3", "K4", "K4 two-sided", "K5",
                                           "occupancy"), ph)
    assert launches["cache restore"]["K1"] > 0
    assert v.dist_maps.device.type == "cuda"
    assert torch.equal(v.dist_maps, v1.dist_maps)
    assert torch.equal(v.gradient, v1.gradient)
    assert torch.equal(out.color, eng1.render(cam, W, H).color)
    (name,) = os.listdir(cache_dir)
    mb = os.path.getsize(os.path.join(cache_dir, name)) / 1e6
    log(f"{ph}: build + save {res['cache_build_save_s']:.2f} s, restore "
        f"{res['cache_restore_s']:.2f} s ({mb:.1f} MB file); maps, gradient "
        f"and frame equal")
    del eng1, v1
    torch.cuda.empty_cache()

    # (c) render_frame on the caller's rays: at the CLI pose (the host
    # plan) against the engine's frame, and at a pose whose engine plan
    # takes another axis than the host analysis, so that render_frame
    # plans from the rays' device statistics; each against its plain frame.
    ph = "phase 10c render_frame"
    tf = eng._tf(v)
    res["render_frame"] = {}
    for az in (30.0, DEVICE_STATS_AZIMUTH):
        cam = cli.cli_camera(W, H, azimuth=az)
        ref = eng.render(cam, W, H)
        pose = next(q for k, q in v._sweep_cache.items()
                    if isinstance(k, tuple) and k[0] == "pose"
                    and k[1][:2] == (cam.view.tobytes(), cam.proj.tobytes()))
        u, p = pose["uniforms"], pose["view"]["p_axis"]
        vol_t = v._sweep_cache[p]
        occ_t = transpose_for_axis(v.dist_maps[0], p)
        rays = make_rays(u, H, W, "cuda")
        device_stats = plan_mod.analyze_view(u, H, W)["p_axis"] != p
        t0 = time.perf_counter()
        plan = sweep_frame.plan_frame(u, rays, p, tuple(vol_t.shape), H, W)
        plan_ms = (time.perf_counter() - t0) * 1e3
        assert plan is not None and device_stats == (
            az == DEVICE_STATS_AZIMUTH), (az, p)
        grad_t = transpose_for_axis(v.gradient, p)
        kw = dict(p_axis=p, ert=eng.options.early_ray_termination,
                  oversample=eng._slab_oversample(v, vol_t.shape, tf),
                  dist_leap=True)

        def frame():
            return sweep_frame.render_frame(vol_t, occ_t, tf, rays, u,
                                            eng._pvm(cam, v), grad_t, **kw)

        reset_launches()
        got = frame()
        torch.cuda.synchronize()
        key = f"render_frame azimuth {az:.0f}"
        launches[key] = read_launches()
        warp = ("two-pass" if plan["RECT_A"] else
                "K8" if plan["R_warp"] else "gather")
        log(f"{ph} azimuth {az:.0f}: "
            f"{'device-stats' if device_stats else 'host'} plan "
            f"Hi={plan['Hi']} Wi={plan['Wi']} R_brick={plan.get('R_brick')} "
            f"warp={warp} ({plan_ms:.2f} ms); launches {launches[key]}")
        sweep = "K1" if launches[key]["K1"] else "K7"
        assert launches[key][sweep] > 0
        if device_stats:
            assert launches[key]["K2"] or launches[key]["K8"] \
                or plan.get("warp_xla")
        with plain_kernels():
            want = frame()
        diff = (got.color - want.color).abs().amax(-1)
        bad = float((diff > FRAME_TOL).float().mean())
        da = abs(float(got.color[..., 3].mean())
                 - float(want.color[..., 3].mean()))
        d_eng = (got.color - ref.color).abs().amax(-1)
        same_plan = plan.keys() == pose["plan"].keys() and all(
            np.array_equal(np.asarray(plan[k]), np.asarray(pose["plan"][k]))
            for k in plan)
        cross = float((d_eng > CROSS_TOL).float().mean())
        cov = covered_share(got.color)
        log(f"{ph} azimuth {az:.0f}: vs its plain frame max "
            f"{float(diff.max()):.3g}, share > {FRAME_TOL}: {bad:.3g}, mean "
            f"alpha diff {da:.3g}; vs the engine's frame (plan equal: "
            f"{same_plan}) max {float(d_eng.max()):.3g}, share > "
            f"{CROSS_TOL}: {cross:.3g}; covered share {cov:.4f}")
        assert bad <= FRAME_BAD_SHARE and da <= FRAME_ALPHA_MEAN
        assert cov >= MIN_COVERED
        if same_plan:
            assert torch.equal(got.color, ref.color)
        elif not device_stats:
            assert cross <= CROSS_BAD_SHARE
        ms = statistics.median(synced_ms(frame, MARCH_REPS))
        eng_ms = statistics.median(synced_ms(lambda: eng.render(cam, W, H),
                                             MARCH_REPS))
        stats_ms = statistics.median(synced_ms(
            lambda: sweep_frame.stats_to_dict(
                sweep_frame.plan_stats(rays, p)), MARCH_REPS))
        res["render_frame"][az] = dict(ms=ms, engine_ms=eng_ms,
                                       plan_ms=plan_ms, stats_ms=stats_ms,
                                       device_stats=device_stats,
                                       sweep=sweep)
        log(f"{ph} azimuth {az:.0f}: render_frame {ms:.4f} ms, the "
            f"engine's frame {eng_ms:.4f} ms, plan_stats + copy "
            f"{stats_ms:.4f} ms (medians of {MARCH_REPS} synced)")
    del eng, v, out, ref, got, want
    torch.cuda.empty_cache()

    # (e) the viewer on a free port, in a thread, on the CLI's engine.
    ph = "phase 10e viewer"
    eng, (v,) = cli.setup_engine(args)
    eng.add_volume(v)
    srv = ViewerServer(eng, v, VIEWER_WIDTH, VIEWER_HEIGHT, port=0)
    thread = threading.Thread(target=srv.httpd.serve_forever, daemon=True)
    thread.start()
    reset_launches()
    res["viewer"] = []
    try:
        def get(path):
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{srv.port}{path}", timeout=300) as r:
                return r.read(), dict(r.headers)

        page, hdrs = get("/")
        assert b"imin" in page and "text/html" in hdrs["Content-Type"]
        steps = (("frame", "azimuth=30&elevation=20", "pallas"),
                 ("same TF", "azimuth=30&elevation=20", "pallas"),
                 ("TF edit", "imin=0.15&azimuth=30&elevation=20", "pallas"),
                 ("imin > imax", "imin=0.6&imax=0.1&azimuth=30&elevation=20",
                  "pallas"),
                 ("skipmode 3", "imin=0.6&imax=0.1&skipmode=3&azimuth=30"
                  "&elevation=20", "pallas"),
                 ("scene", "imin=0.6&imax=0.1&skipmode=3&scene=1&azimuth=30"
                  "&elevation=20", "sweep"))
        for name, query, route in steps:
            reset_launches()
            png, h = get("/frame.png?" + query)
            torch.cuda.synchronize()
            got = read_launches()
            path = os.path.join(out_dir, "viewer.png")
            with open(path, "wb") as f:
                f.write(png)
            assert png[:8] == b"\x89PNG\r\n\x1a\n"
            assert read_png(path).shape == (VIEWER_HEIGHT, VIEWER_WIDTH, 3)
            assert h["X-Renderer"] == route, (name, h["X-Renderer"])
            upd, ren = float(h["X-Update-Ms"]), float(h["X-Render-Ms"])
            assert (upd == 0.0) == (name in ("frame", "same TF", "scene"))
            if route == "pallas":
                assert got["K1"] + got["K7"] > 0
            else:
                check_none(got, sweeps_and_warps, f"{ph} {name}")
            if name == "skipmode 3":
                assert got["K3"] > 0 and got["K4"] > 0
            res["viewer"].append((name, upd, ren, h["X-Renderer"]))
            launches["viewer"] = {k: launches.get("viewer", {}).get(k, 0) + n
                                  for k, n in got.items()}
            log(f"{ph} {name}: X-Update-Ms {upd}, X-Render-Ms {ren}, "
                f"X-Renderer {h['X-Renderer']}, X-Occupied-Pct "
                f"{h['X-Occupied-Pct']}, PNG {len(png)} bytes; launches {got}")
        body, _ = get("/stats")
        assert json.loads(body)["frames"] == len(steps)
    finally:
        srv.shutdown()
        thread.join(timeout=60)
    assert not thread.is_alive()
    del eng, v
    torch.cuda.empty_cache()
    return res, launches


# ---------------------------------------------------------------- phase 11
# The multi-device modes (vkvolume_tpu_torch/parallel) with MULTI_RANKS
# ranks time-sharing the one card under gloo (NCCL refuses two ranks on one
# device; gloo stages each collective through host memory), and one rank
# under NCCL. Every rank reports its launch counters and timings; rank 0
# returns the outputs, which this process holds against the single-device
# paths on the same inputs.
MULTI_RANKS = 4
MULTI_REPS = 3          # synced calls timed per case (median)
MULTI_DEADLINE_S = 600.0
MULTI_TALL = 1024       # 1280x1024 splits into 8-row tiles over 4 ranks
# tests/test_parallel.py's tolerances: march_sharded's colour;
# march_volume_sharded's max colour, mean alpha and depth against the
# single-device march; sweep_volume_sharded's colour without and with ERT
# (the cross-slab tail), depth on hit pixels and the hit sets' agreement.
MARCH_SHARDED_TOL = 1e-5
VOL_MARCH_TOL = (0.06, 2e-3, 2e-2)
VOL_SWEEP_TOL = {False: 2e-3, True: 0.011}
VOL_SWEEP_DEPTH_TOL, VOL_SWEEP_HIT_SHARE = 1e-3, 0.995
BRICK_HALO = 9          # sweep_volume_sharded's halo planes (BRICK + 1)


def rank_ms(mesh, fn) -> float:
    """Median host ms of MULTI_REPS calls of ``fn`` on every rank of
    ``mesh`` together: each starts after a barrier and ends when the last
    rank's card has finished."""
    import torch
    import torch.distributed as dist

    ts = []
    for _ in range(MULTI_REPS):
        torch.cuda.synchronize()
        dist.barrier(group=mesh.group)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        dist.barrier(group=mesh.group)
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def gather_ms(mesh, shapes, dim: int) -> tuple:
    """(bytes every rank receives, median ms) of one all-gather of a
    tensor of each (shape, dtype) in ``shapes`` along ``dim``, the
    collective a mode runs."""
    import torch

    parts = [torch.zeros(s, dtype=d, device=mesh.device) for s, d in shapes]
    nbytes = sum(t.nbytes for t in parts) * mesh.size
    return nbytes, rank_ms(mesh, lambda: [mesh.all_gather(t, dim)
                                          for t in parts])


def multi_rank(mesh, job):
    """Phase 11 on one rank: the cases of ``job`` in order, each driven
    once with the launch counters at 0 just before it and read just after,
    then timed. Returns per case the counters, ms, the collective's bytes
    and ms, the volume bytes the rank put on its device, and on mesh rank
    0 the outputs (numpy)."""
    import numpy as np
    import torch
    from vkvolume_tpu_torch import parallel
    from vkvolume_tpu_torch.options import SkippingType
    from vkvolume_tpu_torch.parallel import mesh as mesh_mod

    meshes = {mesh.size: mesh}
    if job.get("sub"):
        # Every rank of the world creates the sub-mesh; the others get None.
        meshes[job["sub"]] = parallel.make_mesh(job["sub"],
                                                device=str(mesh.device))
    slab_bytes = []
    take = mesh_mod._take_planes

    def counted_take(a, idx, device):
        t = take(a, idx, device)
        slab_bytes.append((t.nbytes, np.asarray(a[:1]).nbytes * a.shape[0]))
        return t

    mesh_mod._take_planes = counted_take
    host = {k: np.load(path, mmap_mode="r")
            for k, path in job["host"].items()}
    res = {"rank": mesh.rank, "backend": mesh.backend,
           "device": str(mesh.device)}
    for name, c in job["cases"].items():
        m = meshes[c["n"]]
        if m is None:
            continue
        kind = c["kind"]
        march_kw = dict(skipping_type=SkippingType.DISTANCE,
                        early_ray_termination=True,
                        precomputed_gradient=True, count_samples=True)
        if kind == "frame":
            def fn():
                return parallel.render_frame_sharded(
                    m, c["vol_t"], c["occ_t"], c["tf"], c["rays"], c["u"],
                    c["pvm"], c["grad_t"], p_axis=c["p"], ert=True,
                    oversample=c["oversample"], dist_leap=True,
                    plan=c.get("plan"))
        elif kind == "frame_error":
            try:
                parallel.render_frame_sharded(
                    m, c["vol_t"], c["occ_t"], c["tf"], c["rays"], c["u"],
                    c["pvm"], c["grad_t"], p_axis=c["p"], ert=True,
                    oversample=c["oversample"], dist_leap=True)
            except ValueError as e:
                res[name] = {"error": str(e)}
                continue
            raise AssertionError(f"{name}: no ValueError")
        elif kind == "march":
            def fn():
                return parallel.march_sharded(
                    m, c["density"], c["gradient"], c["maps"], c["tf"],
                    c["rays"], c["bs"], c["pvm"], **march_kw)
        elif kind == "march_volume":
            def fn():
                return parallel.march_volume_sharded(
                    m, host["density"], host["gradient"], c["maps"],
                    c["tf"], c["rays"], c["bs"], c["pvm"], **march_kw)
        else:
            def fn():
                return parallel.sweep_volume_sharded(
                    m, host["vol_t"], host["occ_t"], c["tf"], c["u"],
                    c["pvm"], host["grad_t"], p_axis=c["p"],
                    height=c["height"], width=c["width"], ert=c["ert"],
                    dist_leap=True)
        slab_bytes.clear()
        reset_launches()
        out = fn()
        torch.cuda.synchronize()
        r = {"launches": read_launches(), "slab_bytes": list(slab_bytes),
             "local_rows": int(out.color.shape[0])}
        if kind in ("frame", "march"):
            # The rows of every rank: what XLA gathers from JAX's output
            # sharding.
            t0 = time.perf_counter()
            out = parallel.gather_rows(out, m)
            torch.cuda.synchronize()
            r["gather_rows_ms"] = (time.perf_counter() - t0) * 1e3
        if m.rank == 0:
            r["out"] = {k: getattr(out, k).cpu().numpy()
                        for k in ("color", "depth", "num_volume_samples",
                                  "num_distance_samples",
                                  "num_empty_samples")}
            r["iterations"] = int(out.iterations)
        del out
        r["ms"] = rank_ms(m, fn)
        r["collective"] = gather_ms(m, c["gathered"], c["gather_dim"])
        res[name] = r
    mesh_mod._take_planes = take
    return res


def phase_multi(tmp_dir):
    """(a) ``render_frame_sharded`` at the CLI pose, (b) ``march_sharded``,
    (c) ``march_volume_sharded``, (d) ``sweep_volume_sharded``, each
    against the single-device path on the card; returns the numbers for
    the summary and each case's launches (summed over its ranks)."""
    import numpy as np
    import torch
    from vkvolume_tpu_torch import cli, parallel
    from vkvolume_tpu_torch.options import SkippingType
    from vkvolume_tpu_torch.render import plan as plan_mod
    from vkvolume_tpu_torch.render import sweep_bricks, sweep_frame
    from vkvolume_tpu_torch.render.marcher import march
    from vkvolume_tpu_torch.render.ray_setup import (make_rays,
                                                     transpose_for_axis)

    W, H = CLI_WIDTH, CLI_HEIGHT
    f32 = torch.float32
    args = cli.build_parser().parse_args(["--synth", "beetle", "--width",
                                          str(W), "--height", str(H)])
    eng, (v,) = cli.setup_engine(args)
    eng.add_volume(v)
    tf = eng._tf(v)
    res, cases, refs = {}, {}, {}

    def pose(w, h):
        cam = cli.cli_camera(w, h)
        eng.render(cam, w, h)
        q = next(q for k, q in v._sweep_cache.items()
                 if isinstance(k, tuple) and k[0] == "pose"
                 and k[1][:2] == (cam.view.tobytes(), cam.proj.tobytes()))
        return cam, q["uniforms"], q["view"]["p_axis"]

    # (a) the w-grid frame: the planner's plan and the other warp variant
    # (plan.two_pass_warp_plan's only_variant) at n = 2 and 4; n = 4 at
    # 1280x720 (720 rows do not split into 8-row tiles over 4 ranks).
    frame_in = {}
    for n, h in ((2, H), (MULTI_RANKS, MULTI_TALL)):
        cam, u, p = pose(W, h)
        vol_t = v._sweep_cache[p]
        kw = dict(vol_t=vol_t, occ_t=transpose_for_axis(v.dist_maps[0], p),
                  grad_t=transpose_for_axis(v.gradient, p), tf=tf,
                  rays=make_rays(u, h, W, "cuda"), u=u, pvm=eng._pvm(cam, v),
                  p=p, oversample=eng._slab_oversample(v, vol_t.shape, tf))
        frame_in[h] = kw
        plan = sweep_frame.plan_frame(u, kw["rays"], p, tuple(vol_t.shape),
                                      h, W)
        assert plan is not None and plan["RECT_A"] is not None, plan
        other = "A" if plan["warp_variant"] == "B" else "B"
        tp = plan_mod.two_pass_warp_plan(
            u, p, h, W, plan, plan_mod.analyze_view(u, h, W),
            only_variant=other)
        assert tp is not None, f"variant {other} infeasible at {W}x{h}"
        for variant, pl in ((plan["warp_variant"], None),
                            (other, dict(plan, **tp))):
            name = f"a n={n} {W}x{h} {variant}"
            used = plan if pl is None else pl
            cases[name] = dict(kw, kind="frame", n=n, plan=pl,
                               gathered=[((3, used["Hi"] // n, used["Wi"]),
                                          f32)], gather_dim=1)

            def ref(kw=kw, pl=pl):
                a = (kw["vol_t"], kw["occ_t"], kw["tf"], kw["rays"], kw["u"],
                     kw["pvm"], kw["grad_t"])
                o = dict(p_axis=kw["p"], ert=True,
                         oversample=kw["oversample"], dist_leap=True)
                if pl is None:
                    return sweep_frame.render_frame(*a, **o)
                return sweep_frame.render_planned(*a, pl, **o)

            refs[name] = (used, ref)
    cases["a n=4 1280x720 error"] = dict(frame_in[H], kind="frame_error",
                                         n=MULTI_RANKS)

    # (b), (c) --renderer marcher's march at the CLI pose; (d) the brick
    # sweep of the volume slabs, ERT off and on.
    cam, u, p = pose(W, H)
    rays = make_rays(u, H, W, "cuda", full=True)
    mk = dict(tf=tf, rays=rays, bs=u.block_size, pvm=eng._pvm(cam, v),
              maps=v.dist_maps)
    px = [((H, W, 4), f32), ((H, W), f32)] + [((H, W), torch.int32)] * 3
    cases["b march_sharded"] = dict(
        mk, kind="march", n=MULTI_RANKS, density=v.density,
        gradient=v.gradient,
        gathered=[((H // MULTI_RANKS,) + s[1:], d) for s, d in px],
        gather_dim=0)
    cases["c march_volume_sharded"] = dict(
        mk, kind="march_volume", n=MULTI_RANKS,
        gathered=[((1,) + s, d) for s, d in px], gather_dim=0)
    vol_t = v._sweep_cache[p]
    occ_t = transpose_for_axis(v.dist_maps[0], p)
    grad_t = transpose_for_axis(v.gradient, p)
    Np = vol_t.shape[0]
    # sweep_volume_sharded's slab: bp-aligned planes per rank plus the halo.
    bp = -(-Np // occ_t.shape[0])
    Pz = -(-(-(-Np // MULTI_RANKS)) // bp) * bp
    np_loc = -(-(Pz + BRICK_HALO) // bp) * bp
    view, splan = sweep_frame.select_view_plan(
        u, H, W, lambda q: tuple(vol_t.shape), axes=(p,))
    assert splan is not None and splan.get("R_brick") is not None
    Hi, Wi = splan["Hi"], splan["Wi"]
    for ert in (False, True):
        cases[f"d sweep_volume_sharded ert={ert}"] = dict(
            kind="sweep_volume", n=MULTI_RANKS, tf=tf, u=u,
            pvm=eng._pvm(cam, v), p=p, height=H, width=W, ert=ert,
            gathered=[((1, Hi, Wi, 4), f32), ((1, Hi, Wi), f32),
                      ((1, Hi, Wi), torch.int32)], gather_dim=0)
    host = {}
    for k, t in (("density", v.density), ("gradient", v.gradient),
                 ("vol_t", vol_t), ("occ_t", occ_t), ("grad_t", grad_t)):
        host[k] = os.path.join(tmp_dir, f"{k}.npy")
        np.save(host[k], t.cpu().numpy())

    # The single-device references, on the same inputs.
    t0 = time.perf_counter()
    single = {name: fn() for name, (_, fn) in refs.items()}
    single_ms = {name: statistics.median(synced_ms(fn, MULTI_REPS))
                 for name, (_, fn) in refs.items()}
    m_ref = march(v.density, v.gradient, v.dist_maps, tf, rays, u.block_size,
                  mk["pvm"], skipping_type=SkippingType.DISTANCE,
                  early_ray_termination=True, precomputed_gradient=True,
                  count_samples=True)
    march_ms = statistics.median(synced_ms(lambda: march(
        v.density, v.gradient, v.dist_maps, tf, rays, u.block_size,
        mk["pvm"], skipping_type=SkippingType.DISTANCE,
        early_ray_termination=True, precomputed_gradient=True,
        count_samples=True), MULTI_REPS))
    sgn = 1 if splan["sgn_p"] > 0 else -1
    gp = [splan["wu0"], splan["dwu"], splan.get("cu", 0.0) or 0.0,
          splan["wv0"], splan["dwv"], splan.get("cv", 0.0) or 0.0]
    wu, wv = sweep_frame.w_grid(gp, Hi, Wi, "cuda")
    s_lo, s_hi, cov, kappa = sweep_bricks.grid_fields(
        u, wu, wv, sgn, p, max(vol_t.shape), Np)
    s_ref = {ert: sweep_bricks.sweep_bricks(
        vol_t, occ_t, tf, u, mk["pvm"], (wu, wv, s_lo, s_hi, kappa, cov),
        p_axis=p, ert=ert, count_samples=False, n_slabs=Np, sgn=sgn,
        tile_h=splan["tile_h"], dist_leap=True, grad_t=grad_t)
        for ert in (False, True)}
    torch.cuda.synchronize()
    log(f"phase 11: single-device references in "
        f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    job = {"cases": cases, "host": host, "sub": 2}
    ranks = parallel.spawn(multi_rank, MULTI_RANKS, backend="gloo",
                           args=(job,), timeout=MULTI_DEADLINE_S)
    log(f"phase 11: {MULTI_RANKS} gloo ranks in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    nccl_name = f"a n=1 {W}x{H} nccl"
    first = next(k for k in cases if k.startswith(f"a n=2 {W}x{H}"))
    plan = refs[first][0]
    nccl_job = {"cases": {nccl_name: dict(
        cases[first], n=1, gathered=[((3, plan["Hi"], plan["Wi"]), f32)])},
        "host": host, "sub": None}
    (nccl,) = parallel.spawn(multi_rank, 1, backend="nccl",
                             args=(nccl_job,), timeout=MULTI_DEADLINE_S)
    log(f"phase 11: 1 nccl rank in {time.perf_counter() - t0:.1f} s")
    refs[nccl_name] = refs[first]
    single[nccl_name] = single[first]
    single_ms[nccl_name] = single_ms[first]

    launches = {}

    def summed(name, rs):
        return {k: sum(r[name]["launches"][k] for r in rs)
                for k in rs[0][name]["launches"]}

    def line(name, rs, what, backend):
        r0 = rs[0][name]
        nbytes, cms = r0["collective"]
        log(f"phase 11 {name}: {what}; {backend}, "
            f"{len(rs)} ranks: {r0['ms']:.4f} ms (median of {MULTI_REPS} "
            f"synced calls), collective {nbytes} bytes {cms:.4f} ms; "
            f"launches {launches[name]}")

    groups = [(name, ranks[:cases[name]["n"]], "gloo") for name in cases]
    groups.append((nccl_name, [nccl], "nccl"))
    frames = {}
    for name, rs, backend in groups:
        if name.startswith("a") and "error" in name:
            for r in rs:
                assert "not tile-divisible" in r[name]["error"], r[name]
            log(f"phase 11 {name}: ValueError on every rank "
                f"({rs[0][name]['error']})")
            continue
        launches[name] = summed(name, rs)
        for r in rs:
            assert r["backend"] == backend, (r["backend"], backend)
        out = rs[0][name]["out"]
        if name.startswith("a"):
            plan = refs[name][0]
            want = single[name]
            swept = ["K1" if r[name]["launches"]["K1"] else "K7"
                     for r in rs]
            for r, s in zip(rs, swept):
                assert r[name]["launches"][s] > 0 and \
                    r[name]["launches"]["K2"] > 0, (name, r[name]["launches"])
                assert r[name]["local_rows"] == (
                    want.color.shape[0] // len(rs))
            same = (plan["Hi"] // len(rs)) % plan["tile_h"] == 0
            got_c = torch.from_numpy(out["color"]).cuda()
            got_d = torch.from_numpy(out["depth"]).cuda()
            err = {k: float((a - b).abs().max()) for k, a, b in (
                ("lum", got_c[..., 0], want.color[..., 0]),
                ("alpha", got_c[..., 3], want.color[..., 3]),
                ("depth", got_d, want.depth))}
            if same and swept[0] == "K1":
                assert all(e == 0.0 for e in err.values()), (name, err)
            else:
                diff = (got_c - want.color).abs().amax(-1)
                bad = float((diff > FRAME_TOL).float().mean())
                da = abs(float(got_c[..., 3].mean())
                         - float(want.color[..., 3].mean()))
                assert bad <= FRAME_BAD_SHARE and da <= FRAME_ALPHA_MEAN, \
                    (name, bad, da)
            assert covered_share(got_c) >= MIN_COVERED
            frames[name] = dict(ms=rs[0][name]["ms"],
                                single_ms=single_ms[name],
                                collective=rs[0][name]["collective"],
                                variant=plan["warp_variant"], sweep=swept[0],
                                backend=backend, n=len(rs))
            line(name, rs, f"Hi={plan['Hi']} Wi={plan['Wi']} tile_h="
                 f"{plan['tile_h']} variant {plan['warp_variant']}, "
                 f"{swept[0]} + K2 on every rank, max err vs the "
                 f"single-device frame {err}, single-device "
                 f"{single_ms[name]:.4f} ms, gather_rows "
                 f"{rs[0][name]['gather_rows_ms']:.2f} ms", backend)
        elif name.startswith("b"):
            for r in rs:
                check_none(r[name]["launches"], ("K1", "K7", "K2", "K8"),
                           name)
            for k in ("num_volume_samples", "num_distance_samples",
                      "num_empty_samples"):
                assert np.array_equal(out[k], getattr(m_ref, k).cpu().numpy()
                                      ), f"{name}: {k} differs"
            err = float(np.abs(out["color"]
                               - m_ref.color.cpu().numpy()).max())
            assert err <= MARCH_SHARDED_TOL, (name, err)
            assert rs[0][name]["iterations"] == m_ref.iterations
            res["march_sharded"] = dict(ms=rs[0][name]["ms"],
                                        single_ms=march_ms,
                                        collective=rs[0][name]["collective"])
            line(name, rs, f"counters equal on every pixel, colour max err "
                 f"{err:.3g}, iterations {m_ref.iterations}, no sweep or "
                 f"warp launch, single-device {march_ms:.4f} ms", backend)
        elif name.startswith("c"):
            a = m_ref.color.cpu().numpy()
            b = out["color"]
            e_max = float(np.abs(a - b).max())
            e_alpha = abs(float(a[..., 3].mean()) - float(b[..., 3].mean()))
            e_depth = float(np.abs(out["depth"]
                                   - m_ref.depth.cpu().numpy()).max())
            assert e_max < VOL_MARCH_TOL[0] and e_alpha < VOL_MARCH_TOL[1] \
                and e_depth <= VOL_MARCH_TOL[2], (e_max, e_alpha, e_depth)
            D = v.density.shape[0]
            Pz = -(-D // len(rs))
            for r in rs:
                sl = r[name]["slab_bytes"]
                assert len(sl) == 2, sl             # density, gradient
                assert all(got * D <= (Pz + 4) * full for got, full in sl), sl
            res["march_volume_sharded"] = dict(
                ms=rs[0][name]["ms"], collective=rs[0][name]["collective"],
                slab=rs[0][name]["slab_bytes"][0])
            line(name, rs, f"vs the single-device march: max colour "
                 f"{e_max:.4g}, mean alpha {e_alpha:.3g}, depth "
                 f"{e_depth:.3g}; each rank's slabs "
                 f"{[b for b, _ in rs[0][name]['slab_bytes']]} bytes of "
                 f"{rs[0][name]['slab_bytes'][0][1]} (Pz + 4 = {Pz + 4} of "
                 f"{D} planes)", backend)
        else:
            ert = name.endswith("True")
            ref = s_ref[ert]
            for r in rs:
                assert r[name]["launches"]["K1"] > 0, (name, r[name])
                sl = r[name]["slab_bytes"]
                assert len(sl) == 3, sl             # volume, gradient, occ
                assert all(got * Np <= np_loc * full for got, full in sl), sl
            rc, rd = ref.color.cpu().numpy(), ref.depth.cpu().numpy()
            oc, od = out["color"], out["depth"]
            e = float(np.abs(oc - rc).max())
            hit = (rd != 0) & (od != 0)
            e_d = float(np.abs(od[hit] - rd[hit]).max())
            agree = float(((rd != 0) == (od != 0)).mean())
            assert e < VOL_SWEEP_TOL[ert] and e_d <= VOL_SWEEP_DEPTH_TOL \
                and agree >= VOL_SWEEP_HIT_SHARE, (name, e, e_d, agree)
            assert rc[..., 3].max() > 0.3
            res[f"sweep_volume_sharded ert={ert}"] = dict(
                ms=rs[0][name]["ms"], collective=rs[0][name]["collective"],
                slab=rs[0][name]["slab_bytes"][0])
            line(name, rs, f"grid {Hi}x{Wi}: K1 on every rank; vs the "
                 f"single-device brick sweep: colour {e:.3g}, depth on hits "
                 f"{e_d:.3g}, hit sets agree {agree:.5f}; each rank's "
                 f"slabs {[b for b, _ in rs[0][name]['slab_bytes']]} bytes "
                 f"({np_loc} of {Np} planes)", backend)
    variants = {(f["n"], f["variant"]) for f in frames.values()}
    assert {(2, "A"), (2, "B"), (4, "A"), (4, "B")} <= variants, variants
    res["frames"] = frames
    del eng, v, single, refs, cases
    torch.cuda.empty_cache()
    return res, launches


# Phase 12: cuts of the measurement protocols (vkvolume_tpu_torch.bench:
# parity, session, orbit, ess_ratio) through their own functions, on the
# full-scale beetle at bench.py's pose.
PROTO_PARITY_KEYS = ("beetle", "beetle-grad")
PROTO_EDITS = 4         # slider edits of the session (the protocol: 12)
PROTO_ORBIT_FRAMES = 5  # frames a repetition of the orbit (10)
PROTO_ESS_FRAMES = 2    # frames a repetition of the ESS ratio (10)
# The JAX package's parity rows at 1920x1080, scale 1, every skipmode
# alike (docs/parity_r5.json): % of the image beyond 8/255 by default and
# with edge repair, and the oracle's covered pixels. A record, not a gate.
JAX_PARITY_R5 = {"beetle": (0.08714, 0.00077, 261030),
                 "beetle-grad": (0.38301, 0.0001, 205922)}
# The distance kernels each skipmode's TF edit runs.
SKIPMODE_KERNELS = {0: (), 1: (), 2: ("K5", "K4 two-sided"),
                    3: ("K3", "K4")}
DISTANCE_KERNELS = ("K3", "K4", "K4 two-sided", "K5", "K6")


def phase_protocols(tmp_dir):
    """(a) the parity matrix's beetle rows, (b) the interactive session,
    (c) the orbit, (d) the ESS ratio, (e) the per-ray sample counts, (f)
    warp against quadrature; returns the numbers for the summary and each
    protocol's kernel launches."""
    import torch
    from vkvolume_tpu_torch.bench import (ess_ratio, orbit, parity,
                                          sample_count, session,
                                          warp_vs_quadrature)
    from vkvolume_tpu_torch.bench.datasets import DATASETS, synthesize

    res = {}
    counts = {}

    def count(path, launches):
        total = counts.setdefault(path, dict.fromkeys(launches, 0))
        for k, n in launches.items():
            total[k] += n
    W, H = WIDTH, HEIGHT
    beetle = synthesize(DATASETS["beetle"], seed=0)   # phase 1's, cached
    sweeps_and_warps = ("K1", "K1 texture", "K7", "K2", "K8")
    for key in PROTO_PARITY_KEYS:
        ph = f"phase 12a {key}"
        t0 = time.perf_counter()
        reset_launches()
        ref = parity.render_config("marcher", key, parity.ORACLE_SKIPMODE,
                                   W, H, 1.0, beetle, device="cuda")
        torch.cuda.synchronize()
        assert ref.renderer == "marcher", ref.renderer
        launches = read_launches()
        check_none(launches, sweeps_and_warps, f"{ph} oracle")
        count("parity", launches)
        images, rows = [], {}
        for sm in (0, 1, 2, 3):
            reset_launches()
            got = parity.render_config("pallas", key, sm, W, H, 1.0, beetle,
                                       device="cuda", frames=0)
            torch.cuda.synchronize()
            launches = read_launches()
            assert got.renderer == "pallas", f"{ph} skipmode {sm}"
            assert launches["K1"] > 0 and launches["K1 walk"] > 0, \
                f"{ph} skipmode {sm}: the sweep never ran ({launches})"
            check_none(launches, [k for k in DISTANCE_KERNELS
                                  if k not in SKIPMODE_KERNELS[sm]],
                       f"{ph} skipmode {sm}")
            assert all(launches[k] > 0 for k in SKIPMODE_KERNELS[sm]), \
                f"{ph} skipmode {sm}: its distance kernels never ran"
            count("parity", launches)
            images.append(got.color)
            rows[sm] = parity.parity_row(got.color, ref.color)
        for sm in (1, 2, 3):
            assert torch.equal(images[sm], images[0]), \
                f"{ph}: the skipmode-{sm} frame differs from skipmode 0's"
        reset_launches()
        rep = parity.render_config("pallas", key, 3, W, H, 1.0, beetle,
                                   edge_repair=True, device="cuda",
                                   frames=0)
        count("parity", read_launches())
        repaired = parity.parity_row(rep.color, ref.color)
        row = rows[3]
        for share in ("pct_pixels_gt_8_of_255", "pct_covered_gt_8_of_255"):
            assert repaired[share] < row[share], \
                f"{ph}: the repair did not lower {share}"
        j_img, j_rep, j_cov = JAX_PARITY_R5[key]
        n_px = W * H
        res[key] = dict(row=row, repaired=repaired, repair_px=rep.repair_px,
                        s=time.perf_counter() - t0)
        log(f"{ph}: default frames of skipmodes 0-3 equal bit for bit; "
            f"launches per skipmode as its TF edit needs; beyond 8/255 of "
            f"the oracle: {row['pct_pixels_gt_8_of_255']:.5f} % of the "
            f"image, {row['pct_covered_gt_8_of_255']:.4f} % of covered "
            f"pixels ({row['px_gt_8_of_255']} of "
            f"{row['covered_either_px']}); with edge repair (suspects, "
            f"budget {rep.repair_px}) {repaired['pct_pixels_gt_8_of_255']:.5f}"
            f" % and {repaired['pct_covered_gt_8_of_255']:.4f} %; JAX r5 "
            f"(a record, not a gate): {j_img} % and "
            f"{j_img * n_px / j_cov:.4f} % of its covered "
            f"pixels, repaired {j_rep} %; "
            f"{res[key]['s']:.1f} s")
        del ref, images, got, rep
        torch.cuda.empty_cache()
    del beetle

    # (b) The session: the slider edits and every extra, each undo giving
    # the frame back bit for bit, and the ESS toggle too (skipping is
    # exact).
    ph = "phase 12b session"
    reset_launches()
    sess = session.run(n_edits=PROTO_EDITS, out=os.path.join(
        tmp_dir, "interactive.json"), device="cuda",
        log=lambda m: log(f"{ph}: {m}"))
    launches = read_launches()
    count("session", launches)
    log(f"{ph}: launches {launches}")
    assert all(launches[k] > 0 for k in ("K1", "K5", "K4 two-sided", "K3",
                                         "K4")), f"{ph}: {launches}"
    for e in sess["extra_edits"]:
        same = e["edit"] in ("sampling=1.0", "translate-back", "spin0",
                             "skipmode=2", "skipmode=3")
        assert e["equals_before"] is same, f"{ph}: {e}"
    res["session"] = sess
    torch.cuda.empty_cache()

    # (c) The orbit: every pose fresh.
    ph = "phase 12c orbit"
    reset_launches()
    line = orbit.run(frames=PROTO_ORBIT_FRAMES,
                     out=os.path.join(tmp_dir, "orbit.json"), device="cuda")
    count("orbit", read_launches())
    log(f"{ph}: launches {counts['orbit']}")
    log(f"{ph}: {json.dumps(line)}")
    log(f"{ph}: renderer_counts {line['renderer_counts']}")
    n = 1 + 2 * 5 * PROTO_ORBIT_FRAMES      # warm, each pose twice
    assert sum(line["renderer_counts"][k] for k in
               ("pallas", "sweep", "marcher")) == n, line["renderer_counts"]
    res["orbit"] = line
    torch.cuda.empty_cache()

    # (d) The ESS ratio: skipmodes 0 and 3 on the beetle.
    ph = "phase 12d ESS ratio"
    reset_launches()
    ess = ess_ratio.run(("beetle",), (0, 3), frames=PROTO_ESS_FRAMES,
                        out=os.path.join(tmp_dir, "ess_ratio.json"),
                        device="cuda", log=lambda m: log(f"{ph}: {m}"))
    count("ess_ratio", read_launches())
    log(f"{ph}: launches {counts['ess_ratio']}")
    for tag in ("beetle:0", "beetle:3"):
        assert set(ess[tag]["stages"]) == {"plan_ms", "sweep_ms", "warp_ms"}
    res["ess"] = ess
    torch.cuda.empty_cache()

    # (e) The per-ray sample counts: the beetle at skipmode 2, each frame
    # (w-grid, then the oracle) with its own launches.
    ph = "phase 12e sample count"
    t0 = time.perf_counter()
    frame_launches = {}
    real_count = sample_count.count_frame

    def counted(renderer, *a, **k):
        reset_launches()
        got = real_count(renderer, *a, **k)
        frame_launches[renderer] = read_launches()
        return got

    sample_count.count_frame = counted
    try:
        sc = sample_count.run(("beetle:2",), width=W, height=H, scale=1.0,
                              out=os.path.join(tmp_dir, "sample_count.json"),
                              device="cuda", log=lambda m: None)["beetle:2"]
    finally:
        sample_count.count_frame = real_count
    for launches in frame_launches.values():
        count("sample_count", launches)
    log(f"{ph}: launches {frame_launches}")
    w_grid = frame_launches["pallas"]
    assert all(w_grid[k] > 0 for k in ("K1", "K1 walk", "K2")), \
        f"{ph}: the w-grid frame ran {w_grid}"
    check_none(frame_launches["marcher"], sweeps_and_warps, f"{ph} oracle")
    assert (sc["pallas"]["renderer_used"], sc["marcher"]["renderer_used"]) \
        == ("pallas", "marcher"), sc
    # Every statistic is finite and > 0 but the w-grid frame's median,
    # which may be 0: the brick sweep takes no sample on a ray that
    # crosses only empty bricks, where the marcher counts its distance
    # reads (docs/h100/sample_count.json: 0 at beetle, snake).
    for block in ("pallas", "marcher", "ratio"):
        for k, v in sc[block].items():
            if k != "renderer_used":
                ok = v >= 0 if (block, k) == ("pallas", "p50") else v > 0
                assert math.isfinite(v) and ok, f"{ph}: {block} {k} = {v}"
    res["sample_count"] = dict(sc, s=time.perf_counter() - t0)
    log(f"{ph}: {json.dumps(sc)}; {res['sample_count']['s']:.1f} s")
    torch.cuda.empty_cache()

    # (f) Warp against quadrature: beetle-grad at skipmode 2, the XLA
    # sweep and the w-grid frame against the oracle; the w-grid column
    # equal to the parity record's row.
    ph = "phase 12f warp vs quadrature"
    t0 = time.perf_counter()
    frame_launches = {}
    real_render = parity.render_config

    def rendered(renderer, *a, **k):
        reset_launches()
        got = real_render(renderer, *a, **k)
        torch.cuda.synchronize()
        frame_launches[renderer] = read_launches()
        return got

    record = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          parity.DEFAULT_OUT)
    parity.render_config = rendered
    try:
        wvq = warp_vs_quadrature.run(
            ("beetle-grad:2",), width=W, height=H, scale=1.0,
            parity_record=record,
            out=os.path.join(tmp_dir, "warp_vs_quadrature.json"),
            device="cuda", log=lambda m: None)["beetle-grad:2"]
    finally:
        parity.render_config = real_render
    for launches in frame_launches.values():
        count("warp_vs_quadrature", launches)
    log(f"{ph}: launches {frame_launches}")
    with open(record) as fh:
        want = json.load(fh)["beetle-grad:2"]["px_gt_8_of_255"]
    got = wvq["pallas"]["parity"]["px_gt_8_of_255"]
    assert wvq["matches_parity_record"] is True and got == want, \
        f"{ph}: the w-grid frame has {got} pixels beyond 8/255, the " \
        f"parity record {want}"
    assert wvq["sweep"]["renderer_used"] == "sweep", wvq["sweep"]
    check_none(frame_launches["sweep"], sweeps_and_warps, f"{ph} XLA sweep")
    check_none(frame_launches["marcher"], sweeps_and_warps, f"{ph} oracle")
    assert frame_launches["pallas"]["K1"] > 0 and \
        frame_launches["pallas"]["K2"] > 0, frame_launches["pallas"]
    res["wvq"] = dict(wvq, s=time.perf_counter() - t0)
    log(f"{ph}: {json.dumps(wvq)}; {res['wvq']['s']:.1f} s")
    torch.cuda.empty_cache()
    log(f"phase 12a: launches {counts['parity']}")
    return res, counts


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
        file_info = phase_file(out_dir)
        torch.cuda.empty_cache()
        orbit_rows, still_launches, orbit_launches, still_ms, tiers = \
            phase_orbit(gpu_timer, out_dir)
        torch.cuda.empty_cache()
        tex_rows, tex_launches, tex_orbit_launches, tex_ms, sweep_ms = \
            phase_texture(gpu_timer, out_dir)
    torch.cuda.empty_cache()
    t8 = time.perf_counter()
    entry, matrix_rows, matrix_launches, matrix_results = phase_matrix(
        gpu_timer)
    log(f"phase 8: {time.perf_counter() - t8:.1f} s")
    t9 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out_dir:
        oracle = phase_oracle(out_dir)
    log(f"phase 9: {time.perf_counter() - t9:.1f} s")
    t10 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out_dir:
        api, api_launches = phase_api(out_dir)
    log(f"phase 10: {time.perf_counter() - t10:.1f} s")
    t11 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp_dir:
        multi, multi_launches = phase_multi(tmp_dir)
    log(f"phase 11: {time.perf_counter() - t11:.1f} s")
    t12 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp_dir:
        proto, proto_launches = phase_protocols(tmp_dir)
    log(f"phase 12: {time.perf_counter() - t12:.1f} s")
    for more in (cli_rows, accel_rows, orbit_rows, tex_rows, matrix_rows):
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
        "occupancy": (
            "occupancy_kernel (intensity TF; bench.py's map, 494x832x832, "
            "b=4)", launches["occupancy"],
            "vkvolume_tpu_torch/csrc/occupancy.cu",
            "none (XLA: vkvolume_tpu/accel/occupancy.py:_occupancy_u8)"),
        "occupancy gradient": (
            "occupancy_kernel (gradient TF; the CLI's map, 494x832x832, b=4)",
            cli_launches["occupancy"], "vkvolume_tpu_torch/csrc/occupancy.cu",
            "none (XLA: vkvolume_tpu/accel/occupancy.py:_occupancy_u8)"),
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
    for k, what in (("frame_grid", "the w-grid fields"),
                    ("frame_positions", "the warp's positions"),
                    ("frame_epilogue", "the channel stack")):
        where[k] = (f"{k}_kernel ({what}; bench.py frame)", launches[k],
                    "vkvolume_tpu_torch/csrc/frame_glue.cu",
                    "none (XLA: vkvolume_tpu/render/sweep_pallas.py:1546 "
                    "_frame_body, :1672 _pixel_stage)")
    for k in matrix_rows:
        if k.endswith("no leap"):
            brick = k.startswith("K1")
            where[k] = (
                f"{'sweep_bricks' if brick else 'sweep_slabs'} (dist_leap "
                f"off: skipmode 1, beetle b=4, {MATRIX_SIZE}x{MATRIX_SIZE} "
                f"benchmark mode)", matrix_launches[k],
                "vkvolume_tpu_torch/csrc/"
                + ("sweep_bricks.cu" if brick else "sweep_slabs.cu"),
                "vkvolume_tpu/render/"
                + ("sweep_bricks.py:56" if brick else "sweep_pallas.py:58"))
    where["K3 b=2"] = ("scan_and_relax_multi (beetle b=2 map; matrix)",
                       matrix_launches["K3 b=2"],
                       "vkvolume_tpu_torch/csrc/distance.cu",
                       "vkvolume_tpu/accel/distance_pallas.py:146")
    where["K4 b=2"] = ("relax_z_direct_multi (beetle b=2 maps; matrix)",
                       matrix_launches["K4 b=2"],
                       "vkvolume_tpu_torch/csrc/distance.cu",
                       "vkvolume_tpu/accel/distance_pallas.py:162")
    kernels = []
    for k, (name, n, source, replaces) in where.items():
        r = rows[k]
        lib = r.get("library_ms")
        log(f"{k} {name}: {r['ms']:.4f} ms vs plain {r['plain_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), library "
            f"{'none' if lib is None else f'{lib:.4f} ms'} (max abs err "
            f"{r['max_abs_err']:.3g}, launches {n})")
        counter = next((c for c in ("K4 two-sided", "K1 texture", "K1 walk",
                                    "K7 walk") if k == c), k.split()[0])
        kernels.append({"name": f"{k.split()[0]} {name}", "route": "cuda",
                        "source": source, "replaces": replaces,
                        "launches": n, "max_abs_err": r["max_abs_err"],
                        "ms": r["ms"], "plain_ms": r["plain_ms"],
                        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                        "library_ms": lib,
                        "launches_phase10": {
                            path: counts[counter]
                            for path, counts in api_launches.items()},
                        "launches_phase11": {
                            path: counts[counter]
                            for path, counts in multi_launches.items()},
                        "launches_phase12": {
                            path: counts[counter]
                            for path, counts in proto_launches.items()}})
    log(f"frame_ms_median {frame_ms:.4f} map_update_ms {map_ms:.4f} "
        f"({WIDTH}x{HEIGHT}, skipmode 3)")
    log(f"cli_frame_ms_median {cli_ms:.4f} cli_map_update_ms {cli_map_ms:.4f} "
        f"({CLI_WIDTH}x{CLI_HEIGHT}, skipmode 2, gradient TF)")
    log(f"still_k7_k8_frame_ms_median {still_ms:.4f} (azimuth "
        f"{STILL_AZIMUTH:.0f}, sampling {STILL_SAMPLING}, {CLI_WIDTH}x"
        f"{CLI_HEIGHT}); orbit ms/frame by azimuth "
        + ", ".join(f"{az:.0f}: {ms:.4f}" for az, ms in tiers.items()))
    log(f"orbit launches {orbit_launches}")
    log(f"reference format (beetle x{FILE_SCALE}): written in "
        f"{file_info['write_s']:.2f} s, read onto the card in "
        f"{file_info['load_s']:.2f} s; default Engine marcher frame "
        f"{file_info['default_ms']:.1f} ms ({DEFAULT_SIZE}x{DEFAULT_SIZE})")
    log(f"texture_cli_frame_ms_median {tex_ms:.4f} (K1 texture + K2, "
        f"{CLI_WIDTH}x{CLI_HEIGHT}); xla_sweep_ms_median CLI pose "
        f"{sweep_ms['cli']:.4f}, side view {sweep_ms['side']:.4f} "
        f"({XLA_SWEEP_REPS} synced reps each)")
    log(f"texture orbit launches {tex_orbit_launches}")
    log(f"bench entry: value {entry['value']:.4f} ms/frame, vs_baseline "
        f"{entry['vs_baseline']:.4f}, stages {entry['stages']} "
        f"({entry['metric']})")
    for r in matrix_results:
        log(f"matrix {r.image} skipmode {r.skipmode} b={r.blocksize}: "
            f"{r.framerate:.2f} fps ({r.frame_ms:.4f} ms), update "
            f"{r.update:.4f} ms, occupancy {r.occupancy:.4f} % "
            f"({MATRIX_SIZE}x{MATRIX_SIZE}, {MATRIX_REPS}x{MATRIX_FRAMES})")
    for k in ("marcher_sm2", "marcher_sm3", "marcher_cli"):
        log(f"{k}_ms_median {oracle[k][0]:.4f} iterations {oracle[k][1]} "
            f"({CLI_WIDTH}x{CLI_HEIGHT})")
    r = oracle["repair"]
    log(f"edge repair: n_found {r['n_found']} K {r['K']}, gap beyond 8/255 "
        f"{r['gap_plain']:.4f} % -> {r['gap_repaired']:.4f} %, ms sweep "
        f"frame {r['sweep_ms']:.4f}, repair {r['repair_ms']:.4f}, frame with "
        f"repair {r['frame_ms']:.4f}")
    log(f"scene: rasteriser {oracle['scene']['raster_ms']:.4f} ms, frame "
        f"{oracle['scene']['frame_ms']:.4f} ms")
    log(f"inverted TF (float path): map_update_ms "
        f"{api['inverted_map_update_ms']:.4f}, float-path occupancy "
        f"{api['general_occ_ms']:.4f} ms vs integer "
        f"{api['integer_occ_ms']:.4f}, frame {api['inverted_frame_ms']:.4f} "
        f"ms ({WIDTH}x{HEIGHT})")
    log(f"--gradient_test: TF edit {api['on_the_fly_update_ms']:.4f} ms, "
        f"XLA-sweep frame {api['gradient_test_frame_ms']:.4f} ms "
        f"({CLI_WIDTH}x{CLI_HEIGHT})")
    for az, r in api["render_frame"].items():
        log(f"render_frame azimuth {az:.0f} "
            f"({'device-stats' if r['device_stats'] else 'host'} plan, "
            f"{r['sweep']}): {r['ms']:.4f} ms, engine frame "
            f"{r['engine_ms']:.4f} ms, plan {r['plan_ms']:.2f} ms, "
            f"plan_stats {r['stats_ms']:.4f} ms")
    log(f"accel cache: build + save {api['cache_build_save_s']:.2f} s, "
        f"restore {api['cache_restore_s']:.2f} s")
    for name, upd, ren, route in api["viewer"]:
        log(f"viewer {name}: update {upd} ms, render {ren} ms ({route}, "
            f"{VIEWER_WIDTH}x{VIEWER_HEIGHT})")
    for name, r in multi["frames"].items():
        nbytes, cms = r["collective"]
        log(f"render_frame_sharded {name}: {r['ms']:.4f} ms ({r['n']} "
            f"{r['backend']} ranks on one card, {r['sweep']} + K2 variant "
            f"{r['variant']}), single-device {r['single_ms']:.4f} ms; "
            f"all_gather {nbytes} bytes {cms:.4f} ms")
    for k in ("march_sharded", "march_volume_sharded",
              "sweep_volume_sharded ert=False",
              "sweep_volume_sharded ert=True"):
        r = multi[k]
        nbytes, cms = r["collective"]
        log(f"{k}: {r['ms']:.4f} ms ({MULTI_RANKS} gloo ranks on one card)"
            + (f", single-device {r['single_ms']:.4f} ms"
               if "single_ms" in r else "")
            + f"; collective {nbytes} bytes {cms:.4f} ms")
    for key in PROTO_PARITY_KEYS:
        r = proto[key]
        log(f"parity {key} (1920x1080, skipmodes 0-3 equal): beyond 8/255 "
            f"{r['row']['pct_pixels_gt_8_of_255']:.5f} % of the image, "
            f"{r['row']['pct_covered_gt_8_of_255']:.4f} % of covered pixels;"
            f" with edge repair {r['repaired']['pct_pixels_gt_8_of_255']:.5f}"
            f" % and {r['repaired']['pct_covered_gt_8_of_255']:.4f} %")
    sess = proto["session"]
    log(f"session ({PROTO_EDITS} edits): total_ms median "
        f"{sess['total_ms_median']:.2f} max {sess['total_ms_max']:.2f}, "
        f"pipelined {sess['pipelined_ms_per_edit']:.2f} ms/edit; extras "
        + ", ".join(f"{e['edit']} {e['total_ms']:.2f} ms"
                    for e in sess["extra_edits"]))
    line = proto["orbit"]
    log(f"orbit ({PROTO_ORBIT_FRAMES} frames a rep): {line['value']:.4f} "
        f"ms/frame, renderer_counts {line['renderer_counts']}")
    for tag in ("beetle:0", "beetle:3"):
        r = proto["ess"][tag]
        log(f"ess {tag}: {r['frame_ms']:.4f} ms/frame, stages {r['stages']}")
    sc = proto["sample_count"]
    log(f"sample count beetle:2 (1920x1080, ERT off): per covered pixel "
        f"w-grid {sc['pallas']['mean_per_covered']:.3f}, marcher "
        f"{sc['marcher']['mean_per_covered']:.3f}; ratio total "
        f"{sc['ratio']['total']:.4f}, p50 {sc['ratio']['p50']:.4f}")
    wvq = proto["wvq"]
    log(f"warp vs quadrature beetle-grad:2 (1920x1080): beyond 8/255 of the "
        f"oracle's covered pixels, XLA sweep "
        f"{wvq['sweep']['pct_covered']:.4f} %, w-grid frame "
        f"{wvq['pallas']['pct_covered']:.4f} % (parity record matched)")
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
