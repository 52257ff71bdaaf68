"""Headline benchmark of the port: ms/frame at 1920×1080, the beetle-class
volume, anisotropic-distance ESS (bench.py's frame and protocol).

    python -m vkvolume_tpu_torch.bench [--device cuda|cpu]

Prints ONE JSON line with bench.py's keys:

    {"metric": ..., "value": N, "unit": "ms/frame", "vs_baseline": N, ...}

The frame: the synthetic stag beetle at full scale, skipmode 3, block size
4, renderer "pallas", ``Test.NONE``, ERT on, the aspect-preserving fit.
The protocol: one warm frame, then ``BENCH_REPS`` repetitions of
``BENCH_FRAMES`` queued frames, each ended by one synchronise; ``value``
is the median repetition on the card's clock (CUDA events), ``rep_ms``
the repetitions, ``rep_host_ms`` the same repetitions on the host clock.
``stages`` is ``stage_breakdown``'s plan / sweep / warp split of the same
pose, and ``launches`` counts each kernel wrapper's launches over the
warm frame and the timed repetitions.

``vs_baseline``: the reference's mode-matched stag-beetle fps at 1200×1200
(``BASELINE.md``, scripts/benchmark_results_{0..3}.csv:14; VkVolume on its
own, unrecorded GPU), pixel-scaled to this frame size, as a frame time,
over ``frame_ms_stretch_equiv`` (> 1 = faster than the reference). The
reference fits its volume by stretching every axis to its 100-unit cube
(src/volume_render.cpp:224-233), so the entry times that fit too, in the
same run: the same dataset, skipmode, block size, size, protocol and
renderer with ``fit="stretch"``; ``frame_ms_stretch_equiv`` is its
median and ``stretch_renderer_counts`` its frames per renderer. Every
stretch frame must take the renderer asked for; the entry raises if one
does not. ``value`` stays the aspect-fit median.

Environment overrides: BENCH_FRAMES (20), BENCH_REPS (5), BENCH_SCALE
(1.0, the volume's scale), BENCH_WIDTH (1920), BENCH_HEIGHT (1080),
BENCH_DATASET (beetle), BENCH_SKIPMODE (3), BENCH_RENDERER (pallas),
BENCH_BREAKDOWN (1; 0 leaves ``stages`` out).

``--device cuda`` (the default) needs a CUDA device and raises without
one; ``--device cpu`` runs the kernels' plain PyTorch versions and reports
host-clock times under ``value`` (for the tests; no card metric).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

# The reference's stag-beetle TF-a fps at 1200×1200 by skipmode
# (scripts/benchmark_results_{0..3}.csv:14, BASELINE.md).
REFERENCE_FPS_1200 = {0: 75.3, 1: 340.3, 2: 623.8, 3: 672.3}


def kernel_launches() -> dict:
    """Each kernel wrapper's launch count so far."""
    from ..accel import distance_cuda, occupancy_cuda
    from ..render import frame_cuda, sweep_bricks, sweep_slabs, warp_cuda

    return {k: n for t in (occupancy_cuda.LAUNCHES, distance_cuda.LAUNCHES,
                           sweep_bricks.LAUNCHES, sweep_slabs.LAUNCHES,
                           warp_cuda.LAUNCHES, frame_cuda.LAUNCHES)
            for k, n in t.items()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m vkvolume_tpu_torch.bench",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (the kernels; the default) or cpu (their "
                        "plain versions, host-clock times)")
    args = p.parse_args(argv)

    env = os.environ
    frames = int(env.get("BENCH_FRAMES", "20"))
    reps = int(env.get("BENCH_REPS", "5"))
    scale = float(env.get("BENCH_SCALE", "1.0"))
    width = int(env.get("BENCH_WIDTH", "1920"))
    height = int(env.get("BENCH_HEIGHT", "1080"))
    dataset = env.get("BENCH_DATASET", "beetle")
    skipmode = int(env.get("BENCH_SKIPMODE", "3"))
    renderer = env.get("BENCH_RENDERER", "pallas")
    breakdown = env.get("BENCH_BREAKDOWN", "1") != "0"

    from ..engine.volume import resolve_device
    from ..options import Test
    from .datasets import DATASETS, synthesize
    from .harness import benchmark_camera, card, run_config, stage_breakdown

    t_start = time.time()
    device = resolve_device(args.device)
    vol = synthesize(DATASETS[dataset], seed=0, scale=scale)

    def fit_run(fit):
        return run_config(dataset, skipmode, 4, width=width, height=height,
                          frames=frames, reps=reps, scale=scale,
                          volume_u8=vol, test=Test.NONE, ert=True,
                          renderer=renderer, fit=fit,
                          keep_engine=fit == "aspect", device=device)

    fit = "aspect"
    r = fit_run(fit)
    launches = kernel_launches()
    stages = (stage_breakdown(r.engine, benchmark_camera(width / height),
                              width, height) if breakdown else None)
    r.engine = None
    stretch = fit_run("stretch")
    mixed = {k: n for k, n in stretch.renderer_counts.items()
             if n and k != renderer}
    if mixed:
        raise RuntimeError(f"stretch-fit frames took {mixed}, not only "
                           f"{renderer!r}")
    name, power_limit = card(device)
    ref_fps = REFERENCE_FPS_1200[skipmode] / ((width * height) / 1200.0 ** 2)
    print(json.dumps({
        "metric": (f"ms/frame {width}x{height} {dataset} skipmode={skipmode}"
                   f" renderer={renderer} fit={fit} (synthetic, "
                   f"occupancy+structure-matched)"),
        "value": r.frame_ms,
        "unit": "ms/frame",
        "vs_baseline": (1000.0 / ref_fps) / stretch.frame_ms,
        "frame_ms_stretch_equiv": stretch.frame_ms,
        "stretch_renderer_counts": stretch.renderer_counts,
        "fit": fit,
        "fps": r.framerate,
        "map_update_ms": r.update,
        "occupancy_pct": r.occupancy,
        "frames": frames,
        "scale": scale,
        "wall_s": time.time() - t_start,
        "rep_ms": list(r.rep_ms),
        "rep_host_ms": list(r.rep_host_ms),
        "rep_spread": (max(r.rep_ms) - min(r.rep_ms)) / r.frame_ms,
        "renderer_used": r.renderer_used,
        "renderer_counts": r.renderer_counts,
        "protocol": f"{reps}x{frames}",
        "stages": stages,
        "launches": launches,
        "device": name,
        "power_limit": power_limit,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
