"""What the two sweep kernels (K1, K7) spend their time on, at the shapes
the frame paths give them.

    python -m vkvolume_tpu_torch.bench.sweep_probe [--reps N]

Renders one frame of each path on the full-scale synthetic beetle and
captures the inputs the frame hands to K1 or K7 (``harness.capture``):
bench.py's frame (K1 aligned, intensity TF), the CLI's default frame (K1
gradient + plane-pair lerp), the CLI's benchmark orbit at azimuth 90 (K1
gradient + lerp, tile_h 32, ERT off, sample counts) and 40 (K7), and the
CLI's side view at low sampling (K7). For each it prints one JSON line:
the grid, tiles and tile height, the samples the run takes, the sweep's
time (CUDA events), its walk kernel's alone, and the time of a copy of
the kernels built with the sampling body emptied (each in-range sample is
counted, nothing is read or composited: what is left is the walk, the
votes and the loop), so that the walk's share is measured, not guessed. At azimuth 90 it also times
the same inputs at tile heights 8 and 16. Then the ptxas lines of both
builds. Needs a CUDA device; the emptied copy is built under ``build/``.
``chip_smoke.py`` times the sweeps and their walks at the same shapes;
this is the diagnosis behind them.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import sys

import torch

WIDTH, HEIGHT = 1920, 1080
CLI_WIDTH, CLI_HEIGHT = 1280, 720
# The sampling body starts at this line in both sweep sources; the emptied
# copy skips every sample right there.
_SAMPLE_GUARD = "if (!in_rng) continue;"


def gpu_ms(fn, n: int) -> float:
    """Mean ms per call over ``n`` calls after one warm call (CUDA events)."""
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


def shapes():
    """(label, sweep, inputs) of the five probed frames."""
    from .. import cli
    from ..bench.datasets import DATASETS, synthesize
    from ..bench.harness import benchmark_camera, capture, make_engine
    from ..options import Test

    vol = synthesize(DATASETS["beetle"], seed=0, scale=1.0)
    eng, _, _, _ = make_engine("beetle", 3, 4, volume_u8=vol,
                               renderer="pallas", test=Test.NONE, ert=True,
                               device="cuda")
    yield ("K1 aligned, bench.py frame",
           *capture(eng, benchmark_camera(aspect=WIDTH / HEIGHT), WIDTH,
                    HEIGHT))
    del eng

    def cli_engine(*flags):
        engine, volumes = cli.setup_engine(cli.build_parser().parse_args(
            ["--synth", "beetle", *flags]))
        engine.add_volume(volumes[0])
        return engine

    eng = cli_engine()
    yield ("K1 gradient + lerp, CLI frame",
           *capture(eng, cli.cli_camera(CLI_WIDTH, CLI_HEIGHT), CLI_WIDTH,
                    CLI_HEIGHT))
    del eng
    eng = cli_engine("--azimuth", "80", "--sampling", "0.25")
    yield ("K7 gradient, side view",
           *capture(eng, cli.cli_camera(CLI_WIDTH, CLI_HEIGHT, 80.0),
                    CLI_WIDTH, CLI_HEIGHT))
    del eng
    eng = cli_engine("--benchmark", "20")
    for az, label in ((90.0, "K1 gradient + lerp, orbit azimuth 90"),
                      (40.0, "K7 gradient, orbit azimuth 40")):
        yield (label, *capture(eng, benchmark_camera(CLI_WIDTH / CLI_HEIGHT,
                                                     az, 20.0),
                               CLI_WIDTH, CLI_HEIGHT))


def with_params(inp, **kw):
    return dataclasses.replace(inp, params={**inp.params, **kw})


def emptied_kernels():
    """The kernel library built from a copy of csrc/ whose sweeps skip every
    sample's body (under build/)."""
    from ..utils import cuda_build

    src = cuda_build.CSRC
    dst = os.path.join(cuda_build.BUILD_DIR, "probe_emptied")
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, os.path.join(dst, "csrc"))
    for name in ("sweep_bricks.cu", "sweep_slabs.cu"):
        path = os.path.join(dst, "csrc", name)
        with open(path) as fh:
            text = fh.read()
        assert _SAMPLE_GUARD in text, name
        with open(path, "w") as fh:
            fh.write(text.replace(_SAMPLE_GUARD, "continue;"))
    saved = (cuda_build.CSRC, cuda_build.BUILD_DIR, cuda_build._lib,
             cuda_build.build_log)
    cuda_build.CSRC = os.path.join(dst, "csrc")
    cuda_build.BUILD_DIR = os.path.join(dst, "build")
    cuda_build._lib = None
    try:
        lib = cuda_build.load_kernels()
        log = cuda_build.build_log
    finally:
        (cuda_build.CSRC, cuda_build.BUILD_DIR, cuda_build._lib,
         cuda_build.build_log) = saved
    return lib, log


def ptxas_lines(log: str):
    return [ln.strip() for ln in log.splitlines()
            if "sweep" in ln or "registers" in ln or "spill" in ln]


def main(argv=None) -> int:
    from ..render import sweep_bricks, sweep_slabs
    from ..utils import cuda_build

    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("sweep_probe needs a CUDA device")
    lib = cuda_build.load_kernels()
    build_log = cuda_build.build_log
    empty_lib, empty_log = emptied_kernels()
    kernel = {"K1": sweep_bricks.sweep_bricks_kernel,
              "K7": sweep_slabs.sweep_slabs_kernel}
    walk = {"K1": sweep_bricks.brick_walk, "K7": sweep_slabs.slab_walk}
    for label, name, inp in shapes():
        p = inp.params
        tile_h = p.get("tile_h", 8)
        run = kernel[name]
        counted = run(with_params(inp, count_samples=1))[3]
        row = {"shape": label, "grid": [p["H"], p["W"]], "tile_h": tile_h,
               "tiles": (p["H"] // tile_h) * (p["W"] // 128),
               "n_slabs": p["n_slabs"], "ert": p["ert"],
               "count_samples": p["count_samples"],
               "samples": int(counted.to(torch.int64).sum()),
               "ms": gpu_ms(lambda: run(inp), args.reps),
               "walk_ms": gpu_ms(lambda: walk[name](inp), args.reps)}
        if name == "K1" and tile_h == 32:
            for th in (8, 16):
                other = with_params(inp, tile_h=th)
                n = run(with_params(other, count_samples=1))[3]
                row[f"tile_h_{th}"] = {
                    "samples": int(n.to(torch.int64).sum()),
                    "ms": gpu_ms(lambda: run(other), args.reps)}
        cuda_build._lib = empty_lib
        try:
            row["emptied_ms"] = gpu_ms(lambda: run(inp), args.reps)
        finally:
            cuda_build._lib = lib
        row["device"] = torch.cuda.get_device_name(0)
        print(json.dumps(row), flush=True)
    for what, log in (("build", build_log), ("emptied build", empty_log)):
        for ln in ptxas_lines(log):
            print(f"{what}: {ln}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
