"""Command-line interface — port of ``vkvolume_tpu/cli.py``.

Same flags, same defaults and the same machine-readable log lines as the
JAX package's CLI (the reference's plugin flags and benchmark mode,
src/volume_render.h:35-63, src/volume_render.cpp:65-84)::

    ran <N> frames, averaged <X> fps
    Updated occupancy/distance map in <X>ms
    Occupied voxels: <X>% in <X>ms

plus ``--device`` (default ``cuda``). With ``--device cuda`` and no CUDA
device it fails; nothing falls back to the CPU. ``--device cpu`` runs the
kernels' plain PyTorch versions.

Usage:
    python -m vkvolume_tpu_torch.cli [options] [<dataset>]
    python -m vkvolume_tpu_torch.cli --synth beetle [options]

``--sweep`` runs the reference's benchmark matrix (``bench.harness.
run_sweep``: six dataset/TF configurations, skipmodes 0-3, block sizes
2-6, ``--frames`` frames at ``--width`` x ``--height``, synthetic volumes
at ``--synth-scale``) on ``--device`` and writes
``benchmark_results_<skipmode>.csv`` in the working directory.

``--renderer marcher`` renders every frame through the per-ray marcher,
``--edge-repair`` re-marches the frame's resampling-suspect pixels with
it, and ``--scene`` renders the demo hall mesh (``render/forward.py``),
clips the volume's rays at its depth and composites the volume over it.
``--gradient_test`` computes the gradients inside every map build and in
the marcher instead of reading a precomputed map; without the map, the
gradient-TF frames of ``--renderer pallas`` take the XLA sweep (gradient
1.0), as in the JAX package.
``--debug-nans`` is accepted and does nothing: it switches on a JAX NaN
trap that PyTorch's eager execution has no counterpart for.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="vkvolume-torch",
        description="Accelerated volume renderer on PyTorch and CUDA "
                    "(Chebyshev distance-map empty-space skipping)",
    )
    # Reference flags and defaults (src/volume_render.cpp:67-82).
    p.add_argument("dataset", nargs="*", default=None,
                   help="raw volume path(s) (each with a <path>.header "
                        "sidecar); multiple volumes composite in draw "
                        "order like the reference's "
                        "<binary_volume_image>... argument "
                        "(src/volume_render.cpp:95,186)")
    p.add_argument("--imin", type=float, default=0.1)
    p.add_argument("--imax", type=float, default=1.0)
    p.add_argument("--gmin", type=float, default=0.0)
    p.add_argument("--gmax", type=float, default=0.2)
    p.add_argument("--skipmode", type=int, default=2, choices=[0, 1, 2, 3],
                   help="0=None 1=Block 2=Distance 3=AnisotropicDistance")
    p.add_argument("--blocksize", type=int, default=4)
    p.add_argument("--gradient_test", action="store_true",
                   help="on-the-fly gradients instead of the precomputed map")
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--benchmark", type=int, default=0, metavar="FRAMES",
                   help="benchmark mode: time FRAMES frames and report fps")
    # Extensions beyond the reference CLI.
    p.add_argument("--synth", choices=["present", "beetle", "snake"],
                   help="use a synthetic stand-in dataset")
    p.add_argument("--synth-scale", type=float, default=1.0)
    p.add_argument("--sampling", type=float, default=1.0,
                   help="sampling factor (GUI slider equivalent)")
    p.add_argument("--alpha", type=float, default=1.0,
                   help="voxel alpha factor")
    p.add_argument("--clip-distance", type=float, default=50.0)
    p.add_argument("--no-ert", action="store_true",
                   help="disable early ray termination")
    p.add_argument("--test", type=int, default=0, choices=[0, 1, 2, 3],
                   help="0=None 1=RayEntry 2=RayExit 3=NumTextureSamples")
    p.add_argument("--texture-tf", action="store_true",
                   help="sample the baked 256x256 TF texture instead of the "
                        "closed form (the TRANSFER_FUNCTION_TEXTURE build "
                        "variant, transfer_function.glsl:36-38)")
    p.add_argument("--edge-repair", action="store_true",
                   help="re-march resampling-suspect pixels with the "
                        "per-ray marcher")
    p.add_argument("--scene", action="store_true",
                   help="render the demo hall mesh around the volume")
    p.add_argument("--azimuth", type=float, default=30.0)
    p.add_argument("--elevation", type=float, default=20.0)
    p.add_argument("--spin", type=float, default=0.0, metavar="DEG",
                   help="rotate the volume DEG degrees per benchmark frame "
                        "(the reference's spin_volumes animation, "
                        "src/volume_render.cpp:89)")
    p.add_argument("--orbit", type=float, default=0.0,
                   help="degrees of azimuth per frame (spin equivalent)")
    p.add_argument("--output", default=None, help="write a PNG snapshot")
    p.add_argument("--renderer", default="pallas",
                   choices=["marcher", "sweep", "pallas"],
                   help="pallas = the w-grid frame through the CUDA kernels "
                        "(brick or per-slab sweep; two-pass, single-pass "
                        "or gather warp, as the view's plan says; the XLA "
                        "sweep for the views it cannot take); sweep = the "
                        "XLA plane sweep; marcher = the per-ray marcher")
    p.add_argument("--debug-nans", action="store_true",
                   help="accepted and ignored: a JAX NaN trap with no "
                        "counterpart in PyTorch's eager execution")
    p.add_argument("--sweep", action="store_true",
                   help="run the full benchmark sweep")
    p.add_argument("--frames", type=int, default=20,
                   help="timed frames per sweep config")
    p.add_argument("--device", default="cuda",
                   help="torch device of volumes, maps and frames: cuda "
                        "(the kernels) or cpu (their plain versions)")
    return p


def setup_engine(args):
    """Engine + volume list from parsed CLI args.

    Does NOT add the volumes to the engine (callers time that step — it is
    the reference's load → gradient → map-update pipeline). Each volume
    gets its own options instance (the reference's per-volume options,
    src/volume_render.cpp:190-195)."""
    from .engine import Engine, RenderOptions, from_array, from_file
    from .engine.volume import resolve_device
    from .options import SkippingType, Test, VolumeOptions

    device = resolve_device(args.device)
    opts = VolumeOptions(
        sampling_factor=args.sampling,
        voxel_alpha_factor=args.alpha,
        use_precomputed_gradient=not args.gradient_test,
        intensity_min=args.imin, intensity_max=args.imax,
        gradient_min=args.gmin, gradient_max=args.gmax,
    )
    render_opts = RenderOptions(
        skipping_type=SkippingType(args.skipmode),
        clip_distance=args.clip_distance,
        early_ray_termination=not args.no_ert,
        test=Test(args.test),
        texture_tf=args.texture_tf,
        edge_repair=args.edge_repair,
    )
    engine = Engine(render_opts, benchmark_mode=args.benchmark > 0,
                    renderer=args.renderer, device=device)

    if args.synth:
        from .bench.datasets import DATASETS, synthesize

        ds = DATASETS[args.synth]
        data = synthesize(ds, scale=args.synth_scale)
        volumes = [from_array(data, opts, block_size=args.blocksize,
                              name=ds.filename, device=device)]
    else:
        paths = args.dataset or ["stag_beetle_832x832x494.uint16"]
        volumes = [from_file(ds, dataclasses.replace(opts),
                             block_size=args.blocksize, device=device)
                   for ds in paths]
    for volume in volumes:
        fit_to_viewport(volume)
    return engine, volumes


def fit_to_viewport(volume) -> None:
    """Fit ``volume`` to the viewport: node scale = 100 / (per-world-axis
    image scale), the reference's benchmark-mode decompose
    (src/volume_render.cpp:224-233: |rotation · scale| of the image
    transform), as the JAX CLI applies it for its fixed fit-orbit camera."""
    lin = np.asarray(volume.image_transform, np.float64)[:3, :3]
    s = np.linalg.norm(lin, axis=0)               # image scale (glm)
    rot = lin / np.where(s == 0.0, 1.0, s)[None, :]
    world = np.abs(rot @ s)                       # abs(rotation*scale)
    volume.set_scale(tuple(100.0 / np.where(world == 0.0, 1.0, world)))


def cli_camera(width: int, height: int, azimuth: float = 30.0,
               elevation: float = 20.0):
    """The CLI's still-frame camera: an orbit at 1.3× the distance at which
    the 100-unit volume fills the viewport height."""
    from .camera import fit_distance, orbit_camera

    aspect = width / height
    radius = fit_distance(50.0, np.deg2rad(60.0), aspect) * 1.3
    return orbit_camera(radius=radius, azimuth_deg=azimuth,
                        elevation_deg=elevation, aspect=aspect)


def run(argv=None):
    """The CLI's work: (engine, volumes, last frame's RenderOutput)."""
    args = build_parser().parse_args(argv)

    from .bench.harness import benchmark_camera

    engine, volumes = setup_engine(args)

    t0 = time.perf_counter()
    for volume in volumes:
        # Per-volume load pipeline + log lines (the reference logs each
        # volume as it loads, src/volume_render.cpp:186-242).
        stats = engine.add_volume(volume)
        if stats.gradient_ms is not None:
            print(f"Updated gradient map in {stats.gradient_ms}ms")
        if stats.occupied_voxel_percent is not None:
            print(f"Occupied voxels: {stats.occupied_voxel_percent}% "
                  f"in {stats.count_ms}ms")
        print(f"Updated occupancy/distance map in {stats.map_update_ms}ms")
    print(f"Prepared in {time.perf_counter() - t0:.2f}s")

    aspect = args.width / args.height
    if args.benchmark:
        cam = benchmark_camera(aspect, args.azimuth, args.elevation)
        out = engine.render(cam, args.width, args.height)
        engine._sync()
        n = args.benchmark
        t0 = time.perf_counter()
        for i in range(n):
            az = args.azimuth + args.orbit * i
            cam = benchmark_camera(aspect, az, args.elevation)
            if args.spin:
                for volume in volumes:
                    volume.set_spin(np.deg2rad(args.spin * i))
            out = engine.render(cam, args.width, args.height)
        engine._sync()
        dt = time.perf_counter() - t0
        print(f"ran {n} frames, averaged {n / dt} fps")
    else:
        cam = cli_camera(args.width, args.height, args.azimuth,
                         args.elevation)
        if args.scene:
            from .render.forward import sponza_lite

            out = engine.render_with_scene(cam, args.width, args.height,
                                           sponza_lite())
        else:
            out = engine.render(cam, args.width, args.height)
        engine._sync()

    if args.output:
        from .utils.image import write_png

        write_png(args.output, out.color.cpu().numpy())
        print(f"wrote {args.output}")
    return engine, volumes, out


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.sweep:
        from .bench.harness import run_sweep

        run_sweep(width=args.width, height=args.height, frames=args.frames,
                  scale=args.synth_scale, device=args.device)
        return 0
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
