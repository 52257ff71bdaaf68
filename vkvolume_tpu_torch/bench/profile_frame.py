"""Where one frame's time goes on the card: ``torch.profiler`` over a few
frames of one pose of the CLI's set-up.

    python -m vkvolume_tpu_torch.bench.profile_frame [CLI flags]
        [--frames N] [--azimuths A,B,...]

Takes the CLI's flags (``--synth beetle``, ``--width``, ``--azimuth``,
``--sampling``, ``--benchmark N`` for the benchmark mode and its camera,
...), renders the pose once to fill its caches, times ``--frames`` frames
unprofiled (host clock, one sync), then profiles as many, and prints one
JSON line per pose: host ms per frame, device ms per frame (the sum of the
trace's kernel events), the device's busy share of the frame, kernel
launches and synchronisations per frame, the route (which kernels ran) and
the kernels by device time. ``--azimuths`` profiles several poses of the
one set-up in turn. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
import time

import torch


def profile_pose(engine, camera, width: int, height: int, frames: int):
    """The pose's breakdown (a dict; see the module docstring)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    engine.render(camera, width, height)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(frames):
        engine.render(camera, width, height)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / frames
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(frames):
            engine.render(camera, width, height)
        torch.cuda.synchronize()
    kernels = collections.Counter()
    calls = collections.Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            kernels[e.name] += e.time_range.elapsed_us()
        elif e.name.startswith(("cudaLaunchKernel", "cudaStreamSynchronize",
                                "cudaDeviceSynchronize", "cudaMemcpy")):
            calls[e.name.split("_")[0]] += 1
    device_ms = sum(kernels.values()) / 1e3 / frames
    top = [{"kernel": name[:90], "ms": us / 1e3 / frames}
           for name, us in kernels.most_common(8)]
    return {"host_ms": host_ms, "device_ms": device_ms,
            "busy_share": device_ms / host_ms,
            "per_frame": {k: v / frames for k, v in sorted(calls.items())},
            "top_kernels": top}


def main(argv=None) -> int:
    from .. import cli
    from ..accel import distance_cuda
    from ..bench.harness import benchmark_camera
    from ..render import frame_cuda, sweep_bricks, sweep_slabs, warp_cuda

    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--frames", type=int, default=10)
    p.add_argument("--azimuths", default=None,
                   help="comma-separated azimuths (default: --azimuth)")
    own, rest = p.parse_known_args(argv)
    args = cli.build_parser().parse_args(rest)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_frame needs a CUDA device")
    engine, volumes = cli.setup_engine(args)
    for volume in volumes:
        engine.add_volume(volume)
    azimuths = ([float(a) for a in own.azimuths.split(",")]
                if own.azimuths else [args.azimuth])
    tables = (sweep_bricks.LAUNCHES, sweep_slabs.LAUNCHES,
              warp_cuda.LAUNCHES, distance_cuda.LAUNCHES,
              frame_cuda.LAUNCHES)
    for az in azimuths:
        if args.benchmark:
            camera = benchmark_camera(args.width / args.height, az,
                                      args.elevation)
        else:
            camera = cli.cli_camera(args.width, args.height, az,
                                    args.elevation)
        before = [dict(t) for t in tables]
        engine.render(camera, args.width, args.height)
        route = sorted(k for t, b in zip(tables, before) for k in t
                       if t[k] > b[k])
        out = profile_pose(engine, camera, args.width, args.height,
                           own.frames)
        print(json.dumps({"pose": " ".join(rest), "azimuth": az,
                          "route": route,
                          "device": torch.cuda.get_device_name(0), **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
