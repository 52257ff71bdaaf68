"""Per-stage frame times by skipmode on the CSV protocol — port of
``scripts/ess_ratio.py``.

    python -m vkvolume_tpu_torch.bench.ess_ratio [--datasets beetle,present,snake]
        [--skipmodes 0,2,3] [--frames 10] [--scale 1.0] [--width 1200]
        [--height 1200] [--out docs/h100/ess_ratio.json] [--device cuda|cpu]

Per dataset and skipmode: ``run_config`` at block size 4 in benchmark
mode (NumTextureSamples output, ERT off; 5 repetitions of ``frames``
queued frames) and ``stage_breakdown`` of the same pose (the host plan,
the sweep, the warp). Skipmode 0 samples every brick in range, 2 and 3
leap by the distance maps: the ratio of their times and stages says where
empty-space skipping pays. The output JSON maps ``dataset:skipmode`` to
the script's row (``frame_ms``, ``fps``, ``update_ms``,
``occupancy_pct``, ``rep_ms``, ``renderer_counts``, ``stages``,
``wall_s``), beside ``device`` and ``power_limit``, rewritten after every
row. ``--device cuda`` (the default) raises without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from ..engine.volume import resolve_device
from .datasets import DATASETS, synthesize
from .harness import (benchmark_camera, card, run_config, save_json,
                      stage_breakdown)

DEFAULT_OUT = "docs/h100/ess_ratio.json"


def run(datasets=("beetle", "present", "snake"), skipmodes=(0, 2, 3), *,
        frames: int = 10, scale: float = 1.0, width: int = 1200,
        height: int = 1200, out: str = DEFAULT_OUT, device="cuda",
        log=print) -> dict:
    device = resolve_device(device)
    name, power_limit = card(device)
    results = {"device": name, "power_limit": power_limit}
    cam = benchmark_camera(aspect=width / height)
    for key in datasets:
        vol = synthesize(DATASETS[key], scale=scale)
        for sm in skipmodes:
            t0 = time.perf_counter()
            r = run_config(key, sm, 4, width=width, height=height,
                           frames=frames, scale=scale, volume_u8=vol,
                           keep_engine=True, device=device)
            stages = stage_breakdown(r.engine, cam, width, height)
            results[f"{key}:{sm}"] = {
                "frame_ms": r.frame_ms,
                "fps": r.framerate,
                "update_ms": r.update,
                "occupancy_pct": r.occupancy,
                "rep_ms": list(r.rep_ms),
                "renderer_counts": r.renderer_counts,
                "stages": stages,
                "wall_s": time.perf_counter() - t0,
            }
            del r
            save_json(out, results)
            log(f"{key}:{sm}: {results[f'{key}:{sm}']['frame_ms']:.3f} "
                f"ms/frame stages={stages}")
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m vkvolume_tpu_torch.bench.ess_ratio",
        description=__doc__.split("\n\n")[0])
    p.add_argument("--datasets", default="beetle,present,snake")
    p.add_argument("--skipmodes", default="0,2,3")
    p.add_argument("--frames", type=int, default=10,
                   help="queued frames per repetition (5 repetitions)")
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--width", type=int, default=1200)
    p.add_argument("--height", type=int, default=1200)
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu (plain versions, "
                        "host-clock times)")
    args = p.parse_args(argv)
    results = run(args.datasets.split(","),
                  [int(s) for s in args.skipmodes.split(",")],
                  frames=args.frames, scale=args.scale, width=args.width,
                  height=args.height, out=args.out, device=args.device,
                  log=lambda m: print(m, file=sys.stderr, flush=True))
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
