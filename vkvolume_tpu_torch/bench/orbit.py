"""The free-camera orbit — port of ``scripts/orbit_bench.py``.

    python -m vkvolume_tpu_torch.bench.orbit [--frames 10] [--orbit 2]
        [--dataset beetle] [--skipmode 2] [--scale 1.0] [--width 1920]
        [--height 1080] [--out docs/h100/orbit.json] [--device cuda|cpu]

``run_config`` with ``Test.NONE``, ERT on, the pallas renderer and the
camera turned by ``orbit`` degrees of azimuth per frame: every timed pose
is fresh, so each frame pays its host plan. (The JAX script pins the
kernels' compile statics over the orbit first, ``freeze_orbit_statics``;
that is a TPU compile workaround and is not ported.) Prints ONE JSON line
in the script's schema, with ``device`` and ``power_limit``, and writes
it to ``--out``. ``vs_baseline`` is the reference VkVolume's beetle
skipmode-2 rate, 623.8 fps at 1200×1200 (``BASELINE.md``), pixel-scaled
to this frame, as a frame time over this run's median. ``--device cuda``
(the default) raises without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from ..engine.volume import resolve_device
from ..options import Test
from .harness import card, run_config, save_json

REFERENCE_FPS_1200 = 623.8
DEFAULT_OUT = "docs/h100/orbit.json"


def run(*, frames: int = 10, orbit: float = 2.0, dataset: str = "beetle",
        skipmode: int = 2, scale: float = 1.0, width: int = 1920,
        height: int = 1080, out: str = DEFAULT_OUT,
        device="cuda") -> dict:
    device = resolve_device(device)
    t0 = time.perf_counter()
    r = run_config(dataset, skipmode, 4, width=width, height=height,
                   frames=frames, scale=scale, test=Test.NONE, ert=True,
                   renderer="pallas", orbit_deg=orbit, device=device)
    wall = time.perf_counter() - t0
    baseline_ms = 1000.0 / (REFERENCE_FPS_1200
                            / ((width * height) / 1200.0 ** 2))
    reps = list(r.rep_ms)
    name, power_limit = card(device)
    result = {
        "metric": (f"ms/frame {width}x{height} {dataset} "
                   f"skipmode={skipmode} ORBIT {orbit} deg/frame"),
        "value": r.frame_ms,
        "unit": "ms/frame",
        "vs_baseline": baseline_ms / r.frame_ms,
        "fps": r.framerate,
        "map_update_ms": r.update,
        "occupancy_pct": r.occupancy,
        "frames": frames,
        "scale": scale,
        "wall_s": wall,
        "rep_ms": reps,
        "rep_spread": (max(reps) - min(reps)) / r.frame_ms,
        "renderer_used": r.renderer_used,
        "renderer_counts": r.renderer_counts,
        "orbit_deg_per_frame": orbit,
        "device": name,
        "power_limit": power_limit,
    }
    save_json(out, result)
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m vkvolume_tpu_torch.bench.orbit",
        description=__doc__.split("\n\n")[0])
    p.add_argument("--frames", type=int, default=10,
                   help="frames per repetition (5 repetitions)")
    p.add_argument("--orbit", type=float, default=2.0,
                   help="degrees of azimuth per frame")
    p.add_argument("--dataset", default="beetle")
    p.add_argument("--skipmode", type=int, default=2)
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu (plain versions, "
                        "host-clock times)")
    args = p.parse_args(argv)
    print(json.dumps(run(frames=args.frames, orbit=args.orbit,
                         dataset=args.dataset, skipmode=args.skipmode,
                         scale=args.scale, width=args.width,
                         height=args.height, out=args.out,
                         device=args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
