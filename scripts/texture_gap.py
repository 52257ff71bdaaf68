#!/usr/bin/env python3
"""The closed-form TF against the texture TF at the CLI's still pose:
one package's CLI engine renders the pose twice, with ``texture_tf`` off
and on, and the script prints the per-pixel gap (the largest channel
difference): its max, its mean and the share of pixels beyond 0.06 (the
JAX engine tests' closed-form-vs-texture bound on a 32x32 frame).

``--package jax`` runs the JAX package (the reference), ``--package torch``
the port; the other arguments go to that package's CLI parser. The XLA
sweep (``--renderer sweep``, the default here) needs no Pallas, so the JAX
package runs it on the CPU:

    JAX_PLATFORMS=cpu python scripts/texture_gap.py --package jax \
        --synth-scale 0.5
    python scripts/texture_gap.py --package torch --synth-scale 0.5 \
        --device cpu

and the port on the card, through either route:

    python scripts/texture_gap.py --package torch --renderer pallas
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

GAP_TOL = 0.06


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--package", choices=("jax", "torch"), required=True)
    args, rest = p.parse_known_args(argv)
    if args.package == "jax":
        from vkvolume_tpu import cli
        from vkvolume_tpu.camera import fit_distance, orbit_camera
    else:
        from vkvolume_tpu_torch import cli
        from vkvolume_tpu_torch.camera import fit_distance, orbit_camera
    defaults = ["--synth", "beetle", "--renderer", "sweep"]
    cargs = cli.build_parser().parse_args(defaults + rest)
    eng, vols = cli.setup_engine(cargs)
    for v in vols:
        eng.add_volume(v)
    w, h = cargs.width, cargs.height
    radius = fit_distance(50.0, np.deg2rad(60.0), w / h) * 1.3
    cam = orbit_camera(radius=radius, azimuth_deg=cargs.azimuth,
                       elevation_deg=cargs.elevation, aspect=w / h)
    frames, ms = [], []
    for texture in (False, True):
        eng.options.texture_tf = texture
        t0 = time.perf_counter()
        color = eng.render(cam, w, h).color
        frames.append(np.asarray(color.cpu() if args.package == "torch"
                                 else color))
        ms.append((time.perf_counter() - t0) * 1e3)
    gap = np.abs(frames[0] - frames[1]).max(axis=-1)
    print(json.dumps({
        "package": args.package, "synth_scale": cargs.synth_scale,
        "size": [w, h], "azimuth": cargs.azimuth,
        "elevation": cargs.elevation, "sampling": cargs.sampling,
        "renderer": eng.last_renderer,
        "max": float(gap.max()), "mean": float(gap.mean()),
        f"share_beyond_{GAP_TOL}": float((gap > GAP_TOL).mean()),
        "pixels_beyond": int((gap > GAP_TOL).sum()),
        "render_ms": ms}))


if __name__ == "__main__":
    main()
