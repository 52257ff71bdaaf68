"""Per-ray texture-sample counts: the w-grid frame against the per-ray
marcher oracle at the benchmark pose — port of
``scripts/sample_count_ab.py``.

    python -m vkvolume_tpu_torch.bench.sample_count [--configs beetle:2]
        [--width 1920] [--height 1080] [--scale 1.0]
        [--out docs/h100/sample_count.json] [--device cuda|cpu]

For each configuration ``dataset:skipmode`` (by default the six
dataset/TF configurations of ``parity.DATASET_KEYS`` × skipmodes 2 and 3)
it renders the benchmark pose twice from fresh engines, ``pallas`` then
``marcher``, under the reference's own NumTextureSamples diagnostic
(``make_engine(..., benchmark_mode=False,
test=Test.NUM_TEXTURE_SAMPLES)``, volume_render.frag:323-335) with early
ray termination forced off, as the reference's benchmark protocol does
(src/volume_render.cpp:177-183). Both run at the configuration's
skipmode: the marcher's count depends on its distance map.

The frame's colour is count / n_steps_max (volume_render.frag:324), so
``colour[..., 0] * n_steps_max`` recovers the counts. The w-grid frame's
counts pass through the two-pass warp's u16 encoding and are
interpolated between grid cells: they are fractional and quantised. The
sweep's empty-space windows are per (tile, brick), so rays of a tile that
straddles an occupancy boundary sample slabs a per-ray march leaps over;
the ``ratio`` block (w-grid / marcher, per pixel where both counts are
> 0) measures that work against the oracle's.

Per renderer the record keeps the script's statistics over the covered
pixels (alpha > 0): ``renderer_used``, ``mean_per_covered``, ``p50``,
``p90``, ``p99``, ``total_msamples``, ``covered_px``, ``wall_s`` (engine,
map build and one frame, host clock); then ``ratio`` (``total``, ``p50``,
``p90``, ``p99``) and ``config``. The rows are keyed ``dataset:skipmode``
beside ``device`` and ``power_limit`` and the file is rewritten after
every row. A frame that did not take the renderer asked for raises after
the file is written. ``--device cuda`` (the default) raises without a
CUDA device.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..engine.volume import resolve_device
from ..options import Test
from ..render.sweep_bricks import n_steps_max
from .datasets import DATASETS, synthesize
from .harness import benchmark_camera, card, make_engine, save_json
from .parity import DATASET_KEYS

CONFIGS = tuple(f"{ds}:{sm}" for ds in DATASET_KEYS for sm in (2, 3))
RENDERERS = ("pallas", "marcher")
DEFAULT_OUT = "docs/h100/sample_count.json"


def count_frame(renderer: str, dataset: str, skipmode: int, width: int,
                height: int, scale: float, vol_u8, device="cuda"):
    """One NumTextureSamples frame with ERT off from a fresh engine:
    (per-pixel counts, covered mask, both numpy; the renderer used; wall
    seconds of the engine, its maps and the frame)."""
    t0 = time.perf_counter()
    eng = make_engine(dataset, skipmode, 4, scale=scale, volume_u8=vol_u8,
                      renderer=renderer, benchmark_mode=False,
                      test=Test.NUM_TEXTURE_SAMPLES, device=device)[0]
    eng.options.early_ray_termination = False
    color = eng.render(benchmark_camera(aspect=width / height), width,
                       height).color.cpu().numpy()
    wall_s = time.perf_counter() - t0
    v = eng.volumes[0]
    counts = color[..., 0] * n_steps_max(max(v.density.shape),
                                         v.options.sampling_factor)
    return counts, color[..., 3] > 0, eng.last_renderer, wall_s


def count_stats(counts: np.ndarray, covered: np.ndarray) -> dict:
    """The script's statistics of one frame's counts over its covered
    pixels (``scripts/sample_count_ab.py:62-71``)."""
    c = counts[covered]
    return dict(mean_per_covered=float(c.mean()),
                p50=float(np.percentile(c, 50)),
                p90=float(np.percentile(c, 90)),
                p99=float(np.percentile(c, 99)),
                total_msamples=float(counts.sum() / 1e6),
                covered_px=int(covered.sum()))


def ratio_stats(p: np.ndarray, m: np.ndarray) -> dict:
    """w-grid / marcher counts: the totals' ratio and the percentiles of
    the per-pixel ratio where both counts are > 0
    (``scripts/sample_count_ab.py:73-83``)."""
    both = (p > 0) & (m > 0)
    ratio = p[both] / np.maximum(m[both], 1.0)
    return dict(total=float(p.sum() / max(m.sum(), 1.0)),
                p50=float(np.percentile(ratio, 50)),
                p90=float(np.percentile(ratio, 90)),
                p99=float(np.percentile(ratio, 99)))


def run(configs=CONFIGS, *, width: int = 1920, height: int = 1080,
        scale: float = 1.0, out: str = DEFAULT_OUT, device="cuda",
        log=print) -> dict:
    """The protocol over ``configs`` (``dataset:skipmode``), written to
    ``out``. Each base volume is synthesised once for its run of
    configurations."""
    device = resolve_device(device)
    name, power_limit = card(device)
    results = {"device": name, "power_limit": power_limit}
    base = vol = None
    for cfg in configs:
        dataset, skipmode = cfg.split(":")
        skipmode = int(skipmode)
        if dataset.split("-")[0] != base:
            base, vol = dataset.split("-")[0], None
            vol = synthesize(DATASETS[dataset], scale=scale)
        row, counts = {}, {}
        for renderer in RENDERERS:
            c, covered, used, wall_s = count_frame(
                renderer, dataset, skipmode, width, height, scale, vol,
                device=device)
            row[renderer] = dict(renderer_used=used,
                                 **count_stats(c, covered), wall_s=wall_s)
            counts[renderer] = c
        row["ratio"] = ratio_stats(counts["pallas"], counts["marcher"])
        row["config"] = dict(dataset=dataset, skipmode=skipmode, scale=scale,
                             image=f"{width}x{height}", ert=False)
        results[cfg] = row
        save_json(out, results)
        log(f"{cfg}: {row}")
        torch.cuda.empty_cache()
        wrong = {r: row[r]["renderer_used"] for r in RENDERERS
                 if row[r]["renderer_used"] != r}
        if wrong:
            raise AssertionError(f"{cfg}: frames took {wrong} (see {out})")
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m vkvolume_tpu_torch.bench.sample_count",
        description=__doc__.split("\n\n")[0])
    p.add_argument("--configs", default=",".join(CONFIGS),
                   help="comma-separated dataset:skipmode (default: the six "
                        "datasets at skipmodes 2 and 3)")
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--scale", type=float, default=1.0,
                   help="the synthetic volumes' scale")
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu (plain versions)")
    args = p.parse_args(argv)
    run(args.configs.split(","), width=args.width, height=args.height,
        scale=args.scale, out=args.out, device=args.device,
        log=lambda m: print(m, file=sys.stderr, flush=True))
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
