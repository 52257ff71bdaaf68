"""Warp against quadrature: the XLA sweep and the w-grid frame, each
against the per-ray marcher oracle — port of
``scripts/warp_vs_quadrature.py``.

    python -m vkvolume_tpu_torch.bench.warp_vs_quadrature
        [--configs beetle:2] [--renderers sweep,pallas] [--width 1920]
        [--height 1080] [--scale 1.0] [--parity-record docs/h100/parity.json]
        [--out docs/h100/warp_vs_quadrature.json] [--device cuda|cpu]

For each configuration ``dataset:skipmode`` (by default the six datasets
of ``parity.DATASET_KEYS`` at skipmode 2) it renders the benchmark pose
from one synthesised volume with ``parity.render_config`` (fresh engines,
``benchmark_mode=False``): the oracle (``marcher``), then each renderer.
``sweep`` is the XLA sweep (``render/sweep.py``): the same slab
quadrature as the w-grid frame, with no w-grid and no warp; ``pallas`` is
the w-grid frame (the brick sweep and the warp). If the XLA sweep is
clean and the w-grid frame is not, the gap against the oracle lives in
the grid and the warp; if both are off alike, it is the quadrature.

Per renderer the record keeps the script's keys: ``renderer_used``;
``pct_all``, the % of the image whose channel max of |got - ref| is over
8/255; ``pct_covered``, the same share of the oracle's covered pixels
(alpha > 1e-6); ``max_abs``, ``mean_abs``, ``alpha_mean_got``; and
``config.alpha_mean_ref``. Beside them: ``parity``, ``parity.parity_row``
of the same frames (its ``pct_covered_gt_8_of_255`` divides by the pixels
covered in either frame), and each frame's ``wall_s`` (engine, maps and
one frame, host clock).

The w-grid frame at ``dataset:skipmode`` against the oracle is the
parity matrix's row of that key, and the frames are deterministic, so
the ``pallas`` column's ``px_gt_8_of_255`` must equal that row's in
``--parity-record`` when the record has the row at the same image size
and scale: ``matches_parity_record`` per configuration (None without such
a row). ``main`` exits 1 after writing the file when one differs. The
file is rewritten after every configuration, with ``device`` and
``power_limit``; a frame that did not take the renderer asked for raises
after it is written. ``--device cuda`` (the default) raises without a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from ..engine.volume import resolve_device
from . import parity
from .datasets import DATASETS, synthesize
from .harness import card, save_json

CONFIGS = tuple(f"{ds}:2" for ds in parity.DATASET_KEYS)
RENDERERS = ("sweep", "pallas")
DEFAULT_OUT = "docs/h100/warp_vs_quadrature.json"


def frame(renderer, dataset, skipmode, width, height, scale, vol, device):
    """(colour on the host, renderer used, wall seconds) of one untimed
    ``parity.render_config`` frame."""
    t0 = time.perf_counter()
    f = parity.render_config(renderer, dataset, skipmode, width, height,
                             scale, vol, device=device, frames=0)
    return f.color.cpu(), f.renderer, time.perf_counter() - t0


def column(got: torch.Tensor, ref: torch.Tensor) -> dict:
    """The script's statistics of a frame against the oracle
    (``scripts/warp_vs_quadrature.py:62-72``)."""
    d = (got - ref).abs()
    bad = d.amax(-1) > parity.GAP_8
    cov = ref[..., 3] > 1e-6
    return dict(pct_all=100.0 * int(bad.sum()) / bad.numel(),
                pct_covered=100.0 * int(bad[cov].sum()) / int(cov.sum()),
                max_abs=float(d.max()),
                mean_abs=float(d.mean()),
                alpha_mean_got=float(got[..., 3].mean()))


def record_row(path: str, cfg: str, image: str, scale: float):
    """The parity record's row ``cfg`` when ``path`` holds one at this
    image size and scale, else None."""
    if not os.path.exists(path):
        return None
    with open(path) as fh:
        row = json.load(fh).get(cfg)
    if row is None or row.get("image") != image or row.get("scale") != scale:
        return None
    return row


def run(configs=CONFIGS, renderers=RENDERERS, *, width: int = 1920,
        height: int = 1080, scale: float = 1.0,
        parity_record: str = parity.DEFAULT_OUT, out: str = DEFAULT_OUT,
        device="cuda", log=print) -> dict:
    """The protocol over ``configs`` (``dataset:skipmode``), written to
    ``out``. Each base volume is synthesised once for its run of
    configurations."""
    device = resolve_device(device)
    name, power_limit = card(device)
    results = {"device": name, "power_limit": power_limit}
    image = f"{width}x{height}"
    base = vol = None
    for cfg in configs:
        dataset, skipmode = cfg.split(":")
        skipmode = int(skipmode)
        if dataset.split("-")[0] != base:
            base, vol = dataset.split("-")[0], None
            vol = synthesize(DATASETS[dataset], scale=scale)
        ref, ref_used, ref_s = frame("marcher", dataset, skipmode, width,
                                     height, scale, vol, device)
        row = {}
        for r in renderers:
            got, used, wall_s = frame(r, dataset, skipmode, width, height,
                                      scale, vol, device)
            row[r] = dict(renderer_used=used, **column(got, ref),
                          parity=parity.parity_row(got, ref), wall_s=wall_s)
        row["config"] = dict(dataset=dataset, skipmode=skipmode, scale=scale,
                             image=image,
                             alpha_mean_ref=float(ref[..., 3].mean()),
                             oracle_renderer_used=ref_used,
                             oracle_wall_s=ref_s)
        want = record_row(parity_record, cfg, image, scale)
        row["matches_parity_record"] = (
            None if want is None or "pallas" not in row
            else row["pallas"]["parity"]["px_gt_8_of_255"]
            == want["px_gt_8_of_255"])
        results[cfg] = row
        save_json(out, results)
        log(f"{cfg}: {row}")
        torch.cuda.empty_cache()
        wrong = {r: row[r]["renderer_used"] for r in renderers
                 if row[r]["renderer_used"] != r}
        if ref_used != "marcher":
            wrong["marcher"] = ref_used
        if wrong:
            raise AssertionError(f"{cfg}: frames took {wrong} (see {out})")
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m vkvolume_tpu_torch.bench.warp_vs_quadrature",
        description=__doc__.split("\n\n")[0])
    p.add_argument("--configs", default=",".join(CONFIGS),
                   help="comma-separated dataset:skipmode (default: the six "
                        "datasets at skipmode 2)")
    p.add_argument("--renderers", default=",".join(RENDERERS))
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--scale", type=float, default=1.0,
                   help="the synthetic volumes' scale")
    p.add_argument("--parity-record", default=parity.DEFAULT_OUT,
                   help="the parity matrix's record to hold the pallas "
                        "column to")
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu (plain versions)")
    args = p.parse_args(argv)
    results = run(args.configs.split(","), args.renderers.split(","),
                  width=args.width, height=args.height, scale=args.scale,
                  parity_record=args.parity_record, out=args.out,
                  device=args.device,
                  log=lambda m: print(m, file=sys.stderr, flush=True))
    print(f"wrote {args.out}")
    differ = [k for k, v in results.items()
              if isinstance(v, dict) and v["matches_parity_record"] is False]
    if differ:
        print(f"the pallas column differs from {args.parity_record} at "
              f"{differ}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
