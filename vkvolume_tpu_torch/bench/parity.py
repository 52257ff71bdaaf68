"""The parity matrix: the production frame against the per-ray marcher
oracle at full scale — port of ``scripts/tpu_parity.py``.

    python -m vkvolume_tpu_torch.bench.parity [--configs beetle:0,beetle:3]
        [--width 1920] [--height 1080] [--scale 1.0] [--no-repair]
        [--frames N] [--out docs/h100/parity.json] [--device cuda|cpu]

For each configuration ``dataset:skipmode`` (by default the 24 of the six
dataset/TF configurations × skipmodes 0-3) it renders the production
frame (``make_engine(..., benchmark_mode=False, renderer="pallas")`` at
``benchmark_camera``) and, once per dataset, the oracle (``renderer=
"marcher"`` at skipmode 2), and records their difference
(``parity_row``), then the same frame with edge repair (the suspect
pixels re-marched by the oracle) as the ``edge_repair`` column.

Two shares of pixels off by more than 8/255 in some channel are kept,
and they have different denominators:

* ``pct_pixels_gt_8_of_255``: % of the whole image (the JAX record's
  measure, ``docs/parity_r5.json``);
* ``pct_covered_gt_8_of_255``: % of the pixels covered (alpha > 0) in
  either frame (``chip_smoke.py`` phase 9c's measure).

Empty-space skipping decides only what to skip, never what is sampled, so
a dataset's frames at skipmodes 0-3 are equal: the matrix checks that
with ``torch.equal`` on the default images and on the repaired ones,
records the result per dataset under ``skipmode_invariant``, and raises
after writing the file when it fails. Every repair column is computed.

The output JSON has the JAX record's rows (keyed ``dataset:skipmode``)
beside ``device`` and ``power_limit`` (``nvidia-smi``) and
``skipmode_invariant``; it is rewritten after every row. Frame times
(``frame_ms``: ``frames`` queued frames, 10 by default and 3 with repair,
after the measured one) are the card's (CUDA events), the host clock's on
the CPU. ``--device cuda`` (the default) raises without a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import torch

from ..engine.volume import resolve_device
from ..utils.timing import rep_ms
from .datasets import DATASETS, synthesize
from .harness import benchmark_camera, card, make_engine, save_json

DATASET_KEYS = ("present", "present-grad", "beetle", "beetle-grad", "snake",
                "snake-grad")
CONFIGS = tuple(f"{ds}:{sm}" for ds in DATASET_KEYS for sm in (0, 1, 2, 3))
ORACLE_SKIPMODE = 2
GAP_8 = 8.0 / 255.0     # the per-pixel threshold of both shares
DEFAULT_OUT = "docs/h100/parity.json"


@dataclasses.dataclass
class Frame:
    color: torch.Tensor           # (H, W, 4) premultiplied RGBA
    renderer: str                 # the engine's last_renderer
    frame_ms: float | None        # per queued frame; None when not timed
    repair_px: tuple | None       # (suspects found, budget K) with repair


def repair_budget_fraction(n_probe: int, n_px: int) -> float:
    """The repair budget as a fraction of the frame: the smallest
    power-of-two fraction from 1/32 whose budget (at least 2048 pixels)
    covers 1.25 × the probe's suspect count, else 1. The headroom: the
    probe frame's count ran ~10 % under the repair frame's in the JAX
    record (``docs/parity_r4.json``, beetle)."""
    for frac in (1 / 32, 1 / 16, 1 / 8, 1 / 4, 1 / 2):
        if 1.25 * n_probe <= max(2048, int(n_px * frac)):
            return frac
    return 1.0


def render_config(renderer: str, dataset: str, skipmode: int, width: int,
                  height: int, scale: float, vol_u8, edge_repair=False,
                  device="cuda", frames: int | None = None) -> Frame:
    """One frame of a configuration from a fresh engine. With
    ``edge_repair`` a probe frame (budget 0) counts the suspects first and
    ``repair_budget_fraction`` sizes the budget. The pallas frames are
    then timed over ``frames`` queued frames (None: 10, 3 with repair;
    0: untimed)."""
    eng = make_engine(dataset, skipmode, 4, scale=scale, volume_u8=vol_u8,
                      renderer=renderer, benchmark_mode=False,
                      device=device)[0]
    eng.options.edge_repair = edge_repair
    cam = benchmark_camera(aspect=width / height)
    if edge_repair:
        eng.options.repair_budget = 0.0
        eng.render(cam, width, height)
        eng.options.repair_budget = repair_budget_fraction(
            eng.last_repair_px[0], width * height)
    color = eng.render(cam, width, height).color
    used = eng.last_renderer
    if frames is None:
        frames = 3 if edge_repair else 10
    frame_ms = None
    if renderer == "pallas" and frames:
        card_ms, host_ms = rep_ms(lambda: eng.render(cam, width, height), 1,
                                  frames, eng.device, warmup=0)
        frame_ms = (card_ms or host_ms)[0]
    # (0, 0) when the frame took the marcher, which needs no repair.
    repair_px = (tuple(getattr(eng, "last_repair_px", (0, 0)))
                 if edge_repair else None)
    return Frame(color, used, frame_ms, repair_px)


def parity_row(got: torch.Tensor, ref: torch.Tensor) -> dict:
    """Difference statistics of a frame against the oracle's, with the
    JAX record's keys and ``pct_covered_gt_8_of_255`` (covered in either
    frame), plus the pixel counts behind the shares."""
    d = (got - ref).abs()
    far = d.amax(-1) > GAP_8
    covered = (got[..., 3] > 0) | (ref[..., 3] > 0)
    n_far, n_cov = int(far.sum()), int(covered.sum())
    return dict(
        max_abs_diff=float(d.max()),
        mean_abs_diff=float(d.mean()),
        pct_pixels_gt_8_of_255=100.0 * n_far / far.numel(),
        pct_covered_gt_8_of_255=(100.0 * int(far[covered].sum()) / n_cov
                                 if n_cov else 0.0),
        alpha_mean_ref=float(ref[..., 3].mean()),
        alpha_mean_got=float(got[..., 3].mean()),
        covered_px=int((ref[..., 3] > 0).sum()),
        covered_either_px=n_cov,
        px_gt_8_of_255=n_far,
    )


def run_matrix(configs=CONFIGS, *, width: int = 1920, height: int = 1080,
               scale: float = 1.0, repair: bool = True,
               frames: int | None = None, out: str = DEFAULT_OUT,
               device="cuda", log=print) -> dict:
    """The matrix over ``configs`` (``dataset:skipmode``), written to
    ``out``. Each base volume is synthesised once for its run of
    configurations, each dataset's oracle rendered once."""
    device = resolve_device(device)
    name, power_limit = card(device)
    results = {"device": name, "power_limit": power_limit,
               "skipmode_invariant": {}}
    invariant = results["skipmode_invariant"]
    base = vol = None
    oracle_of = ref = None
    firsts = {}            # column -> its first image of the dataset
    for cfg in configs:
        dataset, skipmode = cfg.split(":")
        skipmode = int(skipmode)
        t0 = time.perf_counter()
        if dataset.split("-")[0] != base:
            base, vol = dataset.split("-")[0], None
            vol = synthesize(DATASETS[dataset], scale=scale)
        if dataset != oracle_of:
            oracle_of, ref, firsts = dataset, None, {}
            ref = render_config("marcher", dataset, ORACLE_SKIPMODE, width,
                                height, scale, vol, device=device).color
        got = render_config("pallas", dataset, skipmode, width, height,
                            scale, vol, device=device, frames=frames)
        row = dict(renderer_used=got.renderer, image=f"{width}x{height}",
                   scale=scale, **parity_row(got.color, ref),
                   frame_ms=got.frame_ms,
                   wall_s=time.perf_counter() - t0)
        images = {"default": got.color}
        if repair:
            t1 = time.perf_counter()
            rep = render_config("pallas", dataset, skipmode, width, height,
                                scale, vol, edge_repair=True, device=device,
                                frames=frames)
            row["edge_repair"] = dict(
                **parity_row(rep.color, ref), repaired_px=rep.repair_px[0],
                budget_px=rep.repair_px[1], frame_ms=rep.frame_ms,
                wall_s=time.perf_counter() - t1)
            images["edge_repair"] = rep.color
        same = invariant.setdefault(dataset, {})
        for column, img in images.items():
            first = firsts.setdefault(column, img)
            same[column] = same.get(column, True) and torch.equal(first, img)
        results[cfg] = row
        save_json(out, results)
        log(f"{cfg}: {row}")
    broken = {ds: cols for ds, cols in invariant.items()
              if not all(cols.values())}
    if broken:
        raise AssertionError(f"frames differ across skipmodes: {broken} "
                             f"(see {out})")
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m vkvolume_tpu_torch.bench.parity",
        description=__doc__.split("\n\n")[0])
    p.add_argument("--configs", default=",".join(CONFIGS),
                   help="comma-separated dataset:skipmode (default: all 24)")
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--scale", type=float, default=1.0,
                   help="the synthetic volumes' scale")
    p.add_argument("--no-repair", action="store_true",
                   help="leave out the edge-repair column")
    p.add_argument("--frames", type=int, default=None,
                   help="queued frames timed per frame (default 10, 3 with "
                        "repair; 0 times none)")
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu (plain versions)")
    args = p.parse_args(argv)
    run_matrix(args.configs.split(","), width=args.width, height=args.height,
               scale=args.scale, repair=not args.no_repair,
               frames=args.frames, out=args.out, device=args.device,
               log=lambda m: print(m, file=sys.stderr, flush=True))
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
