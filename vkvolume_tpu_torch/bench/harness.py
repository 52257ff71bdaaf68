"""Benchmark harness — port of ``vkvolume_tpu/bench/harness.py``.

Reproduces the reference measurement protocol (BASELINE.md): per
(dataset, skipmode, blocksize) configuration render N frames of a static
fit-to-viewport view and report

    image, skipmode, blocksize, occupancy, framerate, update, imin, imax,
    gmin, gmax

in the same CSV schema as scripts/benchmark_results_<skipmode>.csv.
Benchmark mode forces clip_distance = 1, ERT off, NumTextureSamples
output (src/volume_render.cpp:177-183); map-update time is the mean of
20 queued builds (:421-430); occupancy % comes from the voxel-count
reduction (:399-418). Frame times come from CUDA events on the card, the
host clock on the CPU (``utils/timing.rep_ms``).

The JAX package's ``freeze_orbit_statics`` / ``freeze_statics`` pin
Mosaic compile statics over a camera path, a TPU workaround, and are not
ported.
"""

from __future__ import annotations

import csv
import dataclasses
import json
import os
import statistics
import subprocess
import time

import numpy as np

from ..camera import fit_distance, orbit_camera
from ..engine import Engine, RenderOptions, from_array
from ..options import SkippingType, Test, VolumeOptions
from ..utils.timing import rep_ms
from .datasets import DATASETS, synthesize

CSV_COLUMNS = ["image", "skipmode", "blocksize", "occupancy", "framerate",
               "update", "imin", "imax", "gmin", "gmax"]


def card(device) -> tuple:
    """(name, power limit) of the card ``device`` names, as ``nvidia-smi``
    gives them; ("cpu", None) on the CPU."""
    import torch

    if device.type != "cuda":
        return "cpu", None
    index = device.index if device.index is not None else 0
    out = subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    return torch.cuda.get_device_name(index), out


def save_json(path: str, obj) -> None:
    """Write ``obj`` to ``path`` as indented JSON, making its directory."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as fh:
        json.dump(obj, fh, indent=1)


def benchmark_camera(aspect: float, azimuth=30.0, elevation=20.0):
    """Deterministic benchmark pose: the volume is a 100-unit cube at the
    origin (src/volume_render.cpp:233) and the camera fills the viewport
    with it."""
    radius = fit_distance(50.0, np.deg2rad(60.0), aspect) * 1.05
    return orbit_camera(radius=radius, azimuth_deg=azimuth,
                        elevation_deg=elevation, aspect=aspect)


@dataclasses.dataclass
class BenchResult:
    image: str
    skipmode: int
    blocksize: int
    occupancy: float
    framerate: float
    update: float
    imin: float
    imax: float
    gmin: float
    gmax: float
    frame_ms: float = 0.0
    load_s: float = 0.0
    rep_ms: tuple = ()        # per-repetition ms/frame (spread diagnostics)
    rep_host_ms: tuple = ()   # the same repetitions on the host clock
    renderer_used: str = ""
    renderer_counts: dict | None = None   # frames per renderer (fallback rate)
    engine: object = None     # set when keep_engine=True (stage breakdown)

    def row(self):
        return [self.image, self.skipmode, self.blocksize,
                round(self.occupancy, 6), round(self.framerate, 2),
                round(self.update, 4), self.imin, self.imax, self.gmin,
                self.gmax]


def make_engine(
    dataset_key: str,
    skipmode: int,
    blocksize: int = 4,
    *,
    scale: float = 1.0,
    seed: int = 0,
    volume_u8=None,
    renderer: str = "pallas",
    benchmark_mode: bool = True,
    test: Test | None = None,
    ert: bool | None = None,
    fit: str = "aspect",
    device: str = "cuda",
):
    """Engine + loaded synthetic volume for one benchmark configuration,
    on ``device`` (by default the CUDA card; raises without one). ``fit``:
    "aspect" scales the volume uniformly into the 100-unit cube (bench.py's
    default), "stretch" stretches every axis to 100, the reference
    benchmark's exact fit (src/volume_render.cpp:224-233). Returns
    (engine, add_volume stats, volume array, synthesis seconds)."""
    if fit not in ("aspect", "stretch"):
        raise ValueError(f"fit {fit!r}: 'aspect' or 'stretch'")
    ds = DATASETS[dataset_key]
    eng = Engine(RenderOptions(skipping_type=SkippingType(skipmode)),
                 benchmark_mode=benchmark_mode, renderer=renderer,
                 device=device)
    t_load = time.perf_counter()
    if volume_u8 is None:
        volume_u8 = synthesize(ds, seed=seed, scale=scale)
    load_s = time.perf_counter() - t_load

    opts = VolumeOptions(
        intensity_min=ds.imin, intensity_max=ds.imax,
        gradient_min=ds.gmin, gradient_max=ds.gmax,
    )
    if test is not None:
        eng.options.test = test
    if ert is not None:
        eng.options.early_ray_termination = ert
    vol = from_array(volume_u8, opts, block_size=blocksize, name=ds.filename,
                     device=device)
    d, h, w = volume_u8.shape
    if fit == "stretch":
        vol.set_scale((100.0 / w, 100.0 / h, 100.0 / d))
    else:
        vol.set_scale((100.0 / max(d, h, w),) * 3)
    stats = eng.add_volume(vol)
    return eng, stats, volume_u8, load_s


def run_config(
    dataset_key: str,
    skipmode: int,
    blocksize: int,
    *,
    width: int = 1200,
    height: int = 1200,
    frames: int = 20,
    reps: int = 5,
    scale: float = 1.0,
    seed: int = 0,
    volume_u8=None,
    test: Test | None = None,
    ert: bool | None = None,
    renderer: str = "pallas",
    orbit_deg: float = 0.0,
    fit: str = "aspect",
    keep_engine: bool = False,
    device: str = "cuda",
) -> BenchResult:
    """One configuration: a warm frame, then ``reps`` repetitions of
    ``frames`` queued frames ended by one synchronise; ``frame_ms`` is the
    median repetition (CUDA events on the card, the host clock on the CPU;
    the host clock's repetitions are kept beside them).

    ``orbit_deg`` turns the camera by that many degrees of azimuth per
    frame (the reference protocol uses a free camera). The exact timed
    poses are rendered once first, then their per-pose cache entries are
    purged, so that each timed frame still pays its host plan."""
    ds = DATASETS[dataset_key]
    eng, stats, volume_u8, load_s = make_engine(
        dataset_key, skipmode, blocksize, scale=scale, seed=seed,
        volume_u8=volume_u8, renderer=renderer, test=test, ert=ert, fit=fit,
        device=device,
    )
    aspect = width / height

    def cam_for(i):
        return benchmark_camera(aspect, azimuth=30.0 + orbit_deg * i)

    eng.render(cam_for(0), width, height)
    eng._sync()
    if orbit_deg:
        for i in range(frames * reps):
            eng.render(cam_for(i), width, height)
        eng._sync()
        # Drop the per-pose entries (uniforms, view, plan); the stitched
        # maps ("occ") and the transposes stay.
        for v in eng.volumes:
            cache = getattr(v, "_sweep_cache", None) or {}
            for k in [k for k in cache if isinstance(k, tuple)
                      and k[0] == "pose"]:
                del cache[k]
    idx = 0

    def rep():
        nonlocal idx
        eng.render(cam_for(idx), width, height)
        idx += 1

    card, host = rep_ms(rep, reps, frames, eng.device, warmup=0)
    times = card if card is not None else host
    frame_ms = float(statistics.median(times))

    return BenchResult(
        image=dataset_key.split("-")[0],
        skipmode=skipmode,
        blocksize=blocksize,
        occupancy=stats.occupied_voxel_percent or 0.0,
        framerate=1000.0 / frame_ms,
        update=stats.map_update_ms or 0.0,
        imin=ds.imin, imax=ds.imax, gmin=ds.gmin, gmax=ds.gmax,
        frame_ms=frame_ms, load_s=load_s,
        rep_ms=tuple(times), rep_host_ms=tuple(host),
        renderer_used=eng.last_renderer or "",
        renderer_counts=dict(eng.renderer_counts),
        engine=eng if keep_engine else None,
    )


def capture(engine, camera, width: int, height: int):
    """(sweep, inputs) of the last sweep one frame launches: "K1" and its
    ``BrickInputs`` or "K7" and its ``SlabInputs``, exactly as the frame
    builds them (renders the frame once)."""
    from ..render import sweep_bricks, sweep_slabs

    got = []
    saved = (sweep_bricks.sweep_bricks_kernel, sweep_slabs.sweep_slabs_kernel)

    def grab(name, fn):
        def run(inp):
            got.append((name, inp))
            return fn(inp)
        return run

    sweep_bricks.sweep_bricks_kernel = grab("K1", saved[0])
    sweep_slabs.sweep_slabs_kernel = grab("K7", saved[1])
    try:
        engine.render(camera, width, height)
    finally:
        sweep_bricks.sweep_bricks_kernel, sweep_slabs.sweep_slabs_kernel = saved
    assert got, "the frame ran no sweep"
    return got[-1]


def capture_stages(engine, camera, width: int, height: int):
    """The arguments one frame hands its w-grid frame and its pixel stage:
    ((args, kwargs) of ``sweep_frame._frame_body``, (args, kwargs) of
    ``sweep_frame._pixel_stage``), or None when the pose runs no w-grid
    frame (the XLA sweep's views). Renders the frame once."""
    from ..render import sweep_frame

    got = {}
    saved = (sweep_frame._frame_body, sweep_frame._pixel_stage)

    def grab(name, fn):
        def run(*a, **k):
            got[name] = (a, k)
            return fn(*a, **k)
        return run

    sweep_frame._frame_body = grab("body", saved[0])
    sweep_frame._pixel_stage = grab("pixel", saved[1])
    try:
        engine.render(camera, width, height)
    finally:
        sweep_frame._frame_body, sweep_frame._pixel_stage = saved
    if "body" not in got:
        return None
    return got["body"], got["pixel"]


def stage_breakdown(eng, cam, width: int, height: int,
                    reps: int = 3, inner: int = 10) -> dict | None:
    """Per-stage frame times of the w-grid frame at this pose:

    * ``plan_ms``  — the host plan a fresh pose pays
      (``sweep_frame.select_view_plan``: ``render/plan.analyze_view`` and
      ``plan_from_stats`` per candidate axis), host clock, mean of 20;
    * ``sweep_ms`` — the warp's positions, the w-grid fields and the
      sweep (K1 or K7), up to the channel stack;
    * ``warp_ms``  — the pixel stage: the warp (K2 twice, K8 or the gather
      warp) and the pixel outputs.

    The frame's own arguments are captured (``capture_stages``); each
    device stage is timed as ``inner`` queued runs per repetition, the
    median of ``reps`` (CUDA events on the card, host clock on the CPU).
    None when the pose runs no w-grid frame."""
    from ..render import sweep_frame
    from ..render.ray_setup import axis_shape

    got = capture_stages(eng, cam, width, height)
    if got is None:
        return None
    (a, k), (pa, pk) = got
    uniforms = sweep_frame.unpack_frame_scalars(a[3])[0]
    dsh = tuple(eng.volumes[0].density.shape)

    t0 = time.perf_counter()
    for _ in range(20):
        sweep_frame.select_view_plan(uniforms, k["height"], k["width"],
                                     lambda q: axis_shape(dsh, q))
    plan_ms = (time.perf_counter() - t0) * 1e3 / 20

    def timed(fn):
        card, host = rep_ms(fn, reps, inner, eng.device)
        return float(statistics.median(card if card is not None else host))

    sweep_ms = timed(lambda: sweep_frame._frame_body(*a, **k,
                                                     return_chans=True))
    warp_ms = timed(lambda: sweep_frame._pixel_stage(*pa, **pk))
    return dict(plan_ms=plan_ms, sweep_ms=sweep_ms, warp_ms=warp_ms)


def run_sweep(
    *,
    dataset_keys=("present", "present-grad", "beetle", "beetle-grad",
                  "snake", "snake-grad"),
    skipmodes=(0, 1, 2, 3),
    blocksizes=(2, 3, 4, 5, 6),
    width=1200, height=1200, frames=20, scale=1.0,
    out_prefix="benchmark_results",
    device="cuda",
    log=print,
):
    """Full sweep, one CSV per skipmode (scripts/benchmark.py:66-93), on
    ``device``. Skipmode 0 runs only the smallest block size, like the
    reference (:71). Rows are appended to ``<out_prefix>_<skipmode>.csv``
    as they complete, and rows already there (same image, block size and
    gradient range) are skipped on a restart. Each dataset's volume is
    synthesised once (the -grad keys share their base's)."""
    volumes = {}
    for skipmode in skipmodes:
        path = f"{out_prefix}_{skipmode}.csv"
        done = set()
        if os.path.exists(path):
            with open(path, newline="") as fh:
                for row in csv.DictReader(fh):
                    done.add((row["image"], int(row["blocksize"]),
                              float(row["gmin"]), float(row["gmax"])))
        else:
            with open(path, "w", newline="") as fh:
                csv.writer(fh).writerow(CSV_COLUMNS)
        for key in dataset_keys:
            ds = DATASETS[key]
            base = key.split("-")[0]
            for b in blocksizes:
                if skipmode == 0 and b != min(blocksizes):
                    continue
                if (base, b, ds.gmin, ds.gmax) in done:
                    log(f"{key} skipmode={skipmode} b={b}: already done")
                    continue
                if base not in volumes:
                    volumes[base] = synthesize(ds, scale=scale)
                r = run_config(key, skipmode, b, width=width, height=height,
                               frames=frames, scale=scale,
                               volume_u8=volumes[base], device=device)
                log(f"{key} skipmode={skipmode} b={b}: "
                    f"{r.framerate:.1f} fps, update {r.update:.2f} ms, "
                    f"occ {r.occupancy:.2f}%")
                with open(path, "a", newline="") as fh:
                    csv.writer(fh).writerow(r.row())
        log(f"wrote {path}")
