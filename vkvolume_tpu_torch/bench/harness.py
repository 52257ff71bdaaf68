"""Benchmark set-up — port of the engine construction in
``vkvolume_tpu/bench/harness.py``: the same synthetic dataset, TF, skip
mode, block size and camera as ``bench.py``'s frame. The timed protocol
(``run_config``, the CSV sweep) is not ported yet.
"""

from __future__ import annotations

import time

import numpy as np

from ..camera import fit_distance, orbit_camera
from ..engine import Engine, RenderOptions, from_array
from ..options import SkippingType, Test, VolumeOptions
from .datasets import DATASETS, synthesize


def benchmark_camera(aspect: float, azimuth=30.0, elevation=20.0):
    """Deterministic benchmark pose: the volume is a 100-unit cube at the
    origin (src/volume_render.cpp:233) and the camera fills the viewport
    with it."""
    radius = fit_distance(50.0, np.deg2rad(60.0), aspect) * 1.05
    return orbit_camera(radius=radius, azimuth_deg=azimuth,
                        elevation_deg=elevation, aspect=aspect)


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
    device: str = "cuda",
):
    """Engine + loaded synthetic volume for one benchmark configuration,
    on ``device`` (by default the CUDA card; raises without one). Returns
    (engine, add_volume stats, volume array, synthesis seconds)."""
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
    # Aspect-preserving fit into the 100-unit cube (bench.py's default).
    vol.set_scale((100.0 / max(d, h, w),) * 3)
    stats = eng.add_volume(vol)
    return eng, stats, volume_u8, load_s


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
