"""The texture-TF path and the XLA sweep through the port's Engine (plain
PyTorch on the CPU) against the JAX package's Engine (its Pallas frame in
interpret mode), on the synthetic beetle at scale 0.1 with the CLI's TF
(skipmode 2, imin 0.1, gradient 0..0.2): a texture frame K1 takes and one
it cannot (sampling 0.25: fewer slabs than voxel planes, the XLA sweep);
``renderer="sweep"``; a view with no w-grid plan; and the closed form
against the texture on the JAX engine tests' sphere shell."""

import functools

import numpy as np
import pytest

from util import sphere_shell_volume
from vkvolume_tpu.bench import harness as jh
from vkvolume_tpu.bench.datasets import DATASETS, synthesize
from vkvolume_tpu.engine import Engine as JEngine
from vkvolume_tpu.engine import from_array as j_from_array
from vkvolume_tpu.options import RenderOptions as JRenderOptions
from vkvolume_tpu.options import SkippingType as JSkip
from vkvolume_tpu.options import VolumeOptions as JVolumeOptions
from vkvolume_tpu.render import sweep_pallas
from vkvolume_tpu_torch.camera import orbit_camera
from vkvolume_tpu_torch.engine import (Engine, RenderOptions, SkippingType,
                                       VolumeOptions, from_array)
from vkvolume_tpu_torch.render import sweep_frame
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TF = dict(intensity_min=0.1, gradient_min=0.0, gradient_max=0.2)
W = H = 256


@pytest.fixture(scope="module")
def volume():
    return synthesize(DATASETS["beetle"], seed=0, scale=0.1)


def _pair(volume, renderer="pallas", texture_tf=True):
    """(JAX engine, port engine) on the same volume and options."""
    jeng = JEngine(JRenderOptions(skipping_type=JSkip.DISTANCE,
                                  texture_tf=texture_tf), renderer=renderer)
    teng = Engine(RenderOptions(skipping_type=SkippingType.DISTANCE,
                                texture_tf=texture_tf), renderer=renderer,
                  device="cpu")
    for eng, make, opts in ((jeng, j_from_array, JVolumeOptions(**TF)),
                            (teng, functools.partial(from_array,
                                                     device="cpu"),
                             VolumeOptions(**TF))):
        v = make(volume, opts, block_size=4)
        v.set_scale((100.0 / max(volume.shape),) * 3)
        eng.add_volume(v)
    np.testing.assert_array_equal(teng.volumes[0].tf_texture,
                                  jeng.volumes[0].tf_texture)
    return jeng, teng


def _assert_frames_match(got, want):
    """tests/test_torch_frame.py's tolerance: 2e-3 on >= 99.9 % of the
    pixels, mean alpha within 1e-4."""
    got, want = got.color.numpy(), np.asarray(want.color)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert (want[..., 3] > 0).mean() > 0.05             # real content
    bad = (np.abs(got - want).max(axis=-1) > 2e-3).mean()
    assert bad <= 1e-3, bad
    assert abs(got[..., 3].mean() - want[..., 3].mean()) <= 1e-4


@pytest.mark.parametrize("sampling,route", [(1.0, "pallas"),
                                            (0.25, "sweep")])
def test_texture_engine_matches_jax(monkeypatch, volume, sampling, route):
    monkeypatch.setattr(sweep_pallas, "_frame_jit", functools.partial(
        sweep_pallas._frame_jit, interpret=True))
    jeng, teng = _pair(volume)
    for eng in (jeng, teng):
        eng.volumes[0].options.sampling_factor = sampling
    cam = jh.benchmark_camera(aspect=W / H)
    want = jeng.render(cam, W, H)
    got = teng.render(cam, W, H)
    assert jeng.last_renderer == teng.last_renderer == route
    assert teng.renderer_counts == jeng.renderer_counts
    _assert_frames_match(got, want)


def test_sweep_renderer_matches_jax(volume):
    jeng, teng = _pair(volume, renderer="sweep", texture_tf=False)
    cam = jh.benchmark_camera(aspect=2.0, azimuth=60.0)
    want = jeng.render(cam, 256, 128)
    got = teng.render(cam, 256, 128)
    assert jeng.last_renderer == teng.last_renderer == "sweep"
    assert teng.renderer_counts["sweep"] == 1
    _assert_frames_match(got, want)
    np.testing.assert_array_equal(got.num_volume_samples.numpy(),
                                  np.asarray(want.num_volume_samples))


def test_view_without_plan_renders_through_the_sweep(monkeypatch, volume):
    """A view the planner finds no w-grid for takes the XLA sweep (the
    JAX engine's route) instead of raising: the same frame as
    ``renderer="sweep"``."""
    _, teng = _pair(volume, texture_tf=False)
    _, ref = _pair(volume, renderer="sweep", texture_tf=False)
    monkeypatch.setattr(sweep_frame, "plan_from_stats",
                        lambda *a, **k: None)
    cam = jh.benchmark_camera(aspect=1.0, azimuth=120.0)
    got = teng.render(cam, 128, 128)
    assert teng.last_renderer == "sweep"
    assert teng.renderer_counts == {"pallas": 0, "sweep": 1, "marcher": 0}
    pose = next(p for k, p in teng.volumes[0]._sweep_cache.items()
                if isinstance(k, tuple) and k[0] == "pose")
    assert pose["view"] is not None and pose["plan"] is None
    want = ref.render(cam, 128, 128)
    assert float(want.color[..., 3].max()) > 0.3
    for a, b in ((got.color, want.color), (got.depth, want.depth),
                 (got.num_volume_samples, want.num_volume_samples)):
        assert bool((a == b).all())


@pytest.mark.parametrize("renderer", ["pallas", "sweep"])
def test_texture_tf_matches_closed_form(renderer):
    """tests/test_engine.py's check on the port: the baked texture agrees
    with the closed form up to the bake's u8 truncation and the 256-bin
    lookup, and the quantised path really ran."""
    n = 40
    eng = Engine(RenderOptions(skipping_type=SkippingType.DISTANCE),
                 renderer=renderer, device="cpu")
    v = from_array(sphere_shell_volume(n),
                   VolumeOptions(intensity_min=0.1, gradient_min=0.0,
                                 gradient_max=0.0), block_size=4,
                   device="cpu")
    v.set_scale((100.0 / n,) * 3)
    eng.add_volume(v)
    cam = orbit_camera(radius=220.0, azimuth_deg=30, elevation_deg=20,
                       aspect=1.0)
    a = eng.render(cam, 32, 32).color.numpy()
    eng.options.texture_tf = True
    b = eng.render(cam, 32, 32).color.numpy()
    assert eng.last_renderer == renderer
    assert a[..., 3].max() > 0.3
    assert np.abs(a - b).max() < 0.06
    assert np.abs(a - b).mean() < 5e-3
    assert not np.array_equal(a, b)


def test_texture_gap_at_quarter_scale_matches_jax():
    """The closed form against the texture at a larger scale (beetle at
    0.25, the CLI's TF and pose, 320x180, the XLA sweep on both sides):
    a few pixels differ by more than the 32x32 sphere's 0.06 in the JAX
    package too (max 0.0616 here), so a full-scale frame is held to the
    share of such pixels (under 1 %) and the mean; the port's gap is the
    JAX package's."""
    from vkvolume_tpu import cli as jcli
    from vkvolume_tpu import utils as jutils
    from vkvolume_tpu_torch import cli as tcli

    w, h = 320, 180
    args = ["--synth", "beetle", "--synth-scale", "0.25", "--width", str(w),
            "--height", str(h), "--renderer", "sweep"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jutils, "enable_compile_cache", lambda *a, **k: None)
        jeng, jvols = jcli.setup_engine(jcli.build_parser().parse_args(args))
    teng, tvols = tcli.setup_engine(tcli.build_parser().parse_args(
        args + ["--device", "cpu"]))
    cam = tcli.cli_camera(w, h)
    gaps = []
    for eng, vols in ((jeng, jvols), (teng, tvols)):
        for v in vols:
            eng.add_volume(v)
        a = np.asarray(eng.render(cam, w, h).color)
        eng.options.texture_tf = True
        b = np.asarray(eng.render(cam, w, h).color)
        gaps.append(np.abs(a - b).max(axis=-1))
    want, got = gaps
    assert (np.abs(got - want) > 2e-3).mean() <= 1e-3
    for gap in (want, got):
        assert 0.06 < gap.max() < 0.07
        assert (gap > 0.06).mean() < 0.01 and gap.mean() < 5e-3
