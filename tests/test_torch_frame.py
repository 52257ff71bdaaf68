"""The whole slice: the port's Engine (plain PyTorch on the CPU) against the
JAX package's Engine taking its Pallas frame in interpret mode, on the
same synthetic beetle, skip mode 3, block size 4, ERT on."""

import functools
import subprocess
import sys

import numpy as np
import pytest

from vkvolume_tpu.bench import harness as jh
from vkvolume_tpu.camera import pad_viewport
from vkvolume_tpu.options import Test as JTest
from vkvolume_tpu.render import sweep_pallas
from vkvolume_tpu_torch.bench import harness as th
from vkvolume_tpu_torch.options import Test as TTest
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def engines():
    jeng, jstats, vol, _ = jh.make_engine("beetle", 3, 4, scale=0.1,
                                          test=JTest.NONE, ert=True)
    teng, tstats, _, _ = th.make_engine("beetle", 3, 4, volume_u8=vol,
                                        test=TTest.NONE, ert=True,
                                        device="cpu")
    return jeng, jstats, teng, tstats


def test_maps_and_update_stats_match(engines):
    jeng, jstats, teng, tstats = engines
    np.testing.assert_array_equal(teng.volumes[0].dist_maps.numpy(),
                                  np.asarray(jeng.volumes[0].dist_maps))
    assert teng.volumes[0].dist_maps.shape[0] == 8
    assert tstats.occupied_voxel_percent == jstats.occupied_voxel_percent
    assert tstats.map_update_ms > 0


# 256x256 plans the main path's column-first warp (variant B), 512x256 the
# row-first one (variant A); both with the brick sweep.
@pytest.mark.parametrize("width,height,variant", [(256, 256, "B"),
                                                  (512, 256, "A")])
def test_frame_matches_jax_pallas_frame(monkeypatch, engines, width, height,
                                        variant):
    jeng, _, teng, _ = engines
    # Without interpret mode the JAX engine on the CPU would fall back to
    # the XLA sweep.
    monkeypatch.setattr(sweep_pallas, "_frame_jit", functools.partial(
        sweep_pallas._frame_jit, interpret=True))
    cam = jh.benchmark_camera(aspect=width / height)
    before = dict(jeng.renderer_counts)
    jout = jeng.render(cam, width, height)
    assert jeng.renderer_counts["pallas"] == before["pallas"] + 1
    assert jeng.renderer_counts["sweep"] == before["sweep"]
    assert jeng.last_renderer == "pallas"
    pose = [v for k, v in jeng.volumes[0]._sweep_cache.items()
            if isinstance(k, tuple) and k[0] == "pose"
            and k[1][3:5] == (height, width)]
    assert len(pose) == 1
    jplan = pose[0]["plan"]
    assert jplan["R_brick"] is not None and jplan["RECT_A"] is not None
    assert jplan["warp_variant"] == variant

    tout = teng.render(cam, width, height)
    assert teng.last_renderer == "pallas"
    want = np.asarray(jout.color)
    got = tout.color.numpy()
    assert got.shape == (height, width, 4)
    assert np.isfinite(got).all()
    assert (want[..., 3] > 0).mean() > 0.05          # real content
    # The JAX interpret warp is f32, the port's is u16-encoded, and ERT
    # threshold flips are possible: 2e-3 on >= 99.9 % of pixels.
    bad = (np.abs(got - want).max(axis=-1) > 2e-3).mean()
    assert bad <= 1e-3, bad
    assert abs(got[..., 3].mean() - want[..., 3].mean()) <= 1e-4
    img = teng.render_image(cam, width, height)
    assert img.shape == (height, width, 3) and img.dtype == np.uint8


def test_unaligned_size_matches_jax_padded_frame(monkeypatch, engines):
    """A size off the 8×128 tiling: the port pads the viewport and crops.
    The JAX engine pads only on an accelerator, so it renders the padded
    camera here and the test crops."""
    jeng, _, teng, _ = engines
    monkeypatch.setattr(sweep_pallas, "_frame_jit", functools.partial(
        sweep_pallas._frame_jit, interpret=True))
    w, h, wp, hp = 500, 260, 512, 264
    cam = jh.benchmark_camera(aspect=w / h)
    jout = jeng.render(pad_viewport(cam, w, h, wp, hp), wp, hp)
    assert jeng.last_renderer == "pallas"
    want = np.asarray(jout.color)[:h, :w]
    got = teng.render(cam, w, h).color.numpy()
    assert got.shape == (h, w, 4)
    assert (want[..., 3] > 0).mean() > 0.05
    bad = (np.abs(got - want).max(axis=-1) > 2e-3).mean()
    assert bad <= 1e-3, bad
    assert abs(got[..., 3].mean() - want[..., 3].mean()) <= 1e-4


def test_mixed_sign_view_falls_back_to_marcher(engines):
    """A wide-FOV camera inside the volume (mixed principal-axis signs)
    falls back to the per-ray marcher in both engines, and the frames
    agree: colour within 1e-5 and every counter equal on at least 99 % of
    the pixels (the rest are the JAX march's fused multiply-adds, see
    tests/test_torch_marcher.py). The ray entry / exit diagnostic frames
    render, as the JAX engine's do, from the ray setup."""
    from vkvolume_tpu_torch.camera import orbit_camera

    jeng, _, teng, _ = engines
    inside = orbit_camera(radius=10.0, azimuth_deg=45, elevation_deg=35,
                          fovy_deg=120.0, aspect=1.0)
    before = teng.renderer_counts["marcher"]
    got = teng.render(inside, 64, 64)
    want = jeng.render(inside, 64, 64)
    assert teng.last_renderer == jeng.last_renderer == "marcher"
    assert teng.renderer_counts["marcher"] == before + 1
    w = np.asarray(want.color)
    assert (w[..., 3] > 0).mean() > 0.5
    bad = np.abs(got.color.numpy() - w).max(-1) > 1e-5
    for k in ("num_volume_samples", "num_distance_samples",
              "num_empty_samples"):
        bad |= getattr(got, k).numpy() != np.asarray(getattr(want, k))
    assert bad.mean() <= 1e-2, bad.mean()
    cam = jh.benchmark_camera(aspect=2.0)
    for test in (TTest.RAY_ENTRY, TTest.RAY_EXIT):
        teng.options.test = test
        jeng.options.test = JTest(int(test))
        try:
            got = teng.render(cam, 256, 128)
            want = jeng.render(cam, 256, 128)
        finally:
            teng.options.test = TTest.NONE
            jeng.options.test = JTest.NONE
        assert teng.last_renderer == jeng.last_renderer == "sweep"
        w = np.asarray(want.color)
        assert (w[..., 3] > 0).mean() > 0.05
        np.testing.assert_allclose(got.color.numpy(), w, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(got.depth.numpy(),
                                      np.asarray(want.depth))


def test_port_never_imports_jax():
    code = ("import sys, vkvolume_tpu_torch, vkvolume_tpu_torch.engine, "
            "vkvolume_tpu_torch.bench, vkvolume_tpu_torch.render.sweep_frame, "
            "vkvolume_tpu_torch.render.sweep, "
            "vkvolume_tpu_torch.render.marcher, "
            "vkvolume_tpu_torch.render.sampling, "
            "vkvolume_tpu_torch.render.forward, "
            "vkvolume_tpu_torch.bench.profile_frame, "
            "vkvolume_tpu_torch.bench.parity, "
            "vkvolume_tpu_torch.bench.ess_ratio, "
            "vkvolume_tpu_torch.bench.orbit, "
            "vkvolume_tpu_torch.bench.session, "
            "vkvolume_tpu_torch.interop, vkvolume_tpu_torch.cli, "
            "vkvolume_tpu_torch.io, vkvolume_tpu_torch.io.native, "
            "vkvolume_tpu_torch.utils.image, vkvolume_tpu_torch.viewer, "
            "vkvolume_tpu_torch.engine.accel_cache, "
            "vkvolume_tpu_torch.parallel; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert 'PIL' not in sys.modules, 'PIL imported'; "
            "assert not any(m.startswith('vkvolume_tpu.') or m == "
            "'vkvolume_tpu' for m in sys.modules)")
    subprocess.run([sys.executable, "-c", code], check=True)
