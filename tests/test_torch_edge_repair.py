"""Edge repair and ``set_skipping_type``: the port's Engine (plain PyTorch
on the CPU) against the JAX engine, on ``tests/test_engine.py``'s setup
(a 48³ spherical shell, isotropic distance map, intensity TF, orbit
camera at azimuth 30).

Both engines find the same suspects (``last_repair_px`` equal: 424 at
64×64 through the XLA sweep, ``renderer="sweep"``; 1011 at 128×128
through the w-grid frame, ``renderer="pallas"``, JAX's Pallas frame in
interpret mode). No suspect-mask term sits within float error of its
threshold in these frames, so there is no pixel to set apart, though the
port's warp is u16-encoded where JAX's interpret warp is f32 (the frames
before the repair differ by at most 4.3e-6). The repaired frames agree
within 1e-5 in colour and depth on at least 99.8 % of the pixels (the
marchers' counter flips, ``tests/test_torch_marcher.py``). Each repaired
pixel is the port's full-frame marcher's, bit for bit.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vkvolume_tpu.camera import orbit_camera as j_orbit_camera
from vkvolume_tpu.engine import Engine as JEngine
from vkvolume_tpu.engine import from_array as j_from_array
from vkvolume_tpu.options import RenderOptions as JRenderOptions
from vkvolume_tpu.options import SkippingType as JSkip
from vkvolume_tpu.options import VolumeOptions as JVolumeOptions
from vkvolume_tpu.render import sweep_pallas
from vkvolume_tpu_torch.camera import orbit_camera
from vkvolume_tpu_torch.engine import Engine, from_array
from vkvolume_tpu_torch.options import (RenderOptions, SkippingType,
                                        VolumeOptions)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

from util import sphere_shell_volume

N = 48
CAM = dict(radius=220.0, azimuth_deg=30, elevation_deg=20, aspect=1.0)


def _engines(renderer, skipping=JSkip.DISTANCE):
    vol = sphere_shell_volume(N)
    jeng = JEngine(JRenderOptions(skipping_type=skipping), renderer=renderer)
    jv = j_from_array(vol, JVolumeOptions(intensity_min=0.1, gradient_min=0.0,
                                          gradient_max=0.0), block_size=4)
    jv.set_scale((100.0 / N,) * 3)
    jeng.add_volume(jv)
    teng = Engine(RenderOptions(skipping_type=SkippingType(int(skipping))),
                  renderer=renderer, device="cpu")
    tv = from_array(vol, VolumeOptions(intensity_min=0.1, gradient_min=0.0,
                                       gradient_max=0.0), block_size=4,
                    device="cpu")
    tv.set_scale((100.0 / N,) * 3)
    teng.add_volume(tv)
    return jeng, teng


@pytest.fixture(scope="module")
def marcher_frames():
    """The port's full-frame marcher at the two sizes of the cases."""
    teng = _engines("marcher")[1]
    return {n: teng.render(orbit_camera(**CAM), n, n) for n in (64, 128)}


def _gap(color, ref):
    return np.abs(color - ref).max(-1)


def _repair(monkeypatch, renderer, size):
    if renderer == "pallas":
        monkeypatch.setattr(sweep_pallas, "_frame_jit", functools.partial(
            sweep_pallas._frame_jit, interpret=True))
    jeng, teng = _engines(renderer)
    jcam, cam = j_orbit_camera(**CAM), orbit_camera(**CAM)
    plain = teng.render(cam, size, size)
    for e in (jeng, teng):
        e.options.edge_repair = True
    jout = jeng.render(jcam, size, size)
    tout = teng.render(cam, size, size)
    assert teng.last_renderer == jeng.last_renderer == renderer
    return jeng, teng, jout, tout, plain


@pytest.mark.parametrize("renderer,size", [("sweep", 64), ("pallas", 128)])
def test_edge_repair_matches_jax_and_closes_the_gap(monkeypatch,
                                                    marcher_frames,
                                                    renderer, size):
    jeng, teng, jout, tout, plain = _repair(monkeypatch, renderer, size)
    n_found, K = teng.last_repair_px
    jn, jK = int(jeng.last_repair_px[0]), int(jeng.last_repair_px[1])
    assert K == jK == 2048 and 0 < n_found <= K
    got = tout.color.numpy()
    want = np.asarray(jout.color)
    assert n_found == jn
    bad = ((_gap(got, want) > 1e-5)
           | (np.abs(tout.depth.numpy() - np.asarray(jout.depth)) > 1e-5))
    assert bad.mean() <= 2e-3, bad.mean()
    ref = marcher_frames[size]
    # The repaired pixels are the marcher's, bit for bit.
    mask = (tout.color != plain.color).any(-1)
    assert mask.any()
    assert torch.equal(tout.color[mask], ref.color[mask])
    assert torch.equal(tout.depth[mask], ref.depth[mask])
    # Strictly closer to the marcher, and no pixel further from it.
    d_plain = _gap(plain.color.numpy(), ref.color.numpy())
    d_rep = _gap(got, ref.color.numpy())
    assert d_rep.max() <= d_plain.max() + 1e-6
    assert (d_rep > 2 / 255).sum() < (d_plain > 2 / 255).sum()
    assert (d_rep <= d_plain + 1e-6).all()


def test_edge_repair_under_the_scene_matches_jax():
    """Edge repair of a depth-clipped frame (``render_with_scene`` with the
    demo hall): the repair marches the depth-clamped rays."""
    from vkvolume_tpu.render.forward import sponza_lite as j_sponza_lite
    from vkvolume_tpu_torch.render.forward import sponza_lite

    jeng, teng = _engines("sweep")
    for e in (jeng, teng):
        e.options.edge_repair = True
    jout = jeng.render_with_scene(j_orbit_camera(**CAM), 64, 64,
                                  j_sponza_lite())
    tout = teng.render_with_scene(orbit_camera(**CAM), 64, 64, sponza_lite())
    assert teng.last_renderer == jeng.last_renderer == "sweep"
    n_found, K = teng.last_repair_px
    assert (n_found, K) == (int(jeng.last_repair_px[0]),
                            int(jeng.last_repair_px[1]))
    assert 0 < n_found <= K
    bad = ((_gap(tout.color.numpy(), np.asarray(jout.color)) > 1e-5)
           | (np.abs(tout.depth.numpy() - np.asarray(jout.depth)) > 1e-5))
    assert bad.mean() <= 2e-3, bad.mean()


def test_probe_mode_counts_without_marching():
    """``repair_budget <= 0``: the suspects are counted, the frame is the
    sweep's."""
    jeng, teng = _engines("sweep")
    jcam, cam = j_orbit_camera(**CAM), orbit_camera(**CAM)
    plain = teng.render(cam, 64, 64)
    for e in (jeng, teng):
        e.options.edge_repair = True
        e.options.repair_budget = 0.0
    jeng.render(jcam, 64, 64)
    out = teng.render(cam, 64, 64)
    assert teng.last_repair_px == (int(jeng.last_repair_px[0]), 0)
    assert teng.last_repair_px[0] > 0
    assert torch.equal(out.color, plain.color)


def test_budget_caps_the_repair():
    """A budget smaller than the suspects: K rays are re-marched (the
    first K suspects in raster order), the rest keep the sweep's pixels."""
    teng = _engines("sweep")[1]
    cam = orbit_camera(**CAM)
    teng.options.edge_repair = True
    teng.options.repair_budget = 0.0
    teng.render(cam, 288, 288)
    n_found = teng.last_repair_px[0]
    teng.options.repair_budget = 1e-3      # K = 2048 < n_found
    teng.render(cam, 288, 288)
    assert n_found > 2048
    assert teng.last_repair_px == (n_found, 2048)


@pytest.mark.parametrize("renderer", ["sweep", "marcher"])
def test_set_skipping_type_rebuilds_maps_like_jax(renderer):
    jeng, teng = _engines(renderer)
    jcam, cam = j_orbit_camera(**CAM), orbit_camera(**CAM)
    before = teng.volumes[0]._maps_version
    for st in (JSkip.ANISOTROPIC_DISTANCE, JSkip.BLOCK):
        jeng.set_skipping_type(st)
        teng.set_skipping_type(SkippingType(int(st)))
        assert teng.options.skipping_type == SkippingType(int(st))
        np.testing.assert_array_equal(teng.volumes[0].dist_maps.numpy(),
                                      np.asarray(jeng.volumes[0].dist_maps))
    assert teng.volumes[0].dist_maps.shape[0] == 1
    assert teng.volumes[0]._maps_version == before + 2
    teng.set_skipping_type(SkippingType.BLOCK)      # no change: no rebuild
    assert teng.volumes[0]._maps_version == before + 2
    jout = jeng.render(jcam, 32, 32)
    tout = teng.render(cam, 32, 32)
    np.testing.assert_allclose(tout.color.numpy(), np.asarray(jout.color),
                               rtol=0, atol=1e-5)
