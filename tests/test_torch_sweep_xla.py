"""The XLA sweep: the port's ``render/sweep.py:sweep`` (plain PyTorch) against
the JAX package's ``vkvolume_tpu.render.sweep.sweep`` on identical rays
(the JAX ``make_rays`` carried across by ``interop``), volume, gradient and
isotropic distance maps (synthetic beetle at scale 0.05, skipmode 2), TF
parameters and baked TF texture. Cases: each TF (intensity, gradient,
texture) with ERT on and off; no skip map; the ``Test`` diagnostics; a
view along each principal axis from both sides (both slab orders).
Sample counts and the
covered mask are exact; colour and depth within 1e-5. Also the port's
full ray setup (``make_rays``' directions through ``rays_from_dirs``, the
engine's XLA-sweep rays) against the JAX ``make_rays``."""

import jax.numpy as jnp
import numpy as np
import pytest

from vkvolume_tpu.bench.datasets import DATASETS, synthesize
from vkvolume_tpu.camera import orbit_camera
from vkvolume_tpu.engine import Engine as JEngine
from vkvolume_tpu.engine import from_array as j_from_array
from vkvolume_tpu.options import RenderOptions as JRenderOptions
from vkvolume_tpu.options import SkippingType as JSkip
from vkvolume_tpu.options import Test as JTest
from vkvolume_tpu.options import VolumeOptions as JVolumeOptions
from vkvolume_tpu.render import sweep as jsweep
from vkvolume_tpu.render.ray_setup import make_rays as j_make_rays
from vkvolume_tpu.render.ray_setup import make_uniforms as j_make_uniforms
from vkvolume_tpu_torch import interop
from vkvolume_tpu_torch.options import Test as TTest
from vkvolume_tpu_torch.render import sweep as tsweep
from vkvolume_tpu_torch.render.frustum import rays_from_dirs
from vkvolume_tpu_torch.render.ray_setup import make_rays
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SIZE = 64
# (azimuth, elevation) → a view along x, y or z from either side.
VIEWS = {"+z": (0.0, 10.0), "-z": (180.0, 10.0), "+x": (90.0, 10.0),
         "-x": (270.0, 10.0), "+y": (20.0, 80.0), "-y": (20.0, -80.0)}
TFS = {"intensity": dict(intensity_min=0.1, gradient_min=0.0,
                         gradient_max=0.0),
       "gradient": dict(intensity_min=0.1, gradient_min=0.0,
                        gradient_max=0.2)}


@pytest.fixture(scope="module")
def volume():
    return synthesize(DATASETS["beetle"], seed=0, scale=0.05)


@pytest.fixture(scope="module")
def engines(volume):
    """A JAX engine per TF: the isotropic distance map and, for the
    gradient TF, the gradient map and the baked texture."""
    out = {}
    for name, kw in TFS.items():
        eng = JEngine(JRenderOptions(skipping_type=JSkip.DISTANCE))
        v = j_from_array(volume, JVolumeOptions(**kw), block_size=4)
        v.set_scale((100.0 / max(volume.shape),) * 3)
        eng.add_volume(v)
        out[name] = eng
    return out


def _camera(view):
    az, el = VIEWS[view]
    return orbit_camera(radius=190.0, azimuth_deg=az, elevation_deg=el)


def _setup(eng, view):
    v = eng.volumes[0]
    cam = _camera(view)
    u = j_make_uniforms(cam, v.node_transform, v.image_transform,
                        eng.options.clip_distance,
                        np.asarray(v.effective_block_size_xyz, np.float32))
    rays = j_make_rays(u, SIZE, SIZE)
    p = jsweep.principal_axis(rays)
    assert not jsweep.mixed_principal_signs(rays, p)
    vol_t = jsweep.transpose_for_axis(v.density, p)
    tf = eng._tf(v)
    pvm = (cam.proj.astype(np.float64) @ cam.view.astype(np.float64)
           @ v.model_matrix).astype(np.float32)
    return dict(u=u, rays=rays, p=p, vol_t=vol_t,
                grad_t=jsweep.transpose_for_axis(v.gradient, p),
                occ_t=jsweep.transpose_for_axis(v.dist_maps[0], p), tf=tf,
                tex=v.tf_texture, pvm=pvm,
                oversample=eng._slab_oversample(v, vol_t.shape, tf))


def _port_tf(tf):
    return interop.tf_from_numpy({k: np.asarray(getattr(tf, k)) for k in (
        "sampling_factor", "voxel_alpha_factor", "grad_magnitude_modifier",
        "intensity_min", "intensity_range_inv", "gradient_min",
        "gradient_range_inv", "use_gradient")})


def _compare(s, texture, ert, test, skip=True):
    t = lambda a: interop.maps_from_numpy(np.asarray(a))
    kw = dict(p_axis=s["p"], early_ray_termination=ert,
              oversample=s["oversample"])
    ref = jsweep.sweep(s["vol_t"], s["grad_t"], s["occ_t"], s["tf"],
                       s["rays"], s["u"], jnp.asarray(s["pvm"]),
                       jnp.asarray(s["tex"]) if texture else None,
                       test=JTest(int(test)), skipping=skip, **kw)
    got = tsweep.sweep(
        t(s["vol_t"]), t(s["grad_t"]), t(s["occ_t"]) if skip else None,
        _port_tf(s["tf"]),
        interop.rays_from_numpy({k: np.asarray(a)
                                 for k, a in vars(s["rays"]).items()}),
        interop.uniforms_from_numpy(vars(s["u"])), s["pvm"],
        interop.texture_from_numpy(s["tex"]) if texture else None,
        test=test, **kw)
    want_c = np.asarray(ref.color)
    got_c = got.color.numpy()
    assert got_c.shape == (SIZE, SIZE, 4)
    assert want_c[..., 3].max() > (0.9 if test != TTest.NONE else 0.3)
    np.testing.assert_array_equal(got_c[..., 3] > 0, want_c[..., 3] > 0)
    np.testing.assert_array_equal(got.num_volume_samples.numpy(),
                                  np.asarray(ref.num_volume_samples))
    np.testing.assert_allclose(got_c, want_c, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.depth.numpy(), np.asarray(ref.depth),
                               rtol=0, atol=1e-5)
    assert got.iterations == int(ref.iterations)
    return got, ref


@pytest.mark.parametrize("tf,ert", [(tf, ert) for tf in
                                    ("intensity", "gradient", "texture")
                                    for ert in (True, False)])
def test_sweep_tf_and_ert_match_jax(engines, tf, ert):
    s = _setup(engines["intensity" if tf == "intensity" else "gradient"],
               "+z")
    got, _ = _compare(s, tf == "texture", ert, TTest.NONE)
    assert int(got.num_volume_samples.sum()) > 0


def test_sweep_without_skip_map_matches_jax(engines):
    """No occupancy map: every slab sampled (the JAX ``skipping=False``)."""
    s = _setup(engines["gradient"], "+z")
    got, _ = _compare(s, True, True, TTest.NONE, skip=False)
    with_map, _ = _compare(s, True, True, TTest.NONE)
    assert int(got.num_volume_samples.sum()) > int(
        with_map.num_volume_samples.sum())


@pytest.mark.parametrize("view", sorted(VIEWS))
def test_sweep_views_match_jax(engines, view):
    """A view along each principal axis, both slab orders (texture TF)."""
    s = _setup(engines["gradient"], view)
    axis = "xyz"[s["p"]]
    d_p = np.asarray(s["rays"].ray_dir)[..., s["p"]][np.asarray(
        s["rays"].valid)]
    assert view == ("+" if d_p.mean() < 0 else "-") + axis
    _compare(s, True, True, TTest.NONE)


@pytest.mark.parametrize("test", [TTest.NUM_TEXTURE_SAMPLES,
                                  TTest.RAY_ENTRY, TTest.RAY_EXIT])
def test_sweep_diagnostics_match_jax(engines, test):
    s = _setup(engines["gradient"], "-x")
    got, ref = _compare(s, True, False, test)
    if test != TTest.NUM_TEXTURE_SAMPLES:
        assert got.iterations == 0
        np.testing.assert_array_equal(got.depth.numpy(),
                                      np.asarray(ref.depth))


@pytest.mark.parametrize("view", ["+z", "-x"])
def test_make_rays_full_matches_jax(engines, view):
    s = _setup(engines["gradient"], view)
    want = s["rays"]
    tu = interop.uniforms_from_numpy(vars(s["u"]))
    plain = make_rays(tu, SIZE, SIZE)
    got = rays_from_dirs(tu, plain.ray_dir)
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(plain.valid.numpy(), valid)
    assert valid.mean() > 0.2
    for name in ("ray_dir", "entry", "exit"):
        np.testing.assert_allclose(getattr(got, name).numpy()[valid],
                                   np.asarray(getattr(want, name))[valid],
                                   rtol=0, atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(got.depth_init.numpy(),
                                  np.asarray(want.depth_init))
    assert plain.entry is None
