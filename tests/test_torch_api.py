"""The port's public functions that close its surface against the JAX
package's, each against its JAX counterpart on the same seeded inputs:
``tf.get_color``, ``accel.gradient.gradient_at_points``,
``bench.write_reference_format``, ``render.sweep.principal_axis`` /
``mixed_principal_signs``, the XLA sweep's ``skipping=`` and ``chunk=``,
and the default ``Engine``.

Tolerances: ``get_color``, the axis and the sign test exact; the written
files byte-equal; ``gradient_at_points`` within 1e-6 (the tolerance of
``gradient_on_the_fly`` in ``tests/test_torch_marcher.py``); the sweep as
in ``tests/test_torch_sweep_xla.py`` (sample counts and coverage exact,
colour and depth within 1e-5), and exact between the port's own ``chunk``
values; the default engine's frame within the marcher's flip bound of
``tests/test_torch_marcher.py`` (``_hold_to_jax``)."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vkvolume_tpu.accel import distance_pallas as jpal
from vkvolume_tpu.accel import gradient as jgradient
from vkvolume_tpu.bench import DATASETS as J_DATASETS
from vkvolume_tpu.bench import write_reference_format as j_write
from vkvolume_tpu.camera import orbit_camera as j_orbit_camera
from vkvolume_tpu.engine import Engine as JEngine
from vkvolume_tpu.engine import VolumeOptions as JVolumeOptions
from vkvolume_tpu.engine import from_array as j_from_array
from vkvolume_tpu.options import RenderOptions as JRenderOptions
from vkvolume_tpu.options import SkippingType as JSkip
from vkvolume_tpu.render import sweep as jsweep
from vkvolume_tpu.render.ray_setup import RaySetup as JRaySetup
from vkvolume_tpu.render.ray_setup import make_rays as j_make_rays
from vkvolume_tpu.render.ray_setup import make_uniforms as j_make_uniforms
from vkvolume_tpu.tf import get_color as j_get_color
from vkvolume_tpu.tf import tf_params as j_tf_params
from vkvolume_tpu_torch import interop
from vkvolume_tpu_torch.accel import distance_cuda
from vkvolume_tpu_torch.accel.gradient import gradient_at_points
from vkvolume_tpu_torch.bench import DATASETS, write_reference_format
from vkvolume_tpu_torch.camera import orbit_camera
from vkvolume_tpu_torch.engine import Engine, VolumeOptions, from_array, \
    from_file
from vkvolume_tpu_torch.options import Test as TTest
from vkvolume_tpu_torch.render import sweep as tsweep
from vkvolume_tpu_torch.render.ray_setup import make_rays
from vkvolume_tpu_torch.tf import get_color, tf_params

from test_torch_marcher import _hold_to_jax
from test_torch_sweep_xla import (_port_tf, _setup, engines,  # noqa: F401
                                  volume)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)
from util import random_blob_volume

TFS = {"intensity": dict(intensity_min=0.1, intensity_max=0.7,
                         gradient_min=0.0, gradient_max=0.0),
       "gradient": dict(intensity_min=0.2, intensity_max=0.9,
                        gradient_min=0.05, gradient_max=0.4)}


# ---- tf.get_color -----------------------------------------------------------

@pytest.mark.parametrize("tf", sorted(TFS))
def test_get_color_matches_jax(tf):
    """On every (intensity, gradient) pair of a 257 × 257 grid over [0, 1]
    and a band past each end."""
    kw = dict(sampling_factor=1.0, voxel_alpha_factor=1.0,
              grad_magnitude_modifier=1.0, **TFS[tf])
    x = np.linspace(-0.1, 1.1, 257, dtype=np.float32)
    i, g = np.meshgrid(x, x, indexing="ij")
    want = np.asarray(j_get_color(j_tf_params(**kw), jnp.asarray(i),
                                  jnp.asarray(g)))
    got = get_color(tf_params(**kw), torch.from_numpy(i),
                    torch.from_numpy(g)).numpy()
    assert got.shape == want.shape == (257, 257, 4)
    np.testing.assert_array_equal(got, want)
    assert tf_params(**kw).use_gradient == (tf == "gradient")
    assert 0.1 < (got[..., 3] > 0).mean() < 0.9


# ---- accel.gradient.gradient_at_points ----------------------------------------

@pytest.mark.parametrize("modifier", [1.0, 1.5])
def test_gradient_at_points_matches_jax(modifier):
    rng = np.random.default_rng(5)
    vol = random_blob_volume(rng, (20, 18, 22), n_blobs=5)
    pos = rng.uniform(-0.1, 1.1, (500, 3)).astype(np.float32)
    want = np.asarray(jgradient.gradient_at_points(
        jnp.asarray(vol), jnp.asarray(pos), jnp.float32(modifier)))
    got = gradient_at_points(torch.tensor(vol), torch.tensor(pos), modifier)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert (want > 0).mean() > 0.2


# ---- accel.distance_cuda: the wrappers against the Pallas functions ----------

def test_distance_wrappers_match_the_jax_schedules():
    """The wrappers on CPU tensors, bit-exact to the Pallas functions
    (interpret mode) at the schedules the JAX callers use: the isotropic
    map's (scan 0, relax (0,)) and the octant maps' at cap 63."""
    rng = np.random.default_rng(8)
    occ = np.where(rng.random((9, 11, 13)) < 0.05, 0, 255).astype(np.uint8)
    occ_t = torch.from_numpy(occ)
    xy = jpal.scan_and_relax(jnp.asarray(occ), 0, (0,), interpret=True)[0]
    got = distance_cuda.scan_and_relax(occ_t)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(xy))
    want = jpal.relax_z_direct(xy, (0,), interpret=True)[0]
    np.testing.assert_array_equal(
        distance_cuda.relax_z_direct(got[0])[0].numpy(), np.asarray(want))
    xys = distance_cuda.scan_and_relax_multi(occ_t, 63)
    want = jpal.scan_and_relax_multi(jnp.asarray(occ), (1, -1), (1, -1),
                                     interpret=True, cap=63)
    np.testing.assert_array_equal(xys.numpy(),
                                  np.stack([np.asarray(a) for a in want]))
    want = jpal.relax_z_direct_multi(list(want), (1, -1), interpret=True)
    np.testing.assert_array_equal(
        distance_cuda.relax_z_direct_multi(xys).numpy(),
        np.stack([np.asarray(a) for a in want]))


# ---- bench.write_reference_format ---------------------------------------------

@pytest.mark.parametrize("key", ["beetle", "snake"])
def test_write_reference_format_matches_jax(tmp_path, key):
    """The beetle's ``.uint16`` file and the snake's ``.uint8``: data and
    header byte-equal to the JAX writer's, read back to the same u8."""
    ext = DATASETS[key].filename.rsplit(".", 1)[1]
    assert ext == ("uint16" if key == "beetle" else "uint8")
    vol = np.random.default_rng(6).integers(0, 256, (7, 9, 11),
                                            dtype=np.uint8)
    vol[0, 0, :3] = (0, 1, 255)
    mine, theirs = str(tmp_path / f"t.{ext}"), str(tmp_path / f"j.{ext}")
    write_reference_format(DATASETS[key], vol, mine)
    j_write(J_DATASETS[key], vol, theirs)
    for suffix in ("", ".header"):
        with open(mine + suffix, "rb") as a, open(theirs + suffix, "rb") as b:
            assert a.read() == b.read(), suffix
    assert os.path.getsize(mine) == vol.size * (2 if ext == "uint16" else 1)
    back = from_file(mine, device="cpu")
    assert back.density.dtype == torch.uint8
    np.testing.assert_array_equal(back.density.numpy(), vol)


# ---- render.sweep.principal_axis / mixed_principal_signs -----------------------

def _random_rays(seed: int, n_valid: float):
    """A seeded (12, 16) ray set: directions drawn around a random axis,
    ``n_valid`` of the pixels valid."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(12, 16, 3)).astype(np.float32)
    d[..., rng.integers(3)] += np.float32(rng.uniform(0.0, 2.0))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    valid = rng.uniform(size=(12, 16)) < n_valid
    z = np.zeros((12, 16), np.float32)
    return dict(ray_dir=d, valid=valid, depth_init=z, entry=d, exit=d,
                ray_distance=z, entry_clip_zw=np.zeros((12, 16, 2),
                                                       np.float32))


def _view_rays(radius: float, fovy: float, azimuth: float):
    """The JAX ``make_rays`` of a 24×32 view of a 100-wide volume."""
    vol = np.zeros((8, 8, 8), np.uint8)
    v = j_from_array(vol, block_size=4)
    v.set_scale((100.0 / 8,) * 3)
    cam = j_orbit_camera(radius=radius, azimuth_deg=azimuth,
                         elevation_deg=35.0, fovy_deg=fovy)
    u = j_make_uniforms(cam, v.node_transform, v.image_transform, 0.0,
                        np.asarray(v.effective_block_size_xyz, np.float32))
    rays = j_make_rays(u, 24, 32)
    return {f.name: np.asarray(getattr(rays, f.name))
            for f in dataclasses.fields(rays)}


RAY_SETS = {
    **{f"random-{s}": (lambda s=s: _random_rays(s, 0.7)) for s in range(4)},
    "sparse": lambda: _random_rays(9, 0.03),
    "no-valid-ray": lambda: _random_rays(10, 0.0),
    "outside": lambda: _view_rays(190.0, 45.0, 30.0),
    "inside-mixed": lambda: _view_rays(10.0, 120.0, 45.0),
}


@pytest.mark.parametrize("name", sorted(RAY_SETS))
def test_principal_axis_and_mixed_signs_match_jax(name):
    fields = RAY_SETS[name]()
    jrays = JRaySetup(**{k: jnp.asarray(a) for k, a in fields.items()})
    trays = interop.rays_from_numpy(fields)
    p = tsweep.principal_axis(trays)
    assert p == jsweep.principal_axis(jrays)
    mixed = [tsweep.mixed_principal_signs(trays, q) for q in range(3)]
    assert mixed == [jsweep.mixed_principal_signs(jrays, q)
                     for q in range(3)]
    if name == "no-valid-ray":
        assert p == 2 and mixed == [False] * 3
    if name == "inside-mixed":
        assert mixed[p]
    if name == "outside":
        assert not mixed[p]


# ---- render.sweep.sweep: skipping= and chunk= ---------------------------------

def _port_sweep(s, occupancy=True, **kw):
    """The port's sweep on ``_setup``'s inputs (ERT on)."""
    t = lambda a: interop.maps_from_numpy(np.asarray(a))
    return tsweep.sweep(
        t(s["vol_t"]), t(s["grad_t"]), t(s["occ_t"]) if occupancy else None,
        _port_tf(s["tf"]),
        interop.rays_from_numpy({k: np.asarray(a)
                                 for k, a in vars(s["rays"]).items()}),
        interop.uniforms_from_numpy(vars(s["u"])), s["pvm"], p_axis=s["p"],
        oversample=s["oversample"], test=TTest.NONE, **kw)


def _sweeps(s, *, skipping=True, chunk=16):
    """The JAX and the port's sweep on the same inputs, the skip map given
    to both."""
    kw = dict(skipping=skipping, chunk=chunk)
    ref = jsweep.sweep(s["vol_t"], s["grad_t"], s["occ_t"], s["tf"],
                       s["rays"], s["u"], jnp.asarray(s["pvm"]),
                       p_axis=s["p"], oversample=s["oversample"], **kw)
    return ref, _port_sweep(s, **kw)


def _hold_sweep(ref, got):
    """``tests/test_torch_sweep_xla.py``'s tolerances."""
    want_c, got_c = np.asarray(ref.color), got.color.numpy()
    assert want_c[..., 3].max() > 0.3
    np.testing.assert_array_equal(got_c[..., 3] > 0, want_c[..., 3] > 0)
    np.testing.assert_array_equal(got.num_volume_samples.numpy(),
                                  np.asarray(ref.num_volume_samples))
    np.testing.assert_allclose(got_c, want_c, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.depth.numpy(), np.asarray(ref.depth),
                               rtol=0, atol=1e-5)
    assert got.iterations == int(ref.iterations)


def test_sweep_skipping_false_matches_jax(engines):  # noqa: F811
    """``skipping=False`` samples every slab although a map is given."""
    s = _setup(engines["gradient"], "+z")
    ref, got = _sweeps(s, skipping=False)
    _hold_sweep(ref, got)
    _, skipped = _sweeps(s)
    assert int(got.num_volume_samples.sum()) > int(
        skipped.num_volume_samples.sum())
    # The same frame as no map at all.
    none = _port_sweep(s, occupancy=False)
    for k in ("color", "depth", "num_volume_samples"):
        torch.testing.assert_close(getattr(got, k), getattr(none, k),
                                   rtol=0, atol=0)


@pytest.fixture(scope="module")
def opaque(volume):  # noqa: F811
    """A JAX engine whose gradient TF (intensity 0.05-0.15, gradient
    0-0.05) saturates many rays: ERT takes them out mid-frame."""
    eng = JEngine(JRenderOptions(skipping_type=JSkip.DISTANCE))
    v = j_from_array(volume, JVolumeOptions(
        intensity_min=0.05, intensity_max=0.15, gradient_min=0.0,
        gradient_max=0.05), block_size=4)
    v.set_scale((100.0 / max(volume.shape),) * 3)
    eng.add_volume(v)
    return eng


def test_sweep_chunk_changes_no_output(opaque):
    """ERT on, a gradient TF: every output the same at chunk 1, 7, 16
    and 64, and each equal to the JAX sweep's at that chunk."""
    s = _setup(opaque, "-x")
    outs = {}
    for chunk in (1, 7, 16, 64):
        ref, got = _sweeps(s, chunk=chunk)
        _hold_sweep(ref, got)
        outs[chunk] = got
    for chunk in (1, 7, 64):
        for f in dataclasses.fields(outs[16]):
            a, b = getattr(outs[chunk], f.name), getattr(outs[16], f.name)
            if isinstance(a, torch.Tensor):
                torch.testing.assert_close(a, b, rtol=0, atol=0)
            else:
                assert a == b, f.name
    assert (outs[16].color[..., 3] == 1.0).sum() > 20   # ERT took rays out
    with pytest.raises(ValueError, match="chunk"):
        _port_sweep(s, chunk=0)


# ---- the default Engine ---------------------------------------------------------

def test_default_engine_renders_through_the_marcher_as_jax():
    vol = random_blob_volume(np.random.default_rng(7), (24, 22, 26),
                             n_blobs=4)
    kw = dict(intensity_min=0.15, gradient_min=0.0, gradient_max=0.0)
    jeng, teng = JEngine(), Engine(device="cpu")
    assert jeng.renderer == teng.renderer == "marcher"
    jv = j_from_array(vol, JVolumeOptions(**kw), block_size=4)
    tv = from_array(vol, VolumeOptions(**kw), block_size=4, device="cpu")
    for eng, v in ((jeng, jv), (teng, tv)):
        v.set_scale((100.0 / max(vol.shape),) * 3)
        eng.add_volume(v)
    w, h = 32, 24
    jcam = j_orbit_camera(radius=190.0, azimuth_deg=30.0, elevation_deg=20.0)
    tcam = orbit_camera(radius=190.0, azimuth_deg=30.0, elevation_deg=20.0)
    jout, tout = jeng.render(jcam, w, h), teng.render(tcam, w, h)
    assert jeng.last_renderer == teng.last_renderer == "marcher"
    assert teng.renderer_counts["marcher"] == 1
    valid = make_rays(teng._uniforms(tcam, tv), h, w, "cpu").valid.numpy()
    assert valid.sum() > 100
    _hold_to_jax(jout, tout, valid)
    assert (tout.color.numpy()[..., 3] > 0).mean() > 0.05
