"""The per-ray marcher: the port's ``render/marcher.py:march`` (plain
PyTorch on the CPU) against the JAX package's ``render/marcher_xla.march``
and the scalar frag-shader oracle (``tests/scalar_reference.march_ray``),
on the setups of ``tests/test_render.py`` (JAX's ray setup, maps, TF and
gradient carried across by ``interop``); and ``render/sampling.py``
against the JAX sampling functions.

Tolerances. Against the scalar oracle (strict float32 numpy, the form the
unfused port computes): every counter exact on every covered pixel, colour
within 2e-4 (the oracle's trilinear sums eight weighted taps where the
marcher lerps). Against JAX: XLA's CPU compiler fuses multiply-adds in
the jitted march (``entry + i*step``, the map-cell coordinate), so a ray
can cross a map cell one ulp apart and take one skip event more or fewer
(``tests/test_render.py`` allows the JAX march ±2 events against the
oracle for the same reason). Counters differ on at most 2 % of the
covered pixels (at least 2 pixels allowed: the small cases cover 29-150)
and by at most 2 events; colour is within 1e-5 where the counters agree
and 0.05 where they do not; the trip count within 2. Where the oracle
runs too, it holds the port exact at those pixels: the flips are JAX's.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vkvolume_tpu.accel import anisotropic_distance, isotropic_distance
from vkvolume_tpu.options import SkippingType as JSkip
from vkvolume_tpu.options import Test as JTest
from vkvolume_tpu.render import march as j_march
from vkvolume_tpu.render import sampling as jsampling
from vkvolume_tpu.tf.transfer_function import bake_texture
from vkvolume_tpu_torch import interop
from vkvolume_tpu_torch.options import SkippingType as TSkip
from vkvolume_tpu_torch.options import Test as TTest
from vkvolume_tpu_torch.render import sampling as tsampling
from vkvolume_tpu_torch.render.marcher import march

from scalar_reference import march_ray
from test_render import SKIP_NAMES, _setup
from util import random_blob_volume, sphere_shell_volume

COUNTERS = ("num_volume_samples", "num_distance_samples", "num_empty_samples")


def _maps(s, sk):
    if sk == JSkip.DISTANCE:
        return np.asarray(isotropic_distance(s["occ"]))[None]
    if sk == JSkip.ANISOTROPIC_DISTANCE:
        return np.asarray(anisotropic_distance(s["occ"]))
    if sk == JSkip.BLOCK:
        return np.asarray(s["occ"])[None]
    return None


def _both(vol, s, sk, *, ert=True, test=JTest.NONE, precomp=True,
          count=True, texture=None, max_iterations=0, global_depth=None,
          origin_z=None):
    """The same march through JAX and through the port."""
    dm = _maps(s, sk)
    grad = np.asarray(s["grad"])
    jout = j_march(
        jnp.asarray(vol), jnp.asarray(grad),
        None if dm is None else jnp.asarray(dm), s["tf"], s["rays"],
        jnp.asarray(s["bs"]), s["pvm"],
        None if texture is None else jnp.asarray(texture),
        None if origin_z is None else jnp.int32(origin_z),
        skipping_type=sk, early_ray_termination=ert,
        precomputed_gradient=precomp, test=test, count_samples=count,
        max_iterations=max_iterations, global_depth=global_depth)
    tf = interop.tf_from_numpy({f.name: getattr(s["tf"], f.name)
                                for f in dataclasses.fields(s["tf"])})
    rays = interop.rays_from_numpy({f.name: np.asarray(getattr(s["rays"],
                                                               f.name))
                                    for f in dataclasses.fields(s["rays"])})
    tout = march(
        torch.tensor(vol), torch.tensor(grad),
        None if dm is None else torch.tensor(dm), tf, rays, s["bs"],
        np.asarray(s["pvm"]),
        None if texture is None else interop.texture_from_numpy(texture),
        origin_z, skipping_type=TSkip(int(sk)), early_ray_termination=ert,
        precomputed_gradient=precomp, test=TTest(int(test)),
        count_samples=count, max_iterations=max_iterations,
        global_depth=global_depth)
    return jout, tout


def _hold_to_jax(jout, tout, valid):
    """The tolerances against JAX of the module docstring."""
    same = np.ones(valid.shape, bool)
    for k in COUNTERS:
        want = np.asarray(getattr(jout, k))
        got = getattr(tout, k).numpy()
        assert np.abs(got - want).max() <= 2, k
        same &= got == want
    flips = int((~same[valid]).sum())
    assert flips <= max(2, 0.02 * valid.sum()), (flips, valid.sum())
    want = np.asarray(jout.color)
    got = tout.color.numpy()
    diff = np.abs(got - want).max(-1)
    assert diff[same].max() <= 1e-5
    assert diff.max() <= 0.05
    assert abs(tout.iterations - int(jout.iterations)) <= 2
    dd = np.abs(tout.depth.numpy() - np.asarray(jout.depth))
    assert dd[same].max() <= 1e-5
    return same


def _tf_dict(s, use_gradient=False):
    tf = s["tf"]
    g = lambda k: float(np.asarray(getattr(tf, k)))
    return dict(imin=g("intensity_min"), irange_inv=g("intensity_range_inv"),
                gmin=g("gradient_min"), grange_inv=g("gradient_range_inv"),
                use_gradient=use_gradient,
                sampling_factor=g("sampling_factor"),
                voxel_alpha_factor=g("voxel_alpha_factor"),
                grad_mod=g("grad_magnitude_modifier"))


def _hold_to_oracle(vol, s, sk, tout, *, ert=True, precomp=True,
                    use_gradient=False):
    """Every covered pixel against the scalar oracle: counters exact,
    colour within 2e-4."""
    rays = s["rays"]
    valid = np.asarray(rays.valid)
    dm = _maps(s, sk)
    n = 0
    for py, px in zip(*np.nonzero(valid)):
        color, counters, _ = march_ray(
            volume=vol, gradient_map=np.asarray(s["grad"]),
            dist_maps=dm if dm is not None else np.asarray(s["occ"])[None],
            entry=np.asarray(rays.entry)[py, px],
            ray_dir=np.asarray(rays.ray_dir)[py, px],
            ray_distance=float(np.asarray(rays.ray_distance)[py, px]),
            block_size=s["bs"], skipping=SKIP_NAMES[sk], ert=ert,
            tf=_tf_dict(s, use_gradient), precomputed_gradient=precomp)
        np.testing.assert_allclose(tout.color[py, px].numpy(), color,
                                   atol=2e-4, err_msg=f"pixel {py},{px}")
        got = [int(getattr(tout, k)[py, px]) for k in COUNTERS]
        assert got == [counters["n_vol"], counters["n_dist"],
                       counters["n_empty"]], (py, px)
        n += 1
    assert n >= 20


@pytest.mark.parametrize("ert", [True, False])
@pytest.mark.parametrize("sk", list(JSkip))
def test_march_matches_jax_and_scalar_oracle(sk, ert):
    vol = random_blob_volume(np.random.default_rng(0), (24, 22, 26),
                             n_blobs=4)
    s = _setup(vol, size=12, tf_kw=dict(imin=0.15))
    jout, tout = _both(vol, s, sk, ert=ert)
    valid = np.asarray(s["rays"].valid)
    _hold_to_jax(jout, tout, valid)
    assert (tout.color.numpy()[..., 3] > 0).mean() > 0.05
    _hold_to_oracle(vol, s, sk, tout, ert=ert)


@pytest.mark.parametrize("precomp", [True, False])
def test_gradient_tf_matches_jax_and_oracle(precomp):
    """The gradient-modulated TF, from the precomputed map and on the fly
    (``sampling.gradient_on_the_fly``)."""
    vol = sphere_shell_volume(32)
    s = _setup(vol, size=12, use_gradient=True,
               tf_kw=dict(gmin=0.05, gmax=0.3))
    jout, tout = _both(vol, s, JSkip.DISTANCE, precomp=precomp)
    _hold_to_jax(jout, tout, np.asarray(s["rays"].valid))
    assert (tout.color.numpy()[..., 3] > 0).mean() > 0.1
    _hold_to_oracle(vol, s, JSkip.DISTANCE, tout, precomp=precomp,
                    use_gradient=True)


@pytest.mark.parametrize("sk", [JSkip.NONE, JSkip.ANISOTROPIC_DISTANCE])
def test_texture_tf_matches_jax(sk):
    vol = sphere_shell_volume(32)
    s = _setup(vol, size=16, use_gradient=True,
               tf_kw=dict(gmin=0.05, gmax=0.3))
    tex = bake_texture(intensity_min=0.1, intensity_max=1.0,
                       gradient_min=0.05, gradient_max=0.3)
    jout, tout = _both(vol, s, sk, texture=np.asarray(tex))
    _hold_to_jax(jout, tout, np.asarray(s["rays"].valid))
    assert (tout.color.numpy()[..., 3] > 0).mean() > 0.1


@pytest.mark.parametrize("test", [JTest.RAY_ENTRY, JTest.RAY_EXIT,
                                  JTest.NUM_TEXTURE_SAMPLES])
def test_diagnostics_match_jax(test):
    vol = sphere_shell_volume(32)
    s = _setup(vol, size=16)
    jout, tout = _both(vol, s, JSkip.DISTANCE, test=test, ert=False,
                       count=False)
    valid = np.asarray(s["rays"].valid)
    if test == JTest.NUM_TEXTURE_SAMPLES:
        _hold_to_jax(jout, tout, valid)
        assert (tout.num_volume_samples.numpy()[valid] > 0).mean() > 0.8
    else:
        assert tout.iterations == int(jout.iterations) == 0
        np.testing.assert_allclose(tout.color.numpy(),
                                   np.asarray(jout.color), atol=1e-6)
        np.testing.assert_array_equal(tout.depth.numpy(),
                                      np.asarray(jout.depth))


def test_count_samples_off_and_max_iterations():
    """Without counting the counters stay 0 and the image is the counted
    one; ``max_iterations`` stops every ray after that many loop bodies,
    in the state JAX's bounded loop leaves."""
    vol = sphere_shell_volume(32)
    s = _setup(vol, size=16)
    counted = _both(vol, s, JSkip.DISTANCE)[1]
    jout, tout = _both(vol, s, JSkip.DISTANCE, count=False)
    for k in COUNTERS:
        assert not getattr(tout, k).any()
    np.testing.assert_array_equal(tout.color.numpy(), counted.color.numpy())
    assert tout.iterations == counted.iterations > 12
    jcut, tcut = _both(vol, s, JSkip.DISTANCE, max_iterations=12)
    assert tcut.iterations == int(jcut.iterations) == 12
    _hold_to_jax(jcut, tcut, np.asarray(s["rays"].valid))
    assert (tcut.color.numpy()[..., 3]
            <= counted.color.numpy()[..., 3] + 1e-6).all()
    assert (tcut.color.numpy() != counted.color.numpy()).any()


def test_volume_slab_with_global_depth():
    """Volume-sharded mode: a z-slab of the volume with the global depth
    and the slab's first plane (taps rebased into the slab, clamped at its
    edges), as ``parallel/mesh.py`` hands it to the marcher."""
    vol = sphere_shell_volume(32)
    s = _setup(vol, size=16)
    z0, z1 = 10, 22
    slab = np.ascontiguousarray(vol[z0:z1])
    jout, tout = _both(slab, s, JSkip.NONE, global_depth=32, origin_z=z0)
    _hold_to_jax(jout, tout, np.asarray(s["rays"].valid))
    assert (tout.color.numpy()[..., 3] > 0).mean() > 0.1
    # The slab's march differs from the whole volume's.
    whole = _both(vol, s, JSkip.NONE)[1]
    assert (tout.color.numpy() != whole.color.numpy()).any()


# ------------------------------------------------------------- sampling


@pytest.mark.parametrize("slab", [False, True])
def test_trilinear_and_gradient_match_jax(slab):
    rng = np.random.default_rng(3)
    vol = random_blob_volume(rng, (20, 18, 22), n_blobs=5)
    pos = rng.uniform(-0.1, 1.1, (500, 3)).astype(np.float32)
    kw = {}
    if slab:
        vol = np.ascontiguousarray(vol[6:14])
        kw = dict(global_depth=20, origin_z=6)
    jkw = dict(kw, origin_z=jnp.int32(6)) if slab else {}
    want = np.asarray(jsampling.trilinear(jnp.asarray(vol), jnp.asarray(pos),
                                          **jkw))
    got = tsampling.trilinear(torch.tensor(vol), torch.tensor(pos), **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-7)
    want = np.asarray(jsampling.gradient_on_the_fly(
        jnp.asarray(vol), jnp.asarray(pos), jnp.float32(1.5), **jkw))
    got = tsampling.gradient_on_the_fly(torch.tensor(vol), torch.tensor(pos),
                                        1.5, **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert (want > 0).mean() > 0.2


def test_texel_fetch_matches_jax():
    rng = np.random.default_rng(4)
    m = rng.integers(0, 256, (5, 6, 7), dtype=np.uint8)
    u = np.stack([rng.integers(0, 7, 300), rng.integers(0, 6, 300),
                  rng.integers(0, 5, 300)], -1).astype(np.int32)
    want = np.asarray(jsampling.texel_fetch(jnp.asarray(m), jnp.asarray(u)))
    got = tsampling.texel_fetch(torch.tensor(m), torch.tensor(u))
    np.testing.assert_array_equal(got.numpy(), want)
