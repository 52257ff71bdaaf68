"""Host-side modules and plain-PyTorch map builders of the port against the
JAX package: uniforms, view analysis, frame plans, packed per-pose scalars,
the synthetic beetle, the TF derivation, and the occupancy / gradient maps
and the octant stitch (bit-exact)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vkvolume_tpu.accel import gradient as jgrad
from vkvolume_tpu.accel import occupancy as jocc
from vkvolume_tpu.bench import datasets as jds
from vkvolume_tpu.bench import harness as jh
from vkvolume_tpu.engine import volume as jvolume
from vkvolume_tpu.engine.engine import _octant_composite as j_octant
from vkvolume_tpu.render import plan as jplan
from vkvolume_tpu.render import ray_setup as jrs
from vkvolume_tpu.render import sweep_pallas as jsp
from vkvolume_tpu.tf import transfer_function as jtf
from vkvolume_tpu.utils import math3d
from vkvolume_tpu_torch import interop
from vkvolume_tpu_torch.accel import gradient as tgrad
from vkvolume_tpu_torch.accel import occupancy as tocc
from vkvolume_tpu_torch.bench import datasets as tds
from vkvolume_tpu_torch.bench import harness as th
from vkvolume_tpu_torch.engine.engine import _octant_composite
from vkvolume_tpu_torch.render import plan as tplan
from vkvolume_tpu_torch.render import ray_setup as trs
from vkvolume_tpu_torch.render import sweep_frame as tsf
from vkvolume_tpu_torch.tf import transfer_function as ttf

SHAPE = (49, 83, 83)     # the beetle at scale 0.1

# (width, height, azimuth, elevation): poses whose plans cover both warp
# variants, both sweep directions and the no-two-pass-warp case.
POSES = [(256, 256, 30.0, 20.0), (512, 256, 30.0, 20.0),
         (256, 256, 210.0, 20.0), (256, 128, 30.0, 20.0),
         (1920, 1080, 30.0, 20.0), (128, 128, 45.0, 10.0)]


def _uniforms(mod, w, h, az, el, shape=SHAPE):
    d, hh, ww = shape
    cam = jh.benchmark_camera(aspect=w / h, azimuth=az, elevation=el)
    node = math3d.scale((100.0 / max(shape),) * 3)
    img = math3d.scale((float(ww), float(hh), float(d)))
    return mod.make_uniforms(cam, node, img, 1.0,
                             np.asarray((4.0, 4.0, 4.0), np.float32))


def _shape_for(dsh):
    return lambda q: {2: dsh, 1: (dsh[1], dsh[0], dsh[2]),
                      0: (dsh[2], dsh[0], dsh[1])}[q]


def _same(a, b):
    """Recursive equality of plan / view values (arrays, floats, tuples)."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b or (a != a and b != b), (a, b)


@pytest.mark.parametrize("w,h,az,el", POSES)
def test_uniforms_and_view_analysis_match(w, h, az, el):
    ju = _uniforms(jrs, w, h, az, el)
    tu = _uniforms(trs, w, h, az, el)
    for f in dataclasses.fields(tu):
        np.testing.assert_array_equal(np.asarray(getattr(tu, f.name)),
                                      np.asarray(getattr(ju, f.name)))
    _same(tplan.analyze_view(tu, h, w), jplan.analyze_view(ju, h, w))


@pytest.mark.parametrize("w,h,az,el", POSES[:4])
def test_make_rays_matches(w, h, az, el):
    ju = _uniforms(jrs, w, h, az, el)
    tu = _uniforms(trs, w, h, az, el)
    jr = jrs.make_rays(ju, h, w)
    tr = trs.make_rays(tu, h, w)
    # One float32 ulp: XLA and PyTorch sum the 4x4 products and the norm in
    # another order.
    np.testing.assert_allclose(tr.ray_dir.numpy(), np.asarray(jr.ray_dir),
                               rtol=0, atol=2e-7)
    np.testing.assert_array_equal(tr.valid.numpy(), np.asarray(jr.valid))
    np.testing.assert_array_equal(tr.depth_init.numpy(),
                                  np.asarray(jr.depth_init))
    assert 0.05 < tr.valid.numpy().mean() < 1.0


@pytest.mark.parametrize("w,h,az,el", POSES)
def test_frame_plan_and_packed_scalars_match(w, h, az, el):
    ju = _uniforms(jrs, w, h, az, el)
    tu = _uniforms(trs, w, h, az, el)
    jview, jp = jsp.select_view_plan(ju, h, w, _shape_for(SHAPE))
    tview, tp = tsf.select_view_plan(tu, h, w, _shape_for(SHAPE))
    _same(tview, jview)
    _same(tp, jp)
    ax = tview["p_axis"]
    shape_t = _shape_for(SHAPE)(ax)
    for mobius in (False, True):
        _same(tsf.plan_from_stats(tview, tu, ax, shape_t, h, w,
                                  mobius=mobius),
              jsp.plan_from_stats(jview, ju, ax, shape_t, h, w,
                                  mobius=mobius))
    assert tsf._plan_cost(tp) == jsp._plan_cost(jp)
    gp = [tp["wu0"], tp["dwu"], tp["cu"], tp["wv0"], tp["dwv"], tp["cv"]]
    pvm = np.arange(16, dtype=np.float32).reshape(4, 4) / 7.0
    tpk = tsf.pack_frame_scalars(tu, pvm, gp, tp.get("hcoef"))
    np.testing.assert_array_equal(
        tpk, jsp.pack_frame_scalars(ju, pvm, gp, jp.get("hcoef")))
    u2, pvm2, gp2, hc2 = tsf.unpack_frame_scalars(tpk)
    np.testing.assert_array_equal(tsf.pack_frame_scalars(u2, pvm2, gp2, hc2),
                                  tpk)


def test_plans_cover_the_slice_variants():
    """The poses above include the main path's plan (bricks + variant B at
    1920x1080), a variant A plan and a plan without a two-pass warp."""
    kinds = set()
    for w, h, az, el in POSES:
        tu = _uniforms(trs, w, h, az, el)
        _, p = tsf.select_view_plan(tu, h, w, _shape_for(SHAPE))
        kinds.add((p["R_brick"] is not None, p.get("warp_variant")))
    assert {(True, "A"), (True, "B"), (True, None)} <= kinds
    tu = _uniforms(trs, 1920, 1080, 30.0, 20.0, shape=(494, 832, 832))
    view, p = tsf.select_view_plan(tu, 1080, 1920,
                                   _shape_for((494, 832, 832)))
    assert p["R_brick"] is not None and p["RECT_A"] is not None
    assert view["p_axis"] == 2 and not p.get("warp_xla")


def test_synthetic_beetle_is_byte_equal():
    a = jds.synthesize(jds.DATASETS["beetle"], seed=0, scale=0.1,
                       cache_dir=None)
    b = tds.synthesize(tds.DATASETS["beetle"], seed=0, scale=0.1,
                       cache_dir=None)
    assert a.shape == SHAPE and a.dtype == np.uint8
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("imin,imax,gmin,gmax", [
    (0.086, 1.0, 0.0, 0.0), (0.1, 0.7, 0.1, 0.3), (0.0, 1.0, 0.0, 1.0)])
def test_tf_params_and_thresholds_match(imin, imax, gmin, gmax):
    kw = dict(intensity_min=imin, intensity_max=imax, gradient_min=gmin,
              gradient_max=gmax)
    j = jtf.tf_params(**kw)
    t = ttf.tf_params(**kw)
    for f in dataclasses.fields(t):
        assert getattr(t, f.name) == (getattr(j, f.name)
                                      if f.name == "use_gradient"
                                      else float(np.asarray(getattr(j,
                                                                    f.name))))
    tf_host = (imin, imax, gmin, gmax)
    assert tocc._tf_thresholds(t, tf_host) == jocc._tf_thresholds(j, tf_host)
    assert tocc._tf_thresholds(t) == jocc._tf_thresholds(j)


@pytest.fixture(scope="module")
def beetle():
    return tds.synthesize(tds.DATASETS["beetle"], seed=0, scale=0.1,
                          cache_dir=None)


@pytest.mark.parametrize("gradient", [False, True])
def test_occupancy_and_count_match(beetle, gradient):
    imin, gmin, gmax = 0.086, (0.1 if gradient else 0.0), (0.3 if gradient
                                                           else 0.0)
    tf_host = (imin, 1.0, gmin, gmax)
    jt = jtf.tf_params(intensity_min=imin, gradient_min=gmin,
                       gradient_max=gmax)
    tt = ttf.tf_params(intensity_min=imin, gradient_min=gmin,
                       gradient_max=gmax)
    jg = jgrad.gradient_map(jnp.asarray(beetle), 1.0, use_gradient=True)
    tg = tgrad.gradient_map(torch.from_numpy(beetle), 1.0, use_gradient=True)
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    maps_shape = tuple(-(-s // 4) for s in beetle.shape)
    ti, tgt = tocc._tf_thresholds(tt, tf_host)
    want = np.asarray(jocc._occupancy_u8(jnp.asarray(beetle),
                                         jg if gradient else None,
                                         maps_shape, ti, tgt))
    got = tocc._occupancy_u8(torch.from_numpy(beetle),
                             tg if gradient else None, maps_shape, ti, tgt)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == 0).any() and (want == 255).any()
    assert tocc.occupied_voxel_count(torch.from_numpy(beetle), tg, tt,
                                     tf_host=tf_host) == \
        jocc.occupied_voxel_count(jnp.asarray(beetle), jg, jt,
                                  tf_host=tf_host)


def test_gradient_map_matches(beetle):
    """The 4-tap tetrahedron gradient map, bit-exact."""
    want = np.asarray(jgrad.gradient_map(jnp.asarray(beetle), 1.0,
                                         use_gradient=True))
    got = tgrad.gradient_map(torch.from_numpy(beetle), 1.0,
                             use_gradient=True).numpy()
    np.testing.assert_array_equal(got, want)
    flat = tgrad.gradient_map(torch.from_numpy(beetle), use_gradient=False)
    assert bool((flat == 255).all())


def test_octant_composite_matches():
    rng = np.random.default_rng(3)
    maps = rng.integers(0, 64, (8, 7, 9, 11)).astype(np.uint8)
    for ks in ((3.4, 4.0, 5.9), (-2.0, 12.5, 0.0), (6.99, 8.0, 10.0)):
        want = np.asarray(j_octant(jnp.asarray(maps),
                                   *(jnp.float32(k) for k in ks)))
        got = _octant_composite(torch.from_numpy(maps), *ks).numpy()
        np.testing.assert_array_equal(got, want)


def test_volume_from_numpy_matches(beetle):
    jv = jvolume.from_array(beetle, block_size=4, voxel_size=(1.0, 1.0, 2.0))
    jv.set_scale((0.5, 0.25, 1.0))
    tv = interop.volume_from_numpy(np.asarray(jv.density),
                                   np.asarray(jv.image_transform),
                                   np.asarray(jv.node_transform),
                                   jv.block_size)
    np.testing.assert_array_equal(tv.density.numpy(), beetle)
    assert tv.map_shape_zyx == jv.map_shape_zyx
    assert tv.effective_block_size_xyz == jv.effective_block_size_xyz
    np.testing.assert_array_equal(tv.model_matrix, jv.model_matrix)


def test_benchmark_camera_matches():
    a = jh.benchmark_camera(aspect=1920 / 1080)
    b = th.benchmark_camera(aspect=1920 / 1080)
    np.testing.assert_array_equal(a.view, b.view)
    np.testing.assert_array_equal(a.proj, b.proj)
