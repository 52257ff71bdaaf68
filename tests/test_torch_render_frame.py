"""The frame for caller-supplied rays (``render/sweep_frame.py``:
``render_frame``, ``plan_frame`` with its device-statistics branch,
``plan_stats`` / ``stats_to_dict``, ``sweep_pallas`` and
``PallasUnsupported``) against the JAX ``sweep_pallas`` module on the CPU
(its Pallas frame in interpret mode), on the scenes of
``tests/test_sweep.py`` and the cameras of ``tests/test_plan.py``."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vkvolume_tpu.accel import isotropic_distance as j_iso
from vkvolume_tpu.accel import occupancy_map as j_occ
from vkvolume_tpu.accel.gradient import gradient_map as j_grad
from vkvolume_tpu.camera import orbit_camera as j_orbit
from vkvolume_tpu.camera import perspective_camera as j_persp
from vkvolume_tpu.render import make_rays as j_make_rays
from vkvolume_tpu.render import make_uniforms as j_make_uniforms
from vkvolume_tpu.render import plan as j_plan
from vkvolume_tpu.render import sweep as j_sweep
from vkvolume_tpu.render import sweep_pallas as jsp
from vkvolume_tpu.tf import tf_params as j_tf_params
from vkvolume_tpu.utils import math3d as j_math3d
from vkvolume_tpu_torch import interop
from vkvolume_tpu_torch.accel import isotropic_distance, occupancy_map
from vkvolume_tpu_torch.accel.gradient import gradient_map
from vkvolume_tpu_torch.camera import orbit_camera, perspective_camera
from vkvolume_tpu_torch.render import make_rays, make_uniforms
from vkvolume_tpu_torch.render import sweep_frame as tsp
from vkvolume_tpu_torch.render import sweep_slabs
from vkvolume_tpu_torch.render.ray_setup import transpose_for_axis
from vkvolume_tpu_torch.tf.transfer_function import tf_params
from vkvolume_tpu_torch.utils import math3d

from torch_threads import one_torch_thread  # noqa: F401 (autouse)
from util import sphere_shell_volume

N = 40
H, W = 32, 128


def _pvm(cam, node, img_t):
    return (cam.proj.astype(np.float64) @ cam.view.astype(np.float64)
            @ (node @ img_t).astype(np.float64)).astype(np.float32)


def _frame_setup(azimuth, gradient):
    """``tests/test_sweep.py:_frame_setup`` in both packages: the sphere
    shell, its isotropic distance map, the camera's rays at 32x128."""
    vol = sphere_shell_volume(N)
    kw = (dict(intensity_min=0.1, gradient_min=0.05, gradient_max=0.6)
          if gradient else
          dict(intensity_min=0.1, gradient_min=0.0, gradient_max=0.0))
    m = -(-N // 4)
    node, img_t = j_math3d.scale((100.0 / N,) * 3), j_math3d.scale((float(N),) * 3)
    jcam = j_orbit(radius=150.0, azimuth_deg=azimuth, elevation_deg=15,
                   aspect=W / H)
    ju = j_make_uniforms(jcam, node, img_t, 50.0, (4.0, 4.0, 4.0))
    jrays = j_make_rays(ju, H, W)
    jtf = j_tf_params(**kw)
    jg = j_grad(jnp.asarray(vol), 1.0, use_gradient=True) if gradient \
        else None
    jdist = j_iso(j_occ(jnp.asarray(vol), jg, jtf, (m, m, m)))
    p = j_sweep.principal_axis(jrays)
    jt = lambda a: None if a is None else j_sweep.transpose_for_axis(a, p)
    jside = (jt(jnp.asarray(vol)), jt(jg), jt(jdist), jtf, jrays, ju,
             jnp.asarray(_pvm(jcam, node, img_t)))

    node_t, img_tt = math3d.scale((100.0 / N,) * 3), math3d.scale((float(N),) * 3)
    cam = orbit_camera(radius=150.0, azimuth_deg=azimuth, elevation_deg=15,
                       aspect=W / H)
    u = make_uniforms(cam, node_t, img_tt, 50.0, (4.0, 4.0, 4.0))
    rays = make_rays(u, H, W)
    tf = tf_params(**kw)
    t = torch.from_numpy(vol)
    g = gradient_map(t, 1.0, use_gradient=True) if gradient else None
    dist = isotropic_distance(occupancy_map(t, g, tf, (m, m, m)))
    tt = lambda a: None if a is None else transpose_for_axis(a, p)
    tside = (tt(t), tt(g), tt(dist), tf, rays, u, _pvm(cam, node_t, img_tt))
    return jside, tside, p


def _within(got, want):
    """The frame tolerance of tests/test_torch_frame.py."""
    bad = (np.abs(got - want).max(axis=-1) > 2e-3).mean()
    assert bad <= 1e-3, bad
    assert abs(got[..., 3].mean() - want[..., 3].mean()) <= 1e-4


@pytest.mark.parametrize("azimuth,gradient,oversample,route", [
    (25.0, False, 1.0, "brick"),        # sgn > 0
    (205.0, True, 1.68, "brick"),       # sgn < 0, gradient TF, plane lerp
    (25.0, False, 0.75, "slab"),        # fewer slabs than planes: K7
    (205.0, True, 0.75, "slab"),
])
def test_render_frame_matches_jax(monkeypatch, azimuth, gradient,
                                  oversample, route):
    (jv, jg, jd, jtf, jrays, ju, jpvm), (v, g, d, tf, rays, u, pvm), p = \
        _frame_setup(azimuth, gradient)
    want = jsp.render_frame(jv, jd, jtf, jrays, ju, jpvm, jg, p_axis=p,
                            ert=True, interpret=True, dist_leap=True,
                            oversample=oversample)
    routes = []
    monkeypatch.setattr(sweep_slabs, "sweep_slabs", (
        lambda f: lambda *a, **k: routes.append("slab") or f(*a, **k))(
            sweep_slabs.sweep_slabs))
    got = tsp.render_frame(v, d, tf, rays, u, pvm, g, p_axis=p, ert=True,
                           dist_leap=True, oversample=oversample)
    assert routes == ([] if route == "brick" else ["slab"])
    w, t = np.asarray(want.color), got.color.numpy()
    assert t.shape == (H, W, 4) and np.isfinite(t).all()
    assert w[..., 3].max() > 0.3                 # real content
    _within(t, w)
    np.testing.assert_allclose(got.depth.numpy(), np.asarray(want.depth),
                               rtol=0, atol=1e-3)


def test_render_frame_on_the_jax_rays_and_without_a_map():
    """The caller's rays drive the pixel stage: the JAX rays, carried over,
    give the port's frame; no skip map samples every slab."""
    (jv, _, jd, jtf, jrays, ju, jpvm), (v, _, d, tf, rays, u, pvm), p = \
        _frame_setup(25.0, False)
    carried = interop.rays_from_numpy(
        {f.name: getattr(jrays, f.name)
         for f in dataclasses.fields(jrays)})
    a = tsp.render_frame(v, d, tf, carried, u, pvm, p_axis=p,
                         dist_leap=True)
    b = tsp.render_frame(v, d, tf, rays, u, pvm, p_axis=p, dist_leap=True)
    _within(a.color.numpy(), b.color.numpy())
    none = tsp.render_frame(v, None, tf, rays, u, pvm, p_axis=p)
    _within(none.color.numpy(), b.color.numpy())


def _pallas_setup(eye=(0.0, 0.0, 8.0)):
    """``tests/test_sweep.py:_pallas_setup`` in both packages."""
    D, Hs, Ws = 16, 32, 256
    z, y, x = np.mgrid[0:D, 0:Hs, 0:Ws].astype(np.float32)
    vol = np.clip(
        140 * np.exp(-(((x - 128) / 18) ** 2 + ((y - 16) / 6) ** 2
                       + ((z - 8) / 2.5) ** 2))
        + 120 * np.exp(-(((x - 80) / 6) ** 2 + ((y - 12) / 4) ** 2
                         + ((z - 5) / 2) ** 2)),
        0, 255,
    ).astype(np.uint8)
    node = j_math3d.scale((100.0 / 256,) * 3)
    img_t = j_math3d.scale((float(Ws), float(Hs), float(D)))
    jcam = j_persp(eye=eye, center=(0, 0, 0), fovy_deg=25.0, aspect=W / H)
    cam = perspective_camera(eye=eye, center=(0, 0, 0), fovy_deg=25.0,
                             aspect=W / H)
    ju = j_make_uniforms(jcam, node, img_t, 1.0, (4.0, 4.0, 4.0))
    u = make_uniforms(cam, node, img_t, 1.0, (4.0, 4.0, 4.0))
    kw = dict(intensity_min=0.3, gradient_min=0.0, gradient_max=0.0)
    shape = (-(-D // 4), -(-Hs // 4), -(-Ws // 4))
    jrays = j_make_rays(ju, H, W)
    p = j_sweep.principal_axis(jrays)
    jocc = j_occ(jnp.asarray(vol), None, j_tf_params(**kw), shape)
    occ = occupancy_map(torch.from_numpy(vol), None, tf_params(**kw), shape)
    pvm = _pvm(cam, node, img_t)
    return (dict(vol=vol, tf=j_tf_params(**kw), u=ju, rays=jrays,
                 occ=jocc, pvm=jnp.asarray(pvm)),
            dict(vol=torch.from_numpy(vol), tf=tf_params(**kw), u=u,
                 rays=make_rays(u, H, W), occ=occ, pvm=pvm), p)


@pytest.mark.parametrize("ert", [True, False])
@pytest.mark.parametrize("eye", [(0.3, 0.2, 8.0), (0.3, 0.2, -8.0),
                                 (5.5, 1.5, 8.0)])
def test_sweep_pallas_matches_jax(eye, ert):
    """The per-slab sweep over the pixel rays, with a distance leap, against
    the JAX kernel in interpret mode."""
    j, t, p = _pallas_setup(eye)
    jd = j_sweep.transpose_for_axis(j_iso(j["occ"]), p)
    jv = j_sweep.transpose_for_axis(jnp.asarray(j["vol"]), p)
    d = transpose_for_axis(isotropic_distance(t["occ"]), p)
    v = transpose_for_axis(t["vol"], p)
    assert tsp.supports(t["rays"], t["u"], tuple(v.shape), H, W, p) == \
        jsp.supports(j["rays"], j["u"], jv.shape, H, W, p)
    try:
        want = jsp.sweep_pallas(jv, jd, j["tf"], j["rays"], j["u"], j["pvm"],
                                p_axis=p, ert=ert, interpret=True,
                                dist_leap=True)
    except jsp.PallasUnsupported:
        with pytest.raises(tsp.PallasUnsupported):
            tsp.sweep_pallas(v, d, t["tf"], t["rays"], t["u"], t["pvm"],
                             p_axis=p, ert=ert, dist_leap=True)
        return
    got = tsp.sweep_pallas(v, d, t["tf"], t["rays"], t["u"], t["pvm"],
                           p_axis=p, ert=ert, dist_leap=True)
    w = np.asarray(want.color)
    assert w[..., 3].max() > 0.05
    np.testing.assert_allclose(got.color.numpy(), w, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got.num_volume_samples.numpy(),
                                  np.asarray(want.num_volume_samples))


def test_pallas_unsupported_raises():
    """``tests/test_sweep.py::test_pallas_unsupported_raises`` on the port:
    a volume one plane thin, and an image that does not tile by 8x128."""
    _, t, p = _pallas_setup()
    tiny = torch.zeros((1, 2, 2), dtype=torch.uint8)
    with pytest.raises(tsp.PallasUnsupported):
        tsp.sweep_pallas(tiny, None, t["tf"], t["rays"], t["u"], t["pvm"],
                         p_axis=p)
    bad_rays = type(t["rays"])(**{
        f.name: (None if getattr(t["rays"], f.name) is None
                 else getattr(t["rays"], f.name)[:30])
        for f in dataclasses.fields(t["rays"])})
    with pytest.raises(tsp.PallasUnsupported):
        tsp.render_frame(torch.zeros((8, 32, 256), dtype=torch.uint8), None,
                         t["tf"], bad_rays, t["u"], t["pvm"], p_axis=p)
    assert issubclass(tsp.PallasUnsupported, ValueError)


CAMS = [
    dict(radius=220.0, azimuth_deg=30, elevation_deg=20, aspect=1.0),
    dict(radius=150.0, azimuth_deg=-50, elevation_deg=45, aspect=2.0),
    dict(radius=400.0, azimuth_deg=110, elevation_deg=-30, aspect=16 / 9),
    dict(radius=95.0, azimuth_deg=75, elevation_deg=5, aspect=1.5),
    dict(eye=(180, 40, -60), center=(10, -5, 0), fovy_deg=40.0, aspect=1.0),
]


def _plan_uniforms(ci, n=64):
    """``tests/test_plan.py``'s camera ``ci`` in both packages."""
    c = CAMS[ci]
    node, img_t = j_math3d.scale((100.0 / n,) * 3), j_math3d.scale((float(n),) * 3)
    if "eye" in c:
        jc, tc = j_persp(**c), perspective_camera(**c)
    else:
        jc, tc = j_orbit(**c), orbit_camera(**c)
    return (j_make_uniforms(jc, node, img_t, 50.0, (4.0, 4.0, 4.0)),
            make_uniforms(tc, node, img_t, 50.0, (4.0, 4.0, 4.0)))


@pytest.mark.parametrize("ci", range(len(CAMS)))
def test_plan_stats_match_jax(ci):
    """Every axis of every camera (the caller's axis need not be the
    view's): the port's statistics of the same rays equal JAX's, medians
    included."""
    ju, _ = _plan_uniforms(ci)
    jrays = j_make_rays(ju, 64, 128)
    rays = interop.rays_from_numpy({"ray_dir": jrays.ray_dir,
                                    "valid": jrays.valid,
                                    "depth_init": jrays.depth_init})
    for p in (0, 1, 2):
        want = jsp.stats_to_dict(jsp._plan_stats_jit(jrays, p))
        got = tsp.stats_to_dict(tsp.plan_stats(rays, p))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("n", [1, 2, 5, 6, 31, 32])
def test_nanmedian_is_numpys(n):
    """Even counts average the two middle values (``torch.nanmedian``
    takes the lower); NaN is skipped; all-NaN gives NaN."""
    rng = np.random.default_rng(n)
    x = rng.random(n + 7).astype(np.float32)
    x[rng.permutation(n + 7)[:7]] = np.nan
    got = float(tsp._nanmedian(torch.from_numpy(x)))
    assert got == float(jnp.nanmedian(jnp.asarray(x))) == \
        float(np.float32(np.nanmedian(x)))
    assert np.isnan(float(tsp._nanmedian(torch.full((4,), float("nan")))))


@pytest.mark.parametrize("ci", range(len(CAMS)))
def test_plan_frame_device_stats_plan_matches_jax(ci):
    """``plan_frame`` for an axis other than the host analysis's falls back
    to the device statistics of the rays; the plan equals JAX's. For the
    view's own axis it is the host plan."""
    ju, u = _plan_uniforms(ci)
    Hh, Ww, shape = 64, 128, (64, 64, 64)
    jrays = j_make_rays(ju, Hh, Ww)
    rays = make_rays(u, Hh, Ww)
    view = j_plan.analyze_view(ju, Hh, Ww)
    n_plans = 0
    for p in (0, 1, 2):
        want = jsp.plan_frame(ju, jrays, p, shape, Hh, Ww)
        got = tsp.plan_frame(u, rays, p, shape, Hh, Ww)
        assert (got is None) == (want is None)
        if want is None:
            continue
        n_plans += 1
        assert got.keys() <= want.keys() | {"warp_xla"}
        for k, wv in want.items():
            if k in ("R_sweep", "RECT_B", "span_blks"):
                continue                    # TPU statics the port drops
            gv = got.get(k)
            if isinstance(wv, (float, np.floating)):
                np.testing.assert_allclose(gv, wv, rtol=1e-6, err_msg=k)
            else:
                assert gv == wv, k
        if p == view["p_axis"]:
            assert got == tsp.plan_from_stats(
                view, u, p, shape, Hh, Ww)
    assert n_plans >= 2
