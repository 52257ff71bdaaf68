"""Depth attachments and the scene pass: the port's full ray setup
(``make_rays(full=True)`` and its depth clamp), ``render/forward.py``
(``rasterize``, ``sponza_lite``), ``Engine.render(depth_image=)`` and
``Engine.render_with_scene`` against the JAX package's, on the CPU.

Tolerances. Ray fields within 2e-5 plus 1e-6 of their size (float32
matrix products summed in another order; clip w is ~200), coverage
exact. The rasteriser's depth within 1e-6 where
both cover a pixel; coverage and the winning triangle may differ only
where an edge function sits within float error of the edge tolerance
(XLA fuses the edge function's multiply-adds): at most 0.2 % of the
pixels. Frames through the XLA sweep: colour within 1e-5 and depth within
1e-5 at 99.8 % of the pixels, mean alpha within 1e-4.
"""

import dataclasses

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
from vkvolume_tpu.render import forward as jforward
from vkvolume_tpu.render.ray_setup import make_rays as j_make_rays
from vkvolume_tpu.render.ray_setup import make_uniforms as j_make_uniforms
from vkvolume_tpu_torch import interop
from vkvolume_tpu_torch.camera import orbit_camera
from vkvolume_tpu_torch.engine import Engine, from_array
from vkvolume_tpu_torch.options import (RenderOptions, SkippingType,
                                        VolumeOptions)
from vkvolume_tpu_torch.render import forward, sweep_frame
from vkvolume_tpu_torch.render.ray_setup import make_rays
from vkvolume_tpu_torch.utils import math3d
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

from util import sphere_shell_volume

RAY_FIELDS = ("ray_dir", "entry", "exit", "ray_distance", "entry_clip_zw",
              "depth_init")


def _uniforms(n=32, az=0.0, el=0.0, clip=50.0, aspect=1.0):
    node = math3d.scale((100.0 / n,) * 3)
    img = math3d.scale((float(n),) * 3)
    cam = j_orbit_camera(radius=220.0, azimuth_deg=az, elevation_deg=el,
                         aspect=aspect)
    ju = j_make_uniforms(cam, node, img, clip, (4.0, 4.0, 4.0))
    tu = interop.uniforms_from_numpy({f.name: getattr(ju, f.name)
                                      for f in dataclasses.fields(ju)})
    return ju, tu


def _hold_rays(jr, tr, valid_only=True):
    np.testing.assert_array_equal(tr.valid.numpy(), np.asarray(jr.valid))
    m = np.asarray(jr.valid)
    for name in RAY_FIELDS:
        want = np.asarray(getattr(jr, name))
        got = getattr(tr, name).numpy()
        assert got.shape == want.shape, name
        if valid_only:
            want, got = want[m], got[m]
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=2e-5,
                                   err_msg=name)


@pytest.mark.parametrize("az,el", [(0.0, 0.0), (30.0, 20.0), (200.0, -35.0)])
def test_full_rays_match_jax(az, el):
    ju, tu = _uniforms(az=az, el=el)
    jr = j_make_rays(ju, 24, 32)
    tr = make_rays(tu, 24, 32, full=True)
    assert np.asarray(jr.valid).mean() > 0.2
    _hold_rays(jr, tr)
    # Without the full setup the w-grid frame's three fields, unchanged.
    plain = make_rays(tu, 24, 32)
    assert plain.entry is None and plain.ray_distance is None
    np.testing.assert_array_equal(plain.ray_dir.numpy(), tr.ray_dir.numpy())


@pytest.mark.parametrize("case", ["occluded", "open", "through"])
def test_depth_rays_match_jax(case):
    """All occluded (depth 1.0, the near plane), never occluded (0.0, the
    far plane: the exit stays the AABB's), and a scene depth cutting
    through the volume, varying per pixel."""
    ju, tu = _uniforms(az=20.0, el=15.0)
    size = 16
    if case == "occluded":
        depth = np.ones((size, size), np.float32)
    elif case == "open":
        depth = np.zeros((size, size), np.float32)
    else:
        # Reverse-Z depths from in front of the volume's entries (3.7e-4 to
        # 6.5e-4 at this pose) to behind its exits.
        rng = np.random.default_rng(5)
        depth = rng.uniform(3e-4, 6e-4, (size, size)).astype(np.float32)
    jr = j_make_rays(ju, size, size, depth_image=jnp.asarray(depth),
                     use_depth=True)
    tr = make_rays(tu, size, size, depth_image=torch.tensor(depth),
                   use_depth=True)
    _hold_rays(jr, tr)
    valid = tr.valid.numpy()
    plain = make_rays(tu, size, size, full=True)
    if case == "occluded":
        assert not valid.any()
    elif case == "open":
        np.testing.assert_array_equal(valid, plain.valid.numpy())
        assert valid.any()
        np.testing.assert_array_equal(tr.exit.numpy()[valid],
                                      plain.exit.numpy()[valid])
    else:
        # Some rays discarded, some clamped short of the AABB exit.
        assert 0 < valid.sum() < plain.valid.numpy().sum()
        shorter = (tr.ray_distance.numpy()
                   < plain.ray_distance.numpy() - 1e-4) & valid
        assert shorter.any()


def _tri(z, rgb, reverse=False):
    v = np.array([[-30, -20, z], [30, -20, z], [0, 30, z]], np.float32)
    f = np.array([[0, 2, 1]] if reverse else [[0, 1, 2]], np.int32)
    return v, f, np.array([rgb], np.float32)


def _meshes():
    """(JAX mesh, port mesh) pairs: one triangle, a back face, two
    overlapping triangles of which the nearer is last, a coplanar pair
    drawn twice (equal depths: the first must win), and the hall."""
    def cat(*parts):
        verts, faces, alb, off = [], [], [], 0
        for v, f, a in parts:
            verts.append(v)
            faces.append(f + off)
            alb.append(a)
            off += len(v)
        return np.concatenate(verts), np.concatenate(faces), \
            np.concatenate(alb)

    sp = jforward.sponza_lite()
    cases = {
        "front": _tri(0.0, (1.0, 0.0, 0.0)),
        "back": _tri(0.0, (1.0, 0.0, 0.0), reverse=True),
        "zorder": cat(_tri(0.0, (1.0, 0.0, 0.0)), _tri(50.0, (0.0, 1.0, 0.0))),
        "ties": cat(_tri(10.0, (1.0, 0.0, 0.0)), _tri(10.0, (0.0, 0.0, 1.0))),
        "sponza": (sp.verts, sp.faces, sp.albedo),
    }
    return {k: (jforward.Mesh(*v), forward.Mesh(*v))
            for k, v in cases.items()}


MESHES = _meshes()


@pytest.mark.parametrize("name", list(MESHES))
def test_rasterize_matches_jax(name):
    jm, tm = MESHES[name]
    jcam = j_orbit_camera(radius=200.0, azimuth_deg=0, elevation_deg=10,
                          aspect=2.0)
    cam = orbit_camera(radius=200.0, azimuth_deg=0, elevation_deg=10,
                       aspect=2.0)
    jc, jd = (np.asarray(a) for a in jforward.rasterize(jm, jcam, 64, 128))
    tc, td = (a.numpy() for a in forward.rasterize(tm, cam, 64, 128))
    both = (jd > 0) & (td > 0)
    assert ((jd > 0) != (td > 0)).mean() <= 2e-3
    np.testing.assert_allclose(td[both], jd[both], rtol=0, atol=1e-6)
    same = (np.abs(tc - jc).max(-1) <= 1e-6)
    assert (~same).mean() <= 2e-3
    if name == "back":
        assert not (td > 0).any()
    else:
        assert (td > 0).mean() > 0.005
    if name == "ties":
        # Equal depths: the first triangle in mesh order (red) wins.
        cov = td > 0
        assert (tc[cov][:, 0] > 0).all() and not tc[cov][:, 2].any()
    if name == "sponza":
        assert (td > 0).mean() > 0.5 and td.max() <= 1.0 + 1e-6


def test_sponza_lite_is_the_jax_hall():
    jm, tm = MESHES["sponza"][0], forward.sponza_lite()
    assert tm.faces.shape == (560, 3) and tm.verts.shape == (356, 3)
    for f in ("verts", "faces", "albedo"):
        np.testing.assert_array_equal(getattr(tm, f), getattr(jm, f))


def _engines(renderer, n=40):
    vol = sphere_shell_volume(n)
    jeng = JEngine(JRenderOptions(skipping_type=JSkip.DISTANCE),
                   renderer=renderer)
    jv = j_from_array(vol, JVolumeOptions(intensity_min=0.1, gradient_min=0.0,
                                          gradient_max=0.0), block_size=4)
    jv.set_scale((100.0 / n,) * 3)
    jeng.add_volume(jv)
    teng = Engine(RenderOptions(skipping_type=SkippingType.DISTANCE),
                  renderer=renderer, device="cpu")
    tv = from_array(vol, VolumeOptions(intensity_min=0.1, gradient_min=0.0,
                                       gradient_max=0.0), block_size=4,
                    device="cpu")
    tv.set_scale((100.0 / n,) * 3)
    teng.add_volume(tv)
    return jeng, teng


def _hold_frames(jout, tout):
    want, got = np.asarray(jout.color), tout.color.numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    bad = ((np.abs(got - want).max(-1) > 1e-5)
           | (np.abs(tout.depth.numpy() - np.asarray(jout.depth)) > 1e-5))
    assert bad.mean() <= 2e-3, bad.mean()
    assert abs(got[..., 3].mean() - want[..., 3].mean()) <= 1e-4


H, W = 32, 128


def _cams(width=W):
    kw = dict(radius=220.0, azimuth_deg=0, elevation_deg=0,
              aspect=width / H)
    return j_orbit_camera(**kw), orbit_camera(**kw)


@pytest.mark.parametrize("renderer,width", [("pallas", 128), ("pallas", 120),
                                            ("sweep", 128)])
def test_depth_clipped_frame_matches_jax(monkeypatch, renderer, width):
    """A scene depth that hides the volume left of the frame's centre,
    cuts through it over the four central columns and leaves the rest
    open: the frame takes the XLA sweep on the clamped rays, never the
    w-grid frame, in both engines (at 120 wide the port pads the viewport,
    and the depth with the far plane, to 128 first); without the
    attachment option the depth image is ignored."""
    jeng, teng = _engines(renderer)
    jcam, cam = _cams(width)
    calls = []
    orig = sweep_frame._frame_body
    monkeypatch.setattr(sweep_frame, "_frame_body",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    # The shell covers columns 59-68 of 128; its first hits lie at
    # reverse-Z depths 4.6e-4 to 5.3e-4.
    c0, c1 = width // 2 - 2, width // 2 + 2
    depth = np.zeros((H, width), np.float32)
    depth[:, :c0] = 1.0
    depth[:, c0:c1] = 4.9e-4
    jeng.options.depth_attachment = True
    teng.options.depth_attachment = True
    jout = jeng.render(jcam, width, H, depth_image=jnp.asarray(depth))
    tout = teng.render(cam, width, H, depth_image=torch.tensor(depth))
    assert teng.last_renderer == jeng.last_renderer == "sweep"
    assert not calls
    assert not any(isinstance(k, tuple) and k[0] == "pose"
                   for k in teng.volumes[0]._sweep_cache)
    _hold_frames(jout, tout)
    # The same route with a depth that clips nothing (the far plane).
    open_ = teng.render(cam, width, H,
                        depth_image=torch.zeros((H, width)))
    a_free = open_.color.numpy()[..., 3]
    a_clip = tout.color.numpy()[..., 3]
    assert a_free[:, :c0].sum() > 0 and not a_clip[:, :c0].any()
    assert 0 < a_clip[:, c0:c1].sum() < a_free[:, c0:c1].sum()
    assert a_free[:, c1:].sum() > 0
    np.testing.assert_array_equal(tout.color.numpy()[:, c1:],
                                  open_.color.numpy()[:, c1:])
    # The option off: the depth image clips nothing.
    teng.options.depth_attachment = False
    free = teng.render(cam, width, H)
    off = teng.render(cam, width, H, depth_image=torch.tensor(depth))
    np.testing.assert_array_equal(off.color.numpy(), free.color.numpy())
    if renderer == "pallas":
        assert calls and teng.last_renderer == "pallas"


@pytest.mark.parametrize("renderer", ["sweep", "marcher"])
def test_render_with_scene_matches_jax(renderer):
    """``render_with_scene`` with the demo hall: the scene depth clips the
    volume and the volume composites over the scene colour."""
    jeng, teng = _engines(renderer)
    jcam, cam = _cams()
    jout = jeng.render_with_scene(jcam, W, H, jforward.sponza_lite())
    tout = teng.render_with_scene(cam, W, H, forward.sponza_lite())
    assert teng.last_renderer == jeng.last_renderer == renderer
    assert not teng.options.depth_attachment
    _hold_frames(jout, tout)
    got = tout.color.numpy()
    assert (got[..., 3] > 0.99).mean() > 0.5        # the hall fills it
    _, scene_depth = forward.rasterize(forward.sponza_lite(), cam, H, W)
    assert (tout.depth >= scene_depth).all()
