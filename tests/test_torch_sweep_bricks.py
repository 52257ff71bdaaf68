"""Brick sweep: the port's plain ``sweep_bricks`` (the plain version of K1)
against the JAX package's ``_sweep_bricks_jit`` run in Pallas interpret
mode, on the same w-grid fields, maps and statics: the aligned
intensity-only variant (bench.py's frame) and the gradient-TF plane-pair
lerp variant (the CLI's default frame: skipmode 2, imin 0.1, gradient
0..0.2, n_slabs 166 != Np 49 at beetle scale 0.1). Sample counts and
first-hit depths are exact; lum and alpha agree to 1e-5 (the TPU kernel's
tent dot sums its two non-zero rows in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vkvolume_tpu.bench import harness as jh
from vkvolume_tpu.engine import Engine as JEngine
from vkvolume_tpu.engine import from_array as j_from_array
from vkvolume_tpu.engine.engine import _octant_composite as j_octant
from vkvolume_tpu.options import RenderOptions as JRenderOptions
from vkvolume_tpu.options import SkippingType as JSkip
from vkvolume_tpu.options import Test as JTest
from vkvolume_tpu.options import VolumeOptions as JVolumeOptions
from vkvolume_tpu.render import sweep as jsweep
from vkvolume_tpu.render import sweep_bricks as jsb
from vkvolume_tpu.render import sweep_pallas as jsp
from vkvolume_tpu.render.ray_setup import make_uniforms as j_make_uniforms
from vkvolume_tpu_torch import interop
from vkvolume_tpu_torch.engine.engine import _octant_composite
from vkvolume_tpu_torch.render import sweep_bricks as tsb
from vkvolume_tpu_torch.render.ray_setup import transpose_for_axis
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

W_IMG = H_IMG = 256
ROWS = slice(160, 224)       # a 64 x 256 window of the plan's w-grid
COLS = slice(128, 384)


@pytest.fixture(scope="module")
def engine():
    eng, _, vol, _ = jh.make_engine("beetle", 3, 4, scale=0.1,
                                    test=JTest.NONE, ert=True)
    return eng, vol


@pytest.fixture(scope="module")
def grad_engine(engine):
    """The CLI's defaults: isotropic distance map, gradient TF."""
    _, vol = engine
    eng = JEngine(JRenderOptions(skipping_type=JSkip.DISTANCE))
    v = j_from_array(vol, JVolumeOptions(intensity_min=0.1, gradient_min=0.0,
                                         gradient_max=0.2), block_size=4)
    v.set_scale((100.0 / max(vol.shape),) * 3)
    eng.add_volume(v)
    return eng, vol


def _setup(engine, azimuth):
    """JAX-side inputs of one brick sweep: transposed volume and octant
    skip map, uniforms, the plan's statics and w-grid fields (a window of
    the plan's grid, so every statics' feasibility still holds)."""
    eng, vol = engine
    v = eng.volumes[0]
    cam = jh.benchmark_camera(aspect=W_IMG / H_IMG, azimuth=azimuth)
    u = j_make_uniforms(cam, v.node_transform, v.image_transform,
                        eng.options.clip_distance,
                        np.asarray(v.effective_block_size_xyz, np.float32))
    dsh = vol.shape
    shape_for = lambda q: {2: dsh, 1: (dsh[1], dsh[0], dsh[2]),
                           0: (dsh[2], dsh[0], dsh[1])}[q]
    view, plan = jsp.select_view_plan(u, H_IMG, W_IMG, shape_for)
    assert plan is not None and plan["R_brick"] is not None
    p = view["p_axis"]
    bs = np.asarray(v.effective_block_size_xyz, np.float64)
    cam_t = np.asarray(u.cam_pos_tex, np.float64)
    ks = (cam_t[2] * dsh[0] / bs[2], cam_t[1] * dsh[1] / bs[1],
          cam_t[0] * dsh[2] / bs[0])
    maps = v.dist_maps
    occ_t = jsweep.transpose_for_axis(
        j_octant(maps, *(jnp.float32(k) for k in ks)) if maps.shape[0] == 8
        else maps[0], p)
    vol_t = jsweep.transpose_for_axis(v.density, p)
    tf = eng._tf(v)
    grad_t = (jsweep.transpose_for_axis(v.gradient, p)
              if bool(tf.use_gradient) else None)
    gp = np.asarray([plan["wu0"], plan["dwu"], plan["cu"], plan["wv0"],
                     plan["dwv"], plan["cv"]], np.float32)
    Hi, Wi = plan["Hi"], plan["Wi"]
    gyi = jnp.arange(Hi, dtype=jnp.float32)[:, None] * jnp.ones((1, Wi))
    gxi = jnp.arange(Wi, dtype=jnp.float32)[None, :] * jnp.ones((Hi, 1))
    wu_g = jsp._mob_fwd(gp[0], gp[1], gp[2], gxi + 0.5)[ROWS, COLS]
    wv_g = jsp._mob_fwd(gp[3], gp[4], gp[5], gyi + 0.5)[ROWS, COLS]
    sgn = 1 if plan["sgn_p"] > 0 else -1
    n_slabs = int(max(2, round(vol_t.shape[0] * eng._slab_oversample(
        v, vol_t.shape, tf))))
    s_lo, s_hi, cov, kappa = jsb.grid_fields(u, wu_g, wv_g, sgn, p,
                                             max(vol_t.shape), n_slabs)
    grid = tuple(np.asarray(a) for a in (wu_g, wv_g, s_lo, s_hi, kappa, cov))
    pvm = (cam.proj.astype(np.float64) @ cam.view.astype(np.float64)
           @ v.model_matrix).astype(np.float32)
    return dict(u=u, p=p, plan=plan, sgn=sgn, n_slabs=n_slabs, vol_t=vol_t,
                occ_t=occ_t, grid=grid, pvm=pvm, tf=tf, maps=maps, ks=ks,
                grad_t=grad_t)


def _port_tf(s):
    return interop.tf_from_numpy({k: np.asarray(getattr(s["tf"], k))
                                  for k in ("sampling_factor",
                                            "voxel_alpha_factor",
                                            "grad_magnitude_modifier",
                                            "intensity_min",
                                            "intensity_range_inv",
                                            "gradient_min",
                                            "gradient_range_inv",
                                            "use_gradient")})


def _compare(s, ert):
    plan = s["plan"]
    ref = jsb._sweep_bricks_jit(
        s["vol_t"], s["occ_t"], s["tf"], None, s["u"], jnp.asarray(s["pvm"]),
        s["grad_t"], tuple(jnp.asarray(a) for a in s["grid"]), p_axis=s["p"],
        R=plan["R_brick"], ert=ert, test=JTest.NONE, count_samples=True,
        n_slabs=s["n_slabs"], sgn=s["sgn"], tile_h=plan["tile_h"],
        span_blks=plan["span_blks"], rect_w=plan["rect_w"],
        interpret=True, dist_leap=True, tent_prec="highest")
    tf = _port_tf(s)
    grad_t = s["grad_t"]
    out = tsb.sweep_bricks(
        interop.maps_from_numpy(np.asarray(s["vol_t"])),
        interop.maps_from_numpy(np.asarray(s["occ_t"])), tf,
        interop.uniforms_from_numpy(vars(s["u"])), s["pvm"],
        tuple(torch.tensor(a) for a in s["grid"]), p_axis=s["p"],
        ert=ert, count_samples=True, n_slabs=s["n_slabs"], sgn=s["sgn"],
        tile_h=plan["tile_h"], dist_leap=True,
        grad_t=(None if grad_t is None
                else interop.maps_from_numpy(np.asarray(grad_t))))
    want_c = np.asarray(ref.color)
    got_c = out.color.numpy()
    assert want_c[..., 3].max() > 0.3             # real content
    np.testing.assert_array_equal(out.num_volume_samples.numpy(),
                                  np.asarray(ref.num_volume_samples))
    np.testing.assert_allclose(got_c, want_c, rtol=0, atol=1e-5)
    want_d = np.asarray(ref.depth)
    got_d = out.depth.numpy()
    np.testing.assert_array_equal(got_d != 0, want_d != 0)   # same hits
    np.testing.assert_allclose(got_d, want_d, rtol=0, atol=1e-5)


@pytest.mark.parametrize("azimuth,ert", [(30.0, True), (30.0, False),
                                         (210.0, True)])
def test_brick_sweep_matches_pallas_interpret(engine, azimuth, ert):
    s = _setup(engine, azimuth)
    assert s["sgn"] == (-1 if azimuth == 30.0 else 1)
    assert s["n_slabs"] == s["vol_t"].shape[0] and s["grad_t"] is None
    _compare(s, ert)


@pytest.mark.parametrize("azimuth,ert", [(30.0, True), (210.0, False)])
def test_gradient_lerp_brick_sweep_matches_pallas_interpret(grad_engine,
                                                            azimuth, ert):
    s = _setup(grad_engine, azimuth)
    assert bool(s["tf"].use_gradient) and s["grad_t"] is not None
    Np = s["vol_t"].shape[0]
    assert s["n_slabs"] == 166 and Np == 49               # plane-pair lerp
    assert tsb.planes_per_brick(Np, s["n_slabs"]) == 5
    _compare(s, ert)


def test_octant_composite_and_transpose_match(engine):
    s = _setup(engine, 30.0)
    got = transpose_for_axis(
        _octant_composite(interop.maps_from_numpy(np.asarray(s["maps"])),
                          *s["ks"]), s["p"])
    np.testing.assert_array_equal(got.numpy(), np.asarray(s["occ_t"]))


def test_grid_fields_match(engine):
    """grid_fields in torch against JAX on the same w-grid (float32
    scalars combined the same way; 1-ulp-class differences allowed)."""
    s = _setup(engine, 30.0)
    wu, wv = (torch.tensor(a) for a in s["grid"][:2])
    got = tsb.grid_fields(interop.uniforms_from_numpy(vars(s["u"])), wu, wv,
                          s["sgn"], s["p"], max(s["vol_t"].shape),
                          s["n_slabs"])
    s_lo, s_hi, cov, kappa = (s["grid"][i] for i in (2, 3, 5, 4))
    np.testing.assert_array_equal(got[2].numpy(), cov)
    for g, w in ((got[0], s_lo), (got[1], s_hi), (got[3], kappa)):
        np.testing.assert_allclose(g.numpy()[cov], w[cov], rtol=2e-6,
                                   atol=2e-6)


@pytest.mark.parametrize("fixture", ["engine", "grad_engine"])
def test_reads_mark_the_sectors_the_samples_need(request, fixture):
    """The plain version's ``reads`` (the bytes side of K1's bound): the
    same outputs; some but not all of the volume's sectors (ESS skips
    empty space); ERT reads a subset of what the full sweep reads; the
    gradient map only where the volume was read."""
    s = _setup(request.getfixturevalue(fixture), 30.0)
    grad_t = s["grad_t"]
    tf = _port_tf(s)
    marked = {}
    for ert in (True, False):
        inp = tsb.brick_inputs(
            interop.maps_from_numpy(np.asarray(s["vol_t"])),
            interop.maps_from_numpy(np.asarray(s["occ_t"])), tf,
            interop.uniforms_from_numpy(vars(s["u"])),
            tuple(torch.tensor(a) for a in s["grid"]), p_axis=s["p"],
            ert=ert, count_samples=True, n_slabs=s["n_slabs"], sgn=s["sgn"],
            tile_h=s["plan"]["tile_h"], dist_leap=True,
            grad_t=(None if grad_t is None
                    else interop.maps_from_numpy(np.asarray(grad_t))))
        reads = {"vol": tsb.sector_map(inp.vol),
                 "grad": None if inp.grad is None else tsb.sector_map(inp.grad)}
        got = tsb.sweep_bricks_reference(inp, reads)
        for a, b in zip(got, tsb.sweep_bricks_reference(inp)):
            assert torch.equal(a, b)
        assert int(got[3].sum()) > 0
        vol = reads["vol"]
        assert vol.numel() == -(-inp.vol.numel() // 32)
        assert 0 < int(vol.sum()) < vol.numel()
        if grad_t is not None:
            g = reads["grad"]
            assert int(g.sum()) > 0 and not bool((g & ~vol).any())
        marked[ert] = reads
    for k, m in marked[True].items():
        if m is not None:
            assert not bool((m & ~marked[False][k]).any())
