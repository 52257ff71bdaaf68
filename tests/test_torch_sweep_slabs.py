"""K7, the per-slab sweep: the port's stage (``sweep_slabs``, its plain
version on CPU tensors) against the JAX package's Pallas kernel in
interpret mode, with the same rays, maps and TF. Two ray sets: the w-grid
rays of a frame plan on the synthetic beetle at scale 0.1 through
``_sweep_pallas_jit(separable=True)`` (the frame's sampler), and the pixel
rays of ``tests/test_sweep.py``'s zoomed-in geometry through
``sweep_pallas`` (the general sampler; a camera's pixel rays over the
whole beetle exceed that sampler's footprint limits). Sample counts exact;
first-hit depths within 1e-5 (float32 rounding of the depth projection; a
slab off would move them far more); lum and alpha within 1e-5, because the
JAX tent sums its two rows in another order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vkvolume_tpu.accel import gradient_map, isotropic_distance
from vkvolume_tpu.accel import occupancy as jocc
from vkvolume_tpu.bench import harness as jh
from vkvolume_tpu.render import frustum as jfr
from vkvolume_tpu.render import ray_setup as jrs
from vkvolume_tpu.render import sweep as jsweep
from vkvolume_tpu.render import sweep_pallas as jsp
from vkvolume_tpu.tf import tf_params
from vkvolume_tpu_torch import interop
from vkvolume_tpu_torch.render import frustum as tfr
from vkvolume_tpu_torch.render import ray_setup as trs
from vkvolume_tpu_torch.render import sweep_slabs
from vkvolume_tpu_torch.render.sweep_bricks import sector_map
from test_sweep import _pallas_setup
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _scene(key):
    eng, _, vol, _ = jh.make_engine(key, 2, 4, scale=0.1)
    v = eng.volumes[0]
    tf = eng._tf(v)
    occ = jocc.occupancy_map(v.density, v.gradient if tf.use_gradient
                             else None, tf, v.map_shape_zyx)
    return dict(eng=eng, v=v, tf=tf, dist=v.dist_maps[0], occ=occ)


@pytest.fixture(scope="module")
def scenes():
    return {"intensity": _scene("beetle"), "gradient": _scene("beetle-grad")}


def _uniforms(v, w, h, az):
    cam = jh.benchmark_camera(aspect=w / h, azimuth=az)
    u = jrs.make_uniforms(cam, v.node_transform, v.image_transform, 1.0,
                          np.asarray(v.effective_block_size_xyz, np.float32))
    pvm = (cam.proj.astype(np.float64) @ cam.view.astype(np.float64)
           @ v.model_matrix).astype(np.float32)
    return u, pvm


def _port_rays(r):
    t = lambda a: torch.from_numpy(np.asarray(a))
    return trs.RaySetup(ray_dir=t(r.ray_dir), valid=t(r.valid),
                        depth_init=t(r.depth_init), entry=t(r.entry),
                        exit=t(r.exit))


def _grid_rays(sc, az):
    """The w-grid rays and principal axis of the frame plan at a 384x256
    benchmark pose (the frame's own dirs → rays_from_dirs)."""
    v = sc["v"]
    w, h = 384, 256
    u, pvm = _uniforms(v, w, h, az)
    dsh = tuple(v.density.shape)
    view, plan = jsp.select_view_plan(
        u, h, w, lambda q: {2: dsh, 1: (dsh[1], dsh[0], dsh[2]),
                            0: (dsh[2], dsh[0], dsh[1])}[q])
    p = view["p_axis"]
    v_ax, u_ax = jsweep._SLICE_AXES[p]
    Hi, Wi = plan["Hi"], plan["Wi"]
    gyi, gxi = np.mgrid[0:Hi, 0:Wi].astype(np.float32)
    wu = jsp._mob_fwd(plan["wu0"], plan["dwu"], plan["cu"], gxi + 0.5)
    wv = jsp._mob_fwd(plan["wv0"], plan["dwv"], plan["cv"], gyi + 0.5)
    sg = np.float32(plan["sgn_p"])
    dirs = [None] * 3
    dirs[p] = jnp.full((Hi, Wi), sg)
    dirs[u_ax] = jnp.asarray(wu) * sg
    dirs[v_ax] = jnp.asarray(wv) * sg
    dirs = jnp.stack(dirs, -1)
    dirs = dirs / jnp.linalg.norm(dirs, axis=-1, keepdims=True)
    return u, pvm, p, jfr.rays_from_dirs(u, dirs), plan


def _compare(jout, tout, count):
    want_c = np.asarray(jout.color)
    got_c = tout.color.numpy()
    assert (want_c[..., 3] > 0.05).mean() > 0.02          # real content
    np.testing.assert_allclose(got_c, want_c, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tout.depth.numpy(), np.asarray(jout.depth),
                               rtol=0, atol=1e-5)
    hit = lambda a: np.asarray(a)[..., 3] > 0
    np.testing.assert_array_equal(hit(got_c), hit(want_c))
    n = tout.num_volume_samples.numpy()
    np.testing.assert_array_equal(n, np.asarray(jout.num_volume_samples))
    assert (n.max() > 0) == count


# (TF, distance-map leaps, ERT, sample counting, eye)
PIXEL_CASES = [("intensity", True, True, True, (0.3, 0.2, 8.0)),
               ("intensity", False, False, True, (0.3, 0.2, -8.0)),
               ("gradient", True, True, False, (0.3, 0.2, 8.0)),
               ("gradient", False, False, True, (-0.4, 0.3, -8.0))]


@pytest.mark.parametrize("tfk,leap,ert,count,eye", PIXEL_CASES)
def test_pixel_rays_match_sweep_pallas_interpret(tfk, leap, ert, count, eye):
    """The general sampler on a camera's pixel rays (``sweep_pallas``,
    which also picks the rect height R)."""
    vol, tf, u, rays, occ, pvm = _pallas_setup(eye=eye)
    grad = None
    if tfk == "gradient":
        tf = tf_params(intensity_min=0.2, gradient_min=0.05,
                       gradient_max=0.4)
        grad = gradient_map(jnp.asarray(vol), 1.0, use_gradient=True)
        D, Hs, Ws = vol.shape
        occ = jocc.occupancy_map(jnp.asarray(vol), grad, tf,
                                 (-(-D // 4), -(-Hs // 4), -(-Ws // 4)))
    p = jsweep.principal_axis(rays)
    vol_t = jsweep.transpose_for_axis(jnp.asarray(vol), p)
    occ_t = jsweep.transpose_for_axis(isotropic_distance(occ) if leap
                                      else occ, p)
    grad_t = None if grad is None else jsweep.transpose_for_axis(grad, p)
    jout = jsp.sweep_pallas(vol_t, occ_t, tf, rays, u, pvm, grad_t,
                            p_axis=p, ert=ert, count_samples=count,
                            interpret=True, dist_leap=leap)
    tout = sweep_slabs.sweep_slabs(
        torch.from_numpy(np.asarray(vol_t)),
        torch.from_numpy(np.asarray(occ_t)),
        interop.tf_from_numpy(vars(tf)), _port_rays(rays),
        interop.uniforms_from_numpy(vars(u)), np.asarray(pvm),
        None if grad_t is None else torch.from_numpy(np.asarray(grad_t)),
        p_axis=p, ert=ert, count_samples=count,
        n_slabs=vol_t.shape[0], dist_leap=leap)
    _compare(jout, tout, count)


# (TF, distance-map leaps, ERT, sample counting, azimuth, slab density)
GRID_CASES = [("intensity", True, False, True, 30.0, 0.5),
              ("intensity", False, True, False, 40.0, 1.0),
              ("gradient", True, True, True, 30.0, 0.5),
              ("gradient", True, False, True, 210.0, 2.0)]


@pytest.mark.parametrize("tfk,leap,ert,count,az,density", GRID_CASES)
def test_grid_rays_match_separable_kernel_interpret(scenes, tfk, leap, ert,
                                                    count, az, density):
    """The frame's sampler on w-grid rays (``_sweep_pallas_jit`` with
    ``separable=True``), fewer or more slabs than voxel planes; the port
    builds the same rays with its ``rays_from_dirs``."""
    sc = scenes[tfk]
    v, tf = sc["v"], sc["tf"]
    u, pvm, p, rays, plan = _grid_rays(sc, az)
    vol_t = jsweep.transpose_for_axis(v.density, p)
    occ_t = jsweep.transpose_for_axis(sc["dist"] if leap else sc["occ"], p)
    grad_t = (jsweep.transpose_for_axis(v.gradient, p) if tf.use_gradient
              else None)
    n_slabs = int(round(vol_t.shape[0] * density))
    jout = jsp._sweep_pallas_jit(
        vol_t, occ_t, tf, rays, u, jnp.asarray(pvm), grad_t, p_axis=p,
        R=plan["R_sweep"], ert=ert, test=jsp.Test.NONE, count_samples=count,
        n_slabs=n_slabs, interpret=True, separable=True, dist_leap=leap)
    tu = interop.uniforms_from_numpy(vars(u))
    port_rays = tfr.rays_from_dirs(tu, torch.from_numpy(
        np.asarray(rays.ray_dir)))
    for name in ("valid", "entry", "exit"):
        np.testing.assert_allclose(
            getattr(port_rays, name).numpy(), np.asarray(getattr(rays, name)),
            rtol=0, atol=2e-7)
    tout = sweep_slabs.sweep_slabs(
        torch.from_numpy(np.asarray(vol_t)),
        torch.from_numpy(np.asarray(occ_t)),
        interop.tf_from_numpy(vars(tf)), _port_rays(rays), tu, pvm,
        None if grad_t is None else torch.from_numpy(np.asarray(grad_t)),
        p_axis=p, ert=ert, count_samples=count, n_slabs=n_slabs,
        separable=True, dist_leap=leap)
    _compare(jout, tout, count)


def test_wrapper_runs_plain_version_for_cpu_tensors(scenes):
    sc = scenes["intensity"]
    v, tf = sc["v"], sc["tf"]
    u, _, p, rays, _ = _grid_rays(sc, 30.0)
    vol_t = torch.from_numpy(np.asarray(jsweep.transpose_for_axis(
        v.density, p)))
    occ_t = torch.from_numpy(np.asarray(jsweep.transpose_for_axis(
        sc["dist"], p)))
    inp = sweep_slabs.slab_inputs(
        vol_t, occ_t, interop.tf_from_numpy(vars(tf)), _port_rays(rays),
        interop.uniforms_from_numpy(vars(u)), p_axis=p, ert=True,
        count_samples=True, n_slabs=24, dist_leap=True, separable=True)
    before = dict(sweep_slabs.LAUNCHES)
    got = sweep_slabs.sweep_slabs_kernel(inp)
    assert sweep_slabs.LAUNCHES == before              # no kernel launched
    want = sweep_slabs.sweep_slabs_plain(inp)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert int(got[3].sum()) > 0


def test_reads_mark_the_sectors_the_samples_need(scenes):
    """The plain version's ``reads`` (the bytes side of K7's bound), on the
    gradient TF: the same outputs; some but not all of the volume's
    sectors; ERT reads a subset of what the full sweep reads; the gradient
    map only where the volume was read."""
    sc = scenes["gradient"]
    v, tf = sc["v"], sc["tf"]
    u, _, p, rays, _ = _grid_rays(sc, 30.0)
    vol_t, grad_t, occ_t = (torch.from_numpy(np.asarray(
        jsweep.transpose_for_axis(a, p))) for a in (v.density, v.gradient,
                                                    sc["dist"]))
    marked = {}
    for ert in (True, False):
        inp = sweep_slabs.slab_inputs(
            vol_t, occ_t, interop.tf_from_numpy(vars(tf)), _port_rays(rays),
            interop.uniforms_from_numpy(vars(u)), grad_t, p_axis=p, ert=ert,
            count_samples=True, n_slabs=vol_t.shape[0] // 2, dist_leap=True,
            separable=True)
        reads = {"vol": sector_map(vol_t), "grad": sector_map(grad_t)}
        got = sweep_slabs.sweep_slabs_plain(inp, reads)
        for a, b in zip(got, sweep_slabs.sweep_slabs_plain(inp)):
            assert torch.equal(a, b)
        assert int(got[3].sum()) > 0
        vol, g = reads["vol"], reads["grad"]
        assert 0 < int(vol.sum()) < vol.numel()
        assert int(g.sum()) > 0 and not bool((g & ~vol).any())
        marked[ert] = reads
    for k, m in marked[True].items():
        assert not bool((m & ~marked[False][k]).any())
