"""The port's multi-device modes (``vkvolume_tpu_torch/parallel``) on 8
gloo ranks on the CPU, mirroring ``tests/test_parallel.py`` (the JAX
package on its 8-device CPU mesh) at its shapes.

Every case runs in ONE spawned group of 8 ranks (``parallel.spawn``,
module fixture ``spmd``, started in a thread by the first test that
needs it, with its own deadline: a hung collective fails the tests
instead of the suite's time limit). The ranks run
``tests/torch_spmd_cases.py``, which imports no jax; this process builds
the inputs with the JAX package, and computes the JAX references and the
port's single-device references meanwhile.

Tolerances: the row-sharded march and the sharded frame equal the port's
single-device march / frame where both take the same sweep (error 0:
rows and grid tiles are independent); the sharded frame whose ranks must
take the per-slab sweep (K7) where the single-device frame takes the
brick sweep (K1) is held at JAX's own 1e-4. Against JAX: the march within
the marcher's port-vs-JAX bound (``tests/test_torch_marcher.py``), the
frame within 1e-4, the volume-sharded modes at ``tests/test_parallel.py``'s
tolerances against the single-device march / brick sweep."""

from __future__ import annotations

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vkvolume_tpu.accel import isotropic_distance as j_iso
from vkvolume_tpu.accel import occupancy_map as j_occ
from vkvolume_tpu.bench.harness import benchmark_camera as j_bench_cam
from vkvolume_tpu.camera import orbit_camera as j_orbit
from vkvolume_tpu.options import SkippingType as JSkip
from vkvolume_tpu.parallel import make_mesh as j_make_mesh
from vkvolume_tpu.parallel import march_sharded as j_march_sharded
from vkvolume_tpu.parallel import render_frame_sharded as j_frame_sharded
from vkvolume_tpu.render import make_rays as j_make_rays
from vkvolume_tpu.render import make_uniforms as j_make_uniforms
from vkvolume_tpu.render import plan as j_plan
from vkvolume_tpu.render import sweep as j_sweep
from vkvolume_tpu.render import sweep_bricks as j_sb
from vkvolume_tpu.render import sweep_pallas as jsp
from vkvolume_tpu.render import warp_pallas as j_warp
from vkvolume_tpu.render.marcher_xla import RenderOutput as JRenderOutput
from vkvolume_tpu.tf import tf_params as j_tf_params
from vkvolume_tpu.utils import math3d as j_math3d
from vkvolume_tpu_torch.parallel import spawn
from vkvolume_tpu_torch.render import plan as plan_mod
from vkvolume_tpu_torch.render import sweep_bricks as sb
from vkvolume_tpu_torch.render import sweep_frame as sf
from vkvolume_tpu_torch.render.marcher import march

import torch_spmd_cases as cases
from test_render import _march as j_march
from test_render import _setup
from test_sweep import _frame_setup as j_sweep_setup
from scalar_reference import march_ray
from test_torch_marcher import _maps, _tf_dict
from torch_threads import one_torch_thread  # noqa: F401 (autouse)
from util import sphere_shell_volume

N_RANKS = 8
DEADLINE_S = 240.0       # the group's own deadline, far inside the suite's


def _fields(obj) -> dict:
    return {f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


def _march_case(vol, size, skip, mode="march", count=False):
    s = _setup(vol, size=size)
    case = dict(mode=mode, vol=vol, grad=np.asarray(s["grad"]),
                maps=_maps(s, skip), tf=_fields(s["tf"]),
                rays=cases.rays_numpy(s["rays"]),
                bs=np.asarray(s["bs"]), pvm=np.asarray(s["pvm"]),
                skip=int(skip), count=count)
    return case, s


def _pvm(cam, node, img_t):
    return (cam.proj.astype(np.float64) @ cam.view.astype(np.float64)
            @ (node @ img_t).astype(np.float64)).astype(np.float32)


def _frame_scene(n, H, W, cam):
    """The sphere shell with its isotropic distance map, transposed for
    the view's axis, in JAX arrays (the JAX references) and a frame case
    (numpy, for the ranks)."""
    vol = sphere_shell_volume(n)
    tf = j_tf_params(intensity_min=0.1, gradient_min=0.0, gradient_max=0.0)
    node = j_math3d.scale((100.0 / n,) * 3)
    img_t = j_math3d.scale((float(n),) * 3)
    u = j_make_uniforms(cam, node, img_t, 50.0, (4.0, 4.0, 4.0))
    rays = j_make_rays(u, H, W)
    m = -(-n // 4)
    dist = j_iso(j_occ(jnp.asarray(vol), None, tf, (m, m, m)))
    pvm = _pvm(cam, node, img_t)
    p = j_sweep.principal_axis(rays)
    vol_t = j_sweep.transpose_for_axis(jnp.asarray(vol), p)
    dist_t = j_sweep.transpose_for_axis(dist, p)
    jax_side = (vol_t, dist_t, tf, rays, u, jnp.asarray(pvm), p)
    case = dict(mode="frame", vol=np.asarray(vol_t), maps=np.asarray(dist_t),
                tf=_fields(tf), rays=cases.rays_numpy(rays),
                uniforms=_fields(u), pvm=pvm, p=p)
    return jax_side, case


def _port_plan(case, H, W, variant=None):
    """The port's plan of a frame case, its warp forced to ``variant``."""
    x = cases.inputs(case)
    plan = sf.plan_frame(x["uniforms"], x["rays"], case["p"],
                         case["vol"].shape, H, W)
    if variant is not None:
        view = plan_mod.analyze_view(x["uniforms"], H, W)
        tp = plan_mod.two_pass_warp_plan(x["uniforms"], case["p"], H, W,
                                         plan, view, only_variant=variant)
        assert tp is not None, variant
        plan = dict(plan, **tp)
    return plan


def _build_cases():
    """Every case of the module (numpy) and what the tests need beside."""
    c, extra = {}, {}
    shell = sphere_shell_volume(32)
    c["march24"], extra["march24"] = _march_case(shell, 24, JSkip.DISTANCE,
                                                 count=True)
    c["march16"], _ = _march_case(shell, 16, JSkip.DISTANCE)
    c["rows12"], _ = _march_case(shell, 12, JSkip.BLOCK)
    c["vol24"], extra["vol24"] = _march_case(shell, 24, JSkip.DISTANCE,
                                             "march_volume")
    c["vol16_none"], extra["vol16_none"] = _march_case(
        shell, 16, JSkip.NONE, "march_volume")
    c["vol16_none"]["maps"] = None
    full = np.full((32, 32, 32), 255, np.uint8)
    c["vol_ert"], extra["vol_ert"] = _march_case(full, 24, JSkip.DISTANCE,
                                                 "march_volume")

    # tests/test_parallel.py's frame: 40^3 shell at 64x128.
    cam = j_orbit(radius=150.0, azimuth_deg=25, elevation_deg=15,
                  aspect=128 / 64)
    extra["frame64"], c["frame64"] = _frame_scene(40, 64, 128, cam)
    # A size whose plan has the brick sweep and the two-pass warp, with
    # 64 grid rows per rank (tile_h 32): variant A (the planner's) and B.
    H, W = 256, 512
    extra["frame_2pass"], case = _frame_scene(40, H, W,
                                              j_bench_cam(W / H, azimuth=25))
    for v in "AB":
        c[f"frame{v}"] = dict(case, plan=_port_plan(case, H, W, v))

    # tests/test_sweep.py's scene for the volume-sharded sweep.
    vol_t, _, dist_t, tf, rays, u, pvm, p = j_sweep_setup(25.0)
    extra["sweep"] = (vol_t, dist_t, tf, rays, u, pvm, p)
    H, W = rays.valid.shape
    for ert in (False, True):
        c[f"sweep_ert{int(ert)}"] = dict(
            mode="sweep_volume", vol=np.asarray(vol_t),
            maps=np.asarray(dist_t), tf=_fields(tf),
            rays=cases.rays_numpy(rays), uniforms=_fields(u),
            pvm=np.asarray(pvm), p=p, height=H, width=W, ert=ert)
    return c, extra


class _Group:
    """The spawned group, run in a thread while the tests compute their
    references."""

    def __init__(self):
        self.cases, self.extra = _build_cases()
        self._out, self._err = None, None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            self._out = spawn(cases.run_cases, N_RANKS, backend="gloo",
                              device="cpu", args=(self.cases,),
                              timeout=DEADLINE_S)
        except BaseException as e:  # re-raised in the tests' thread
            self._err = e

    def results(self) -> list:
        """Every rank's results (rank order)."""
        self._thread.join(DEADLINE_S + 60.0)
        if self._err is not None:
            raise self._err
        assert self._out is not None, "the group did not finish"
        return self._out

    def get(self, name: str, rank: int = 0):
        return self.results()[rank][name]


@pytest.fixture(scope="module")
def spmd():
    return _Group()


def _port_march(case):
    x = cases.inputs(case)
    return march(x["vol"], x["grad"], x.get("maps"), x["tf"], x["rays"],
                 case["bs"], case["pvm"], **cases.march_options(case))


def _assert_same_frame(got: dict, want):
    for k in ("color", "depth"):
        np.testing.assert_array_equal(got[k], getattr(want, k).numpy(), k)


# ------------------------------------------------------------ the ranks


def test_a_hung_rank_fails_within_the_deadline(spmd):
    # ``spmd``: the module's group runs meanwhile.
    with pytest.raises(TimeoutError, match="did not finish"):
        spawn(cases.hang, 2, backend="gloo", device="cpu", timeout=10.0)


def test_eight_ranks_of_one_group(spmd):
    res = spmd.results()
    assert len(res) == N_RANKS
    assert [r["march16"]["rank"] for r in res] == list(range(N_RANKS))


# ------------------------------------------------------ march_sharded


def test_sharded_march_matches_single_device(spmd):
    case, s = spmd.cases["march24"], spmd.extra["march24"]
    got = spmd.get("march24")["full"]
    want = _port_march(case)
    for k in cases.OUT_FIELDS:
        np.testing.assert_array_equal(got[k], getattr(want, k).numpy(), k)
    assert got["iterations"] == want.iterations
    assert got["color"][..., 3].max() > 0.3
    # Against JAX's march_sharded on its 8-device mesh: the per-pixel
    # bounds of tests/test_torch_marcher.py. Its share bound (2 % of the
    # covered pixels) is 2.96 pixels here and 3 flip (XLA's CPU FMAs), so
    # every flipped pixel is held to the scalar oracle instead: the port
    # takes exactly the oracle's events there.
    jout = j_march_sharded(
        j_make_mesh(8), jnp.asarray(case["vol"]), s["grad"],
        jnp.asarray(case["maps"]), s["tf"], s["rays"], jnp.asarray(s["bs"]),
        s["pvm"], skipping_type=JSkip.DISTANCE, early_ray_termination=True,
        count_samples=True)
    valid = np.asarray(s["rays"].valid)
    same = np.ones(valid.shape, bool)
    for k in cases.OUT_FIELDS[2:]:
        d = np.abs(got[k] - np.asarray(getattr(jout, k)))
        assert d.max() <= 2, k
        same &= d == 0
    dc = np.abs(got["color"] - np.asarray(jout.color)).max(-1)
    assert dc[same].max() <= 1e-5 and dc.max() <= 0.05
    assert abs(got["iterations"] - int(jout.iterations)) <= 2
    flipped = np.argwhere(valid & ~same)
    assert len(flipped) <= 0.05 * valid.sum()
    for py, px in flipped:
        color, counters, _ = march_ray(
            volume=case["vol"], gradient_map=case["grad"],
            dist_maps=case["maps"], entry=case["rays"]["entry"][py, px],
            ray_dir=case["rays"]["ray_dir"][py, px],
            ray_distance=float(case["rays"]["ray_distance"][py, px]),
            block_size=case["bs"], skipping="distance", ert=True,
            tf=_tf_dict(s), precomputed_gradient=True)
        assert [int(got[k][py, px]) for k in cases.OUT_FIELDS[2:]] == [
            counters["n_vol"], counters["n_dist"], counters["n_empty"]]
        np.testing.assert_allclose(got["color"][py, px], color, atol=2e-4)


def test_sharded_output_is_sharded(spmd):
    res = [r["march16"] for r in spmd.results()]
    for k in cases.OUT_FIELDS:
        rows = [r["local"][k] for r in res]
        assert all(a.shape[0] == 16 // N_RANKS for a in rows)
        np.testing.assert_array_equal(np.concatenate(rows), res[0]["full"][k])
        for r in res[1:]:
            np.testing.assert_array_equal(r["full"][k], res[0]["full"][k])
    want = _port_march(spmd.cases["march16"])
    np.testing.assert_array_equal(res[0]["full"]["color"],
                                  want.color.numpy())


def test_mesh_size_validation(spmd):
    for r in spmd.results():
        assert "not divisible" in r["rows12"]["error"]


# ---------------------------------------------------- render_frame_sharded


def test_sharded_render_frame_matches_single_device(spmd):
    """tests/test_parallel.py's frame: its 64 grid rows give each of the 8
    ranks 8 rows, fewer than the plan's brick tile (32), so the ranks take
    the per-slab sweep: equal to the single-device frame planned onto that
    sweep, and within JAX's 1e-4 of the brick-swept one and of JAX's."""
    case = spmd.cases["frame64"]
    jv, jd, jtf, jrays, ju, jpvm, p = spmd.extra["frame64"]
    want_j = jsp.render_frame(jv, jd, jtf, jrays, ju, jpvm, p_axis=p,
                              ert=True, interpret=True, dist_leap=True)
    x = cases.inputs(case)
    plan = _port_plan(case, 64, 128)
    assert (plan["Hi"] // N_RANKS) % plan["tile_h"]
    kw = dict(p_axis=p, ert=True, dist_leap=True)
    single = sf.render_frame(x["vol"], x["maps"], x["tf"], x["rays"],
                             x["uniforms"], case["pvm"], **kw)
    per_slab = sf.render_planned(x["vol"], x["maps"], x["tf"], x["rays"],
                                 x["uniforms"], case["pvm"], None,
                                 dict(plan, R_brick=None), **kw)
    got = spmd.get("frame64")
    assert got["local_rows"] == 64 // N_RANKS
    _assert_same_frame(got["full"], per_slab)
    assert got["full"]["color"][..., 3].max() > 0.3
    for want in (single.color.numpy(), np.asarray(want_j.color)):
        np.testing.assert_allclose(got["full"]["color"], want, atol=1e-4)
    np.testing.assert_allclose(got["full"]["depth"], np.asarray(want_j.depth),
                               atol=1e-4)


@pytest.mark.parametrize("variant", ["A", "B"])
def test_sharded_two_pass_frame_equals_single_device(spmd, variant):
    """The two-pass warp (K2 twice) under sharding, in either factorisation
    order: each rank sweeps 64 grid rows through the brick sweep and warps
    its 32 image rows; the frame equals the single-device frame of the
    same plan."""
    case = spmd.cases[f"frame{variant}"]
    plan = case["plan"]
    assert plan["RECT_A"] is not None and plan["warp_variant"] == variant
    assert (plan["Hi"] // N_RANKS) % plan["tile_h"] == 0
    x = cases.inputs(case)
    want = sf.render_planned(x["vol"], x["maps"], x["tf"], x["rays"],
                             x["uniforms"], case["pvm"], None, plan,
                             p_axis=case["p"], ert=True, dist_leap=True)
    got = spmd.get(f"frame{variant}")["full"]
    assert got["color"][..., 3].max() > 0.3
    _assert_same_frame(got, want)


def test_jax_variant_b_solves_pass_one_at_local_rows(monkeypatch, spmd):
    """A gap of the JAX package, not of the port: JAX's ``_pixel_stage``
    under ``shard_map`` solves variant B's first-pass positions at the
    shard's LOCAL row numbers (``iir`` counts 0..Hp in every shard), so a
    variant-B frame is right on the first shard only. Shown on what JAX's
    ``render_frame_sharded`` hands the warp (its sweep and warp are
    replaced by stand-ins: in interpret mode they take minutes at a
    two-pass size): each image row gets the sum of its pass-1 positions.
    The port's sharded variant-B frame equals its single-device frame."""
    vol_t, dist_t, tf, rays, u, pvm, p = spmd.extra["frame_2pass"]
    H, W = rays.valid.shape
    plan_b = jsp.plan_frame(u, rays, p, vol_t.shape, H, W)
    plan_b = dict(plan_b, **j_plan.two_pass_warp_plan(
        u, p, H, W, plan_b, j_plan.analyze_view(u, H, W), only_variant="B"))
    monkeypatch.setattr(jsp, "plan_frame", lambda *a, **k: plan_b)

    def sweep(vol_t, occ, tf, tex, u, pvm, grad, fields, **kw):
        z = jnp.zeros(fields[0].shape, jnp.float32)
        zi = jnp.zeros(z.shape, jnp.int32)
        return JRenderOutput(color=jnp.stack([z + 0.5] * 4, -1), depth=z,
                                num_volume_samples=zi,
                                num_distance_samples=zi,
                                num_empty_samples=zi, iterations=1)

    def warp_b(chans, yb, gx_p, **kw):
        sig = jnp.where(yb > -5.0, yb, 0.0).sum(axis=0) * 1e-6
        return jnp.broadcast_to(sig[None, :, None],
                                (chans.shape[0], yb.shape[1],
                                 gx_p.shape[1]))

    monkeypatch.setattr(j_sb, "_sweep_bricks_jit", sweep)
    monkeypatch.setattr(j_warp, "warp_two_pass_b", warp_b)
    n = 2
    def frame(k):
        mesh = j_make_mesh(k)
        # Jitted: eager shard_map compiles every primitive on its own.
        return np.asarray(jax.jit(
            lambda v, d, r, u_, m: j_frame_sharded(
                mesh, v, d, tf, r, u_, m, p_axis=p, ert=True, interpret=True,
                dist_leap=True).color)(vol_t, dist_t, rays, u, pvm))[..., 0]

    outs = [frame(k) for k in (1, n)]
    one, two = outs
    h = H // n
    assert np.abs(one).max() > 0
    np.testing.assert_array_equal(two[:h], one[:h])       # first shard
    # Every later shard repeats the first shard's rows.
    np.testing.assert_array_equal(two[h:], one[:h])
    assert np.abs(two[h:] - one[h:]).max() > 0.1 * np.abs(one).max()
    # The port solves each rank's rows at their image rows.
    test_sharded_two_pass_frame_equals_single_device(spmd, "B")


# ------------------------------------------------------ march_volume_sharded


def _hold_volume_march(spmd, name, skip):
    """tests/test_parallel.py's tolerances against the single-device march
    of either package."""
    case, s = spmd.cases[name], spmd.extra[name]
    got = spmd.get(name)
    for r in spmd.results()[1:]:
        np.testing.assert_array_equal(r[name]["color"], got["color"])
    a_j = j_march(case["vol"], s, skip)
    a_t = _port_march(case)
    b = got["color"]
    for a, depth in ((np.asarray(a_j.color), np.asarray(a_j.depth)),
                     (a_t.color.numpy(), a_t.depth.numpy())):
        assert a[..., 3].max() > 0.3
        assert np.abs(a - b).max() < 0.06
        assert abs(a[..., 3].mean() - b[..., 3].mean()) < 2e-3
        np.testing.assert_allclose(got["depth"], depth, atol=2e-2)
    return np.asarray(a_j.color), a_t.color.numpy(), b


def test_volume_sharded_march_close_to_single_device(spmd):
    _hold_volume_march(spmd, "vol24", JSkip.DISTANCE)


def test_volume_sharded_march_skipmode_none(spmd):
    _hold_volume_march(spmd, "vol16_none", JSkip.NONE)


def test_volume_sharded_ert_worst_case_bound(spmd):
    """All-bright volume: ERT fires in the first slab and the later ones
    over-composite at the remaining transmittance T < 0.01 (the derived
    bound of tests/test_parallel.py), plus f32 rebasing slack."""
    case, s = spmd.cases["vol_ert"], spmd.extra["vol_ert"]
    a = np.asarray(j_march(case["vol"], s, JSkip.DISTANCE).color)
    covered = a[..., 3] > 0.0
    assert covered.any() and (a[covered][:, 3] > 0.99).all()
    b = spmd.get("vol_ert")["color"]
    assert np.abs(a - b).max() <= 0.0105
    assert np.abs(_port_march(case).color.numpy() - b).max() <= 0.0105


# ------------------------------------------------------ sweep_volume_sharded


def _grid(u, plan, p, shape, dev="cpu"):
    Np, Sv, Su = shape
    gp = [plan["wu0"], plan["dwu"], plan.get("cu") or 0.0,
          plan["wv0"], plan["dwv"], plan.get("cv") or 0.0]
    wu, wv = sf.w_grid(gp, plan["Hi"], plan["Wi"], dev)
    sgn = 1 if plan["sgn_p"] > 0 else -1
    s_lo, s_hi, cov, kappa = sb.grid_fields(u, wu, wv, sgn, p,
                                            max(Np, Sv, Su), Np)
    return (wu, wv, s_lo, s_hi, kappa, cov), sgn


@pytest.mark.parametrize("ert", [False, True])
def test_volume_sharded_production_sweep(spmd, ert):
    """Per-rank plane slabs through the unchanged brick sweep in rebased
    local texture space, over-composed in slab order: within 2e-3 of the
    single-device brick sweep of the same plan (0.011 with ERT, its
    cross-slab tail), the port's and, without ERT, JAX's."""
    case = spmd.cases[f"sweep_ert{int(ert)}"]
    x = cases.inputs(case)
    H, W, p = case["height"], case["width"], case["p"]
    shape = case["vol"].shape
    _, plan = sf.select_view_plan(x["uniforms"], H, W, lambda q: shape)
    assert plan.get("R_brick") is not None
    grid, sgn = _grid(x["uniforms"], plan, p, shape)
    ref = sb.sweep_bricks(x["vol"], x["maps"], x["tf"], x["uniforms"],
                          case["pvm"], grid, p_axis=p, ert=ert,
                          count_samples=False, n_slabs=shape[0], sgn=sgn,
                          tile_h=plan["tile_h"], dist_leap=True)
    refs = [(ref.color.numpy(), ref.depth.numpy())]
    if not ert:
        vol_t, dist_t, tf, _, u, pvm, _ = spmd.extra["sweep"]
        Hi, Wi = plan["Hi"], plan["Wi"]
        gyi = jax.lax.broadcasted_iota(jnp.float32, (Hi, Wi), 0)
        gxi = jax.lax.broadcasted_iota(jnp.float32, (Hi, Wi), 1)
        wu_g = jsp._mob_fwd(plan["wu0"], plan["dwu"], plan.get("cu") or 0.0,
                            gxi + 0.5)
        wv_g = jsp._mob_fwd(plan["wv0"], plan["dwv"], plan.get("cv") or 0.0,
                            gyi + 0.5)
        g = j_sb.grid_fields(u, wu_g, wv_g, sgn, p, max(shape), shape[0])
        jref = j_sb._sweep_bricks_jit(
            vol_t, dist_t, tf, None, u, pvm, None,
            (wu_g, wv_g) + g[:2] + g[3:4] + g[2:3], p_axis=p,
            R=plan["R_brick"], ert=ert, test=None, count_samples=False,
            n_slabs=shape[0], sgn=sgn, tile_h=plan["tile_h"],
            span_blks=plan["span_blks"], rect_w=plan.get("rect_w", 256),
            interpret=True, dist_leap=True)
        refs.append((np.asarray(jref.color), np.asarray(jref.depth)))
    got = spmd.get(f"sweep_ert{int(ert)}")
    oc, od = got["color"], got["depth"]
    tol = 0.011 if ert else 2e-3
    for rc, rd in refs:
        assert rc[..., 3].max() > 0.3
        assert np.abs(oc - rc).max() < tol, np.abs(oc - rc).max()
        m = (rd != 0) & (od != 0)
        np.testing.assert_allclose(od[m], rd[m], atol=1e-3)
        assert ((rd != 0) == (od != 0)).mean() > 0.995
