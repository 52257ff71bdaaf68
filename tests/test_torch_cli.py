"""The port's CLI (``vkvolume_tpu_torch.cli``, ``--device cpu``: the plain
PyTorch versions of the kernels) against the JAX package's CLI set-up with
its Pallas frame in interpret mode: the CLI's default render (synthetic
beetle at scale 0.1, skipmode 2 = isotropic distance map, gradient TF
imin 0.1 / gmax 0.2, brick sweep with the plane-pair lerp, n_slabs 166 !=
Np 49) at 256x304, the smallest size whose plan has the brick sweep and a
two-pass warp (variant B, as at 1280x720 on the full-scale beetle)."""

import functools
import subprocess
import sys

import numpy as np
import pytest

from vkvolume_tpu import cli as jcli
from vkvolume_tpu import utils as jutils
from vkvolume_tpu.camera import fit_distance as j_fit_distance
from vkvolume_tpu.camera import orbit_camera as j_orbit_camera
from vkvolume_tpu.render import sweep_pallas
from vkvolume_tpu_torch import cli as tcli
from vkvolume_tpu_torch.cli import cli_camera as cli_camera_t
from vkvolume_tpu_torch.options import SkippingType
from vkvolume_tpu_torch.utils.image import composite_over, read_png, to_u8
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

W, H = 256, 304
ARGS = ["--synth", "beetle", "--synth-scale", "0.1", "--width", str(W),
        "--height", str(H)]


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    png = str(tmp_path_factory.mktemp("cli") / "port.png")
    teng, tvols, tout = tcli.run(ARGS + ["--device", "cpu", "--output", png])
    with pytest.MonkeyPatch.context() as mp:
        # The JAX CLI's set-up, without its persistent compile cache; its
        # frame in interpret mode (on the CPU it would otherwise take the
        # XLA sweep).
        mp.setattr(jutils, "enable_compile_cache", lambda *a, **k: None)
        mp.setattr(sweep_pallas, "_frame_jit", functools.partial(
            sweep_pallas._frame_jit, interpret=True))
        jeng, jvols = jcli.setup_engine(jcli.build_parser().parse_args(ARGS))
        for v in jvols:
            jeng.add_volume(v)
        aspect = W / H
        cam = j_orbit_camera(
            radius=j_fit_distance(50.0, np.deg2rad(60.0), aspect) * 1.3,
            azimuth_deg=30.0, elevation_deg=20.0, aspect=aspect)
        jout = jeng.render(cam, W, H)
    assert jeng.last_renderer == "pallas"
    return dict(teng=teng, tvols=tvols, tout=tout, jeng=jeng, jvols=jvols,
                jout=jout, png=png)


def test_cli_defaults_are_the_reference_defaults():
    targs = tcli.build_parser().parse_args([])
    jargs = jcli.build_parser().parse_args([])
    for name, value in vars(jargs).items():
        assert getattr(targs, name) == value, name
    assert targs.device == "cuda"


def test_maps_and_volume_match_jax_cli(frames):
    teng, jeng = frames["teng"], frames["jeng"]
    tv, jv = teng.volumes[0], jeng.volumes[0]
    assert teng.options.skipping_type == SkippingType.DISTANCE
    np.testing.assert_array_equal(tv.density.numpy(), np.asarray(jv.density))
    np.testing.assert_array_equal(tv.gradient.numpy(), np.asarray(jv.gradient))
    assert tv.dist_maps.shape[0] == 1                 # the isotropic map
    np.testing.assert_array_equal(tv.dist_maps.numpy(),
                                  np.asarray(jv.dist_maps))
    np.testing.assert_allclose(tv.node_transform, jv.node_transform,
                               rtol=1e-6)


def test_default_frame_matches_jax_cli_frame(frames):
    teng = frames["teng"]
    pose = [p for k, p in teng.volumes[0]._sweep_cache.items()
            if isinstance(k, tuple) and k[0] == "pose"]
    assert len(pose) == 1
    plan = pose[0]["plan"]
    assert plan["R_brick"] is not None and plan["RECT_A"] is not None
    assert plan["warp_variant"] == "B"
    assert teng.last_renderer == "pallas"
    want = np.asarray(frames["jout"].color)
    got = frames["tout"].color.numpy()
    assert got.shape == (H, W, 4) and np.isfinite(got).all()
    assert (want[..., 3] > 0).mean() > 0.05           # real content
    # The JAX interpret warp is f32, the port's is u16-encoded, and ERT
    # threshold flips are possible: 2e-3 on >= 99.9 % of pixels.
    bad = (np.abs(got - want).max(axis=-1) > 2e-3).mean()
    assert bad <= 1e-3, bad
    assert abs(got[..., 3].mean() - want[..., 3].mean()) <= 1e-4


def test_png_is_the_composited_frame(frames):
    img = read_png(frames["png"])
    np.testing.assert_array_equal(
        img, to_u8(composite_over(frames["tout"].color.numpy())))
    assert (img.max(-1) > 0).mean() > 0.05


# One row per skipmode is left to run; the rest of the matrix is already in
# the CSVs, as after an interrupted sweep.
TO_RUN = {0: ("present", 2), 1: ("beetle-grad", 3), 2: ("snake", 5),
          3: ("beetle", 6)}


def test_sweep_flag_writes_the_four_csvs(tmp_path, monkeypatch):
    """``--sweep --device cpu`` writes the reference matrix's four CSVs in
    the JAX package's schema: 6 dataset/TF configurations x block sizes 2-6
    (skipmode 0 at block size 2 only), resuming from the rows already
    written."""
    from vkvolume_tpu.bench.harness import CSV_COLUMNS
    from vkvolume_tpu_torch.bench.datasets import DATASETS

    monkeypatch.chdir(tmp_path)
    for sm, todo in TO_RUN.items():
        with open(f"benchmark_results_{sm}.csv", "w") as fh:
            fh.write(",".join(CSV_COLUMNS) + "\n")
            for key, ds in DATASETS.items():
                for b in ((2,) if sm == 0 else (2, 3, 4, 5, 6)):
                    if (key, b) != todo:
                        fh.write(f"{key.split('-')[0]},{sm},{b},1.0,-1.0,0.0,"
                                 f"{ds.imin},{ds.imax},{ds.gmin},{ds.gmax}\n")
    assert tcli.main(["--sweep", "--device", "cpu", "--synth-scale", "0.05",
                      "--width", "128", "--height", "128", "--frames",
                      "1"]) == 0
    for sm, (key, b) in TO_RUN.items():
        with open(f"benchmark_results_{sm}.csv") as fh:
            rows = [line.rstrip("\n").split(",") for line in fh]
        assert rows[0] == CSV_COLUMNS
        assert len(rows) == 1 + (6 if sm == 0 else 30)
        new = rows[-1]
        ds = DATASETS[key]
        assert new[:3] == [key.split("-")[0], str(sm), str(b)]
        assert new[6:] == [str(ds.imin), str(ds.imax), str(ds.gmin),
                           str(ds.gmax)]
        assert float(new[3]) > 0 and float(new[4]) > 0
        assert all(r[4] == "-1.0" for r in rows[1:-1])


@pytest.mark.parametrize("flags", [
    ["--texture-tf"], ["--texture-tf", "--azimuth", "80", "--sampling",
                       "0.25"],
    ["--renderer", "sweep"], ["--test", "1"], ["--test", "2"]])
def test_ported_flags_match_jax_cli(tmp_path, flags):
    """The texture TF (a brick-sweep view, and the side view the XLA sweep
    takes), the XLA sweep renderer and the ray entry / exit frames through
    the port's CLI on the CPU, against the JAX CLI's set-up and frame at
    scale 0.05 (its Pallas frame in interpret mode)."""
    w, h = 256, 264
    args = ["--synth", "beetle", "--synth-scale", "0.05", "--width", str(w),
            "--height", str(h)] + flags
    png = str(tmp_path / "port.png")
    teng, _, tout = tcli.run(args + ["--device", "cpu", "--output", png])
    jargs = jcli.build_parser().parse_args(args)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jutils, "enable_compile_cache", lambda *a, **k: None)
        mp.setattr(sweep_pallas, "_frame_jit", functools.partial(
            sweep_pallas._frame_jit, interpret=True))
        jeng, jvols = jcli.setup_engine(jargs)
        for v in jvols:
            jeng.add_volume(v)
        aspect = w / h
        cam = j_orbit_camera(
            radius=j_fit_distance(50.0, np.deg2rad(60.0), aspect) * 1.3,
            azimuth_deg=jargs.azimuth, elevation_deg=20.0, aspect=aspect)
        jout = jeng.render(cam, w, h)
    route = "pallas" if flags == ["--texture-tf"] else "sweep"
    assert teng.last_renderer == jeng.last_renderer == route
    assert teng.options.texture_tf == jeng.options.texture_tf
    want = np.asarray(jout.color)
    got = tout.color.numpy()
    assert got.shape == (h, w, 4) and np.isfinite(got).all()
    assert (want[..., 3] > 0).mean() > 0.05           # real content
    if "--test" in flags:
        # Entry / exit positions from the f32 ray set-up (its matrix
        # products summed in another order): the XLA sweep's 1e-5.
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:
        bad = (np.abs(got - want).max(axis=-1) > 2e-3).mean()
        assert bad <= 1e-3, bad
        assert abs(got[..., 3].mean() - want[..., 3].mean()) <= 1e-4
    np.testing.assert_array_equal(read_png(png),
                                  to_u8(composite_over(got)))


def _win3(x, fill, op):
    """``op`` over each pixel's 3×3 window (edges padded with ``fill``)."""
    H, W = x.shape[:2]
    p = np.pad(x, [(1, 1), (1, 1)] + [(0, 0)] * (x.ndim - 2),
               constant_values=fill)
    return op(np.stack([p[i:i + H, j:j + W] for i in range(3)
                        for j in range(3)]), axis=0)


def _suspects(color, depth):
    """Edge repair's suspect mask of a frame (the engines' 3×3 range tests
    of alpha, depth and colour, dilated once) and, per pixel, how close
    the nearest of its three range terms lies to its threshold."""
    def rng3(x):
        return (_win3(x, -np.inf, np.max) - _win3(x, np.inf, np.min))

    terms = [(rng3(color[..., 3]), 0.04), (rng3(depth), 0.01),
             (rng3(color[..., :3]).max(-1), 0.08)]
    raw = np.zeros(depth.shape, bool)
    margin = np.full(depth.shape, np.inf)
    for t, thr in terms:
        raw |= t > thr
        margin = np.minimum(margin, np.abs(t - thr))
    return _win3(raw, False, np.any), margin


@pytest.mark.parametrize("flags,route", [
    (["--renderer", "marcher"], "marcher"), (["--edge-repair"], "pallas"),
    (["--scene"], "sweep")])
def test_marcher_repair_and_scene_flags_match_jax_cli(tmp_path, flags,
                                                      route):
    """The per-ray marcher, edge repair (the w-grid frame, then the
    marcher on its suspects) and the scene pass (the hall's depth clips
    the rays; the XLA sweep renders the frame) through the port's CLI on
    the CPU, against the JAX CLI's set-up and path at scale 0.05 (its
    Pallas frame in interpret mode)."""
    from vkvolume_tpu.render.forward import sponza_lite

    w, h = 256, 264
    args = ["--synth", "beetle", "--synth-scale", "0.05", "--width", str(w),
            "--height", str(h)] + flags
    png = str(tmp_path / "port.png")
    teng, _, tout = tcli.run(args + ["--device", "cpu", "--output", png])
    jargs = jcli.build_parser().parse_args(args)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jutils, "enable_compile_cache", lambda *a, **k: None)
        mp.setattr(sweep_pallas, "_frame_jit", functools.partial(
            sweep_pallas._frame_jit, interpret=True))
        jeng, jvols = jcli.setup_engine(jargs)
        for v in jvols:
            jeng.add_volume(v)
        aspect = w / h
        cam = j_orbit_camera(
            radius=j_fit_distance(50.0, np.deg2rad(60.0), aspect) * 1.3,
            azimuth_deg=30.0, elevation_deg=20.0, aspect=aspect)
        if "--scene" in flags:
            jout = jeng.render_with_scene(cam, w, h, sponza_lite())
        else:
            jout = jeng.render(cam, w, h)
    assert teng.last_renderer == jeng.last_renderer == route
    if "--edge-repair" in flags:
        # The suspects differ only where a mask term of a pixel's window
        # lies within 1e-4 of its threshold in either frame (the frames
        # before the repair differ by the warp's u16 encoding): 3 of the
        # 6034 JAX suspects at this pose (the port finds 6031).
        assert teng.last_repair_px[1] == int(jeng.last_repair_px[1])
        n_port, n_jax = teng.last_repair_px[0], int(jeng.last_repair_px[0])
        for e in (teng, jeng):
            e.options.edge_repair = False
        t0 = teng.render(cli_camera_t(w, h), w, h)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(sweep_pallas, "_frame_jit", functools.partial(
                sweep_pallas._frame_jit, interpret=True))
            j0 = jeng.render(cam, w, h)
        mt, margin_t = _suspects(t0.color.numpy(), t0.depth.numpy())
        mj, margin_j = _suspects(np.asarray(j0.color), np.asarray(j0.depth))
        assert (mt.sum(), mj.sum()) == (n_port, n_jax)
        near = _win3(np.minimum(margin_t, margin_j) <= 1e-4, False, np.any)
        differ = mt != mj
        assert not (differ & ~near).any()
        assert differ.sum() <= 1e-3 * n_jax, differ.sum()
    want = np.asarray(jout.color)
    got = tout.color.numpy()
    assert got.shape == (h, w, 4) and np.isfinite(got).all()
    assert (want[..., 3] > 0).mean() > 0.05           # real content
    bad = (np.abs(got - want).max(axis=-1) > 2e-3).mean()
    assert bad <= 1e-3, bad
    assert abs(got[..., 3].mean() - want[..., 3].mean()) <= 1e-4
    np.testing.assert_array_equal(read_png(png),
                                  to_u8(composite_over(got)))


def test_sweep_vs_marcher_gap_matches_jax_cli():
    """The share of covered pixels where the CLI's w-grid frame lies more
    than 8/255 from the marcher frame at the same pose (``chip_smoke.py``
    phase 9c's measure), in both packages at the CLI pose, scale 0.25 and
    384x216: 477 of the 6302 covered pixels (7.57 %) in each. The share
    depends on the volume's scale and the frame's size, so the packages
    are compared at one pose and size."""
    w, h = 384, 216
    args = ["--synth", "beetle", "--synth-scale", "0.25", "--width", str(w),
            "--height", str(h)]
    teng, _, tout = tcli.run(args + ["--device", "cpu"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jutils, "enable_compile_cache", lambda *a, **k: None)
        mp.setattr(sweep_pallas, "_frame_jit", functools.partial(
            sweep_pallas._frame_jit, interpret=True))
        jeng, jvols = jcli.setup_engine(jcli.build_parser().parse_args(args))
        for v in jvols:
            jeng.add_volume(v)
        aspect = w / h
        cam = j_orbit_camera(
            radius=j_fit_distance(50.0, np.deg2rad(60.0), aspect) * 1.3,
            azimuth_deg=30.0, elevation_deg=20.0, aspect=aspect)
        jout = jeng.render(cam, w, h)
    assert teng.last_renderer == jeng.last_renderer == "pallas"
    teng.renderer = jeng.renderer = "marcher"
    tm = teng.render(cli_camera_t(w, h), w, h)
    jm = jeng.render(cam, w, h)

    def gap(color, ref):
        covered = (ref[..., 3] > 0) | (color[..., 3] > 0)
        far = np.abs(color - ref).max(-1) > 8.0 / 255.0
        return int(far[covered].sum()), int(covered.sum())

    (n_t, cov_t), (n_j, cov_j) = (gap(tout.color.numpy(), tm.color.numpy()),
                                  gap(np.asarray(jout.color),
                                      np.asarray(jm.color)))
    assert n_j > 0.01 * cov_j                     # a gap worth comparing
    assert abs(n_t - n_j) <= 1e-3 * cov_j, (n_t, cov_t, n_j, cov_j)


def test_no_cuda_device_fails_loudly():
    """--device cuda (the default) never falls back to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.setup_engine(tcli.build_parser().parse_args([]))


def test_cli_module_entry_point(tmp_path):
    """``python -m vkvolume_tpu_torch.cli`` on the CPU writes a PNG."""
    png = tmp_path / "o.png"
    subprocess.run([sys.executable, "-m", "vkvolume_tpu_torch.cli",
                    "--synth", "beetle", "--synth-scale", "0.05", "--width",
                    "256", "--height", "264", "--device", "cpu", "--output",
                    str(png)], check=True, capture_output=True)
    assert read_png(str(png)).shape == (264, 256, 3)
