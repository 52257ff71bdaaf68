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


@pytest.mark.parametrize("flags,item", [
    (["--renderer", "marcher"], "item 10"), (["--scene"], "item 16"),
    (["--edge-repair"], "items 10 and 11"), (["--sweep"], "item 12"),
    (["--gradient_test"], "item 5")])
def test_unported_flags_raise(flags, item):
    args = tcli.build_parser().parse_args(["--device", "cpu"] + flags)
    with pytest.raises(NotImplementedError, match=f"ROADMAP queue A, {item}"):
        tcli.setup_engine(args)


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
