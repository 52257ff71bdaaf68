"""On-the-fly gradients (``use_precomputed_gradient`` off, the CLI's
``--gradient_test``): the port's engine and CLI on the CPU against the
JAX package's, which compute the gradients inside every map build and in
the marcher, and, holding no gradient map, send gradient-TF frames of the
w-grid renderer to the XLA sweep with gradient 1.0.

Tolerances: the maps bit-exact; the XLA sweep's frame as in
``tests/test_torch_sweep_xla.py`` (coverage and sample counts exact,
colour within 1e-5); the marcher's and the w-grid frame's as in
``tests/test_torch_cli.py`` (2e-3 on >= 99.9 % of the pixels, mean alpha
within 1e-4)."""

import functools

import numpy as np
import pytest

from vkvolume_tpu import cli as jcli
from vkvolume_tpu import utils as jutils
from vkvolume_tpu.camera import fit_distance as j_fit_distance
from vkvolume_tpu.camera import orbit_camera as j_orbit_camera
from vkvolume_tpu.render import sweep_pallas
from vkvolume_tpu_torch import cli as tcli
from vkvolume_tpu_torch.utils.image import composite_over, read_png, to_u8
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

W, H = 256, 264


def _jax_cli(args, w, h):
    """The JAX CLI's set-up, volumes added, and its frame at the CLI pose
    (its Pallas frame in interpret mode)."""
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
        return jeng, jeng.render(cam, w, h)


def _frame_within(got, want):
    bad = (np.abs(got - want).max(axis=-1) > 2e-3).mean()
    assert bad <= 1e-3, bad
    assert abs(got[..., 3].mean() - want[..., 3].mean()) <= 1e-4


@pytest.mark.parametrize("flags,route", [
    ([], "sweep"),                          # gradient TF, no map: XLA sweep
    (["--renderer", "marcher"], "marcher"),  # gradients on the fly
    (["--gmax", "0", "--skipmode", "3"], "pallas"),  # no gradient term
    (["--imin", "0.6", "--imax", "0.1"], "sweep"),   # and an inverted TF
])
def test_gradient_test_flag_matches_jax_cli(tmp_path, flags, route):
    args = ["--synth", "beetle", "--synth-scale", "0.05", "--width", str(W),
            "--height", str(H), "--gradient_test"] + flags
    png = str(tmp_path / "port.png")
    teng, _, tout = tcli.run(args + ["--device", "cpu", "--output", png])
    jeng, jout = _jax_cli(args, W, H)
    assert teng.last_renderer == jeng.last_renderer == route
    tv, jv = teng.volumes[0], jeng.volumes[0]
    assert tv.gradient is None and jv.gradient is None
    assert not tv.options.use_precomputed_gradient
    np.testing.assert_array_equal(tv.dist_maps.numpy(),
                                  np.asarray(jv.dist_maps))
    want = np.asarray(jout.color)
    got = tout.color.numpy()
    assert got.shape == (H, W, 4) and np.isfinite(got).all()
    assert (want[..., 3] > 0).mean() > 0.05           # real content
    if route == "sweep":
        np.testing.assert_array_equal(got[..., 3] > 0, want[..., 3] > 0)
        np.testing.assert_array_equal(tout.num_volume_samples.numpy(),
                                      np.asarray(jout.num_volume_samples))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:
        _frame_within(got, want)
    np.testing.assert_array_equal(read_png(png), to_u8(composite_over(got)))


def test_on_the_fly_maps_equal_the_precomputed_maps():
    """On the fly or precomputed, the gradients are the same: the port's
    maps with ``--gradient_test`` equal its maps without, at skipmodes 2
    and 3, and only the frame's route differs (the XLA sweep without a
    gradient map, the brick sweep with one)."""
    import torch

    args = ["--synth", "beetle", "--synth-scale", "0.05", "--width", str(W),
            "--height", str(H), "--device", "cpu"]
    for sm in ("2", "3"):
        on_fly, _, _ = tcli.run(args + ["--skipmode", sm, "--gradient_test"])
        pre, _, _ = tcli.run(args + ["--skipmode", sm])
        assert torch.equal(on_fly.volumes[0].dist_maps,
                           pre.volumes[0].dist_maps)
        assert on_fly.renderer_counts == {"pallas": 0, "sweep": 1,
                                          "marcher": 0}
        assert pre.last_renderer == "pallas"
