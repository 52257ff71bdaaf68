"""The volume generator at a small scale on the CPU."""

import numpy as np
import pytest
import torch

from vkbench import data, run


@pytest.mark.parametrize("config", ["beetle-tfa-aniso", "snake-tfb-iso"])
def test_tfa_occupancy_pinned(config):
    spec = run.load_config(config)["volume"]
    vol, made = data.make_volume(spec, 2 ** 31 + 3, "cpu", scale=0.08)
    ti = data.occupied_threshold_u8(*spec["occupancy_tf"])
    occ = float((vol >= ti).to(torch.float64).mean()) * 100
    assert occ == pytest.approx(spec["occupancy_pct"], abs=0.01)
    assert made["occupied_pct"] == pytest.approx(occ)
    assert vol.dtype == torch.uint8
    assert tuple(vol.shape) == tuple(
        max(8, round(e * 0.08)) for e in spec["extent_xyz"][::-1])


@pytest.mark.parametrize("config", ["beetle-tfa-aniso", "snake-tfb-iso"])
def test_gradient_tf_calibrated(config):
    spec = run.load_config(config)["volume"]
    _, made = data.make_volume(spec, 11, "cpu", scale=0.1)
    target = spec["grad_calibration"]["target_pct"]
    # Within the secant's band, or its control at the end of its range
    # (the texture control c at its floor, the dither fraction at 1).
    assert (0.8 * target <= made["grad_occupied_pct"] <= 1.25 * target
            or made["calib_c"] == 0.01 or made["calib_rho"] == 1.0)


def test_dither_raises_gradient_occupancy():
    """A target above what the texture gives takes the dither."""
    spec = run.load_config("beetle-tfa-aniso")["volume"]
    spec = dict(spec, grad_calibration=dict(spec["grad_calibration"],
                                            target_pct=3.5))
    vol, made = data.make_volume(spec, 11, "cpu", scale=0.1)
    assert made["calib_rho"] is not None
    # The dither moves only voxels past the TF-a threshold, and keeps them
    # there.
    ti = data.occupied_threshold_u8(*spec["occupancy_tf"])
    assert float((vol >= ti).to(torch.float64).mean()) * 100 == \
        pytest.approx(spec["occupancy_pct"], abs=0.01)


def test_seed_fixes_the_volume():
    spec = run.load_config("beetle-tfa-aniso")["volume"]
    a, _ = data.make_volume(spec, 5, "cpu", scale=0.05)
    b, _ = data.make_volume(spec, 5, "cpu", scale=0.05)
    c, _ = data.make_volume(spec, 6, "cpu", scale=0.05)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)


def test_kth_smallest_exact():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(100_003, generator=g) * 3.0
    s = torch.sort(x).values
    for k in (0, 1, 5000, 50_001, 100_002):
        assert data.kth_smallest(x, k) == float(s[k])
    assert data.quantile(x, 0.9603) == pytest.approx(
        float(np.quantile(x.numpy(), 0.9603)), rel=1e-6)


def test_occupied_threshold():
    # 22/255 = 0.0863 > 0.086 >= 21/255; 102 * f32(1/255) rounds above
    # f32(0.4) in float32, the program's arithmetic.
    assert data.occupied_threshold_u8(0.086, 1.0) == 22
    assert data.occupied_threshold_u8(0.4, 0.8) == 102
