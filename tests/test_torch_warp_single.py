"""K8, the single-pass warp: the port's ``warp_to_pixels`` (its plain
version on CPU tensors) against the JAX package's ``_warp_reference``, the
function the JAX frame computes for this warp on a CPU, with the same grid
channels and positions: uncovered pixels (gx < -5), positions on, inside
and beyond the grid's edges, the three channels of a frame and the four of
the benchmark mode. Bit-equal: both take the same float32 operations.
Then K8's per-tile path (``torch_k8_views.tile_paths``, the host statement
of the kernel's staged / two-pass / direct / empty choice) on planned K8
views, on random positions and on the card tests' small cases."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vkvolume_tpu.render import sweep_pallas
from vkvolume_tpu_torch.render import warp_cuda
from torch_k8_views import (K8_CASES, PATHS, STAGE_BYTES, TILE_W, VIEWS,
                            k8_positions, k8_view, tile_paths)


def _positions(rng, H, W, Hi, Wi):
    gx = rng.uniform(-3.0, Wi + 2.0, (H, W)).astype(np.float32)
    gy = rng.uniform(-3.0, Hi + 2.0, (H, W)).astype(np.float32)
    # Uncovered pixels, and the exact edges and corners of the grid.
    gx[rng.random((H, W)) < 0.1] = -10.0
    gx[0, :4] = (0.0, Wi - 1.0, Wi - 1.5, -4.9)
    gy[0, :4] = (Hi - 1.0, 0.0, Hi - 0.5, 0.0)
    gx[1, :3] = (np.nextafter(np.float32(Wi - 1), np.float32(0)), 0.5, -5.0)
    gy[1, :3] = (np.nextafter(np.float32(Hi - 1), np.float32(0)), -0.0, 3.0)
    return gx, gy


@pytest.mark.parametrize("C,H,W,Hi,Wi", [(3, 16, 128, 24, 40),
                                         (4, 8, 256, 64, 640),
                                         (3, 24, 128, 1, 7)])
def test_warp_to_pixels_matches_warp_reference(C, H, W, Hi, Wi):
    rng = np.random.default_rng(C * 1000 + Wi)
    chans = rng.random((C, Hi, Wi)).astype(np.float32)
    if C == 4:
        chans[3] = rng.integers(0, 400, (Hi, Wi))        # sample counts
    gx, gy = _positions(rng, H, W, Hi, Wi)
    want = np.asarray(sweep_pallas._warp_reference(
        jnp.asarray(chans), jnp.asarray(gx), jnp.asarray(gy)))
    before = dict(warp_cuda.LAUNCHES)
    got = warp_cuda.warp_to_pixels(torch.from_numpy(chans),
                                   torch.from_numpy(gx), torch.from_numpy(gy))
    assert warp_cuda.LAUNCHES == before                # no kernel on the CPU
    assert got.shape == (C, H, W) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy()[:, gx < -5.0] == 0.0).all()
    assert (got.numpy()[:, gx > -5.0] != 0.0).any()


def test_warp_to_pixels_checks_its_positions():
    chans = torch.zeros((3, 8, 8))
    with pytest.raises(ValueError, match="gx"):
        warp_cuda.warp_to_pixels(chans, torch.zeros((4, 4)),
                                 torch.zeros((4, 5)))


@pytest.mark.parametrize("case", K8_CASES)
def test_k8_cases_take_their_paths(case):
    """Each small card case (tests/test_torch_cuda.py) sends its covered
    tiles down the path it is meant to test, by ``tile_paths``, which the
    card tests hold the kernel's counters to: random positions over a
    grid of more than one row, every covered tile direct; patches, none
    direct, a "wide" one in two passes; the first tile row empty."""
    C, Hi, Wi, H, W, kind, _, src_off = case
    rng = np.random.default_rng(C * Wi + W)
    gx, gy = k8_positions(kind, H, W, Hi, Wi, rng)
    got = tile_paths(torch.from_numpy(gx), torch.from_numpy(gy), Hi, Wi, C,
                     src_vec=Wi % 4 == 0 and src_off % 16 == 0)
    assert got["empty"] >= -(-W // TILE_W), got
    covered = sum(got[k] for k in PATHS[1:])
    assert covered > 0, got
    assert got["direct"] == (covered if kind == "random" and Hi > 1
                             else 0), got
    if kind == "wide":
        assert got["two_passes"] > 0, got


@pytest.mark.parametrize("name", sorted(VIEWS))
def test_planned_k8_views_stage_every_covered_tile(name):
    """The views the plan sends to K8 at full scale (the side view
    ``--azimuth 80 --sampling 0.25`` and the five K8 poses of the
    benchmark orbit, 1280x720) stage every covered tile's rects in K8's
    budget; the orbit's azimuths 85-95 in one pass. The CLI's 384x256
    still frame at beetle scale 0.1 plans a grid three times its pixels:
    its densest tiles pass the budget and read global memory, and twice
    the budget stages them all. Random positions over the same grids
    stage nothing."""
    gx, gy, Hi, Wi, C = k8_view(name)
    got = tile_paths(gx, gy, Hi, Wi, C)
    covered = sum(got[k] for k in PATHS[1:])
    assert got["staged"] > covered // 2, got
    if name == "cli_small":
        assert 0 < got["direct"] < covered // 5, got
        assert tile_paths(gx, gy, Hi, Wi, C, 2 * STAGE_BYTES)["direct"] == 0
    else:
        assert got["direct"] == 0, got
    if name in ("orbit_85", "orbit_90", "orbit_95"):
        assert got["staged"] == covered, got
    rng = np.random.default_rng(0)
    rx = torch.from_numpy(rng.uniform(0, Wi, gx.shape).astype(np.float32))
    ry = torch.from_numpy(rng.uniform(0, Hi, gx.shape).astype(np.float32))
    rand = tile_paths(rx, ry, Hi, Wi, C)
    assert rand["direct"] == sum(got.values()), rand
