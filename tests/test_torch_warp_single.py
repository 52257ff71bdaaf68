"""K8, the single-pass warp: the port's ``warp_to_pixels`` (its plain
version on CPU tensors) against the JAX package's ``_warp_reference``, the
function the JAX frame computes for this warp on a CPU, with the same grid
channels and positions: uncovered pixels (gx < -5), positions on, inside
and beyond the grid's edges, the three channels of a frame and the four of
the benchmark mode. Bit-equal: both take the same float32 operations."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vkvolume_tpu.render import sweep_pallas
from vkvolume_tpu_torch.render import warp_cuda


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
