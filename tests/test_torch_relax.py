"""K6, one uncapped Chebyshev relaxation along z or y: the port's
``distance_cuda.relax`` (its plain version on CPU tensors) against the JAX
package's ``relax_pallas`` in interpret mode and its XLA ``distance.relax``,
on x-scanned occupancy maps off the (8, 128) tiling, every axis and sense.
All integer: bit-exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vkvolume_tpu.accel import distance as jdist
from vkvolume_tpu.accel import distance_pallas as jpal
from vkvolume_tpu_torch.accel import distance as tdist
from vkvolume_tpu_torch.accel import distance_cuda


def _scanned(seed, shape, p):
    """A two-sided x-scan of a random occupancy map (u8, distances up to
    255 where a row holds no occupied cell)."""
    rng = np.random.default_rng(seed)
    occ = np.where(rng.random(shape) < p, 0, 255).astype(np.uint8)
    return tdist.axis_scan(torch.from_numpy(occ), 2, 0).clamp(
        max=255).to(torch.uint8).numpy()


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("direction", [0, 1, -1])
@pytest.mark.parametrize("shape,p", [((9, 11, 13), 0.05),
                                     ((21, 10, 140), 0.01)])
def test_relax_matches_relax_pallas_interpret_and_xla(axis, direction, shape,
                                                      p):
    D = _scanned(axis * 10 + direction + 5, shape, p)
    want = np.asarray(jpal.relax_pallas(jnp.asarray(D), axis, direction,
                                        interpret=True))
    np.testing.assert_array_equal(
        np.asarray(jdist.relax(jnp.asarray(D), axis, direction)).astype(
            np.uint8), want)
    before = dict(distance_cuda.LAUNCHES)
    got = distance_cuda.relax(torch.from_numpy(D), axis, direction)
    assert distance_cuda.LAUNCHES == before            # no kernel on the CPU
    assert got.dtype == torch.uint8 and got.shape == D.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want < D).any()                            # it relaxed something


@pytest.mark.parametrize("axis,direction", [(2, 0), (0, 2)])
def test_relax_refuses_other_axes_and_senses(axis, direction):
    with pytest.raises(ValueError, match="axis"):
        distance_cuda.relax(torch.zeros((2, 3, 4), dtype=torch.uint8), axis,
                            direction)
