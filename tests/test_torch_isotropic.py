"""Isotropic distance map (skipmode 2): the port's plain PyTorch transform
(the plain version of K5 and the two-sided K4) against the JAX package's
XLA transform, its Pallas kernels in interpret mode and brute force. All
integer: bit-exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vkvolume_tpu.accel import distance as jdist
from vkvolume_tpu.accel import distance_pallas as jpal
from vkvolume_tpu_torch.accel import distance as tdist
from vkvolume_tpu_torch.accel import distance_cuda


def _occ(seed, shape, p):
    """Random occupancy; p=0 leaves one occupied cell at the origin."""
    rng = np.random.default_rng(seed)
    occ = np.where(rng.random(shape) < p, 0, 255).astype(np.uint8)
    if p == 0:
        occ[0, 0, 0] = 0
    return occ


# Shapes off the (8, 128) tiling, one with an x extent past 128 lanes, and
# a sparse one whose distances run far past the octant maps' cap of 63.
CASES = [((9, 11, 13), 0.1), ((13, 7, 140), 0.03), ((24, 20, 16), 0.07),
         ((70, 9, 80), 0.0)]


@pytest.mark.parametrize("shape,p", CASES)
def test_isotropic_matches_xla(shape, p):
    occ = _occ(1, shape, p)
    want = np.asarray(jdist.isotropic_distance(jnp.asarray(occ)))
    got = tdist.isotropic_distance(torch.from_numpy(occ)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,p", CASES[:3])
def test_isotropic_matches_pallas_interpret(shape, p):
    occ = _occ(2, shape, p)
    want = np.asarray(jpal.isotropic_distance_pallas(jnp.asarray(occ),
                                                     interpret=True))
    got = tdist.isotropic_distance(torch.from_numpy(occ)).numpy()
    np.testing.assert_array_equal(got, want)


def test_isotropic_is_uncapped():
    """Sparse occupancy: values past ANISO_CAP survive, as in JAX."""
    occ = _occ(3, (70, 9, 80), 0.0)
    got = tdist.isotropic_distance(torch.from_numpy(occ)).numpy()
    assert got.max() == 79 > tdist.ANISO_CAP


def test_stages_match_pallas_stages():
    """K5 and the two-sided K4's plain versions against the JAX stage
    functions (``scan_and_relax`` / ``relax_z_direct`` with (0,))."""
    occ = _occ(4, (10, 12, 14), 0.05)
    xy = jpal.scan_and_relax(jnp.asarray(occ), scan_dir=0, relax_dirs=(0,),
                             interpret=True)
    got_xy = tdist.scan_and_relax(torch.from_numpy(occ), 0, (0,))
    assert got_xy.shape == (1, 10, 12, 14)
    np.testing.assert_array_equal(got_xy[0].numpy(), np.asarray(xy[0]))
    z = jpal.relax_z_direct(xy[0], relax_dirs=(0,), interpret=True)
    got_z = tdist.relax_z_direct(got_xy[0], (0,))
    np.testing.assert_array_equal(got_z[0].numpy(), np.asarray(z[0]))


@pytest.mark.parametrize("seed", [5, 6])
def test_isotropic_matches_brute_force(seed):
    occ = _occ(seed, (6, 7, 9), 0.04)
    got = tdist.isotropic_distance(torch.from_numpy(occ)).numpy()
    np.testing.assert_array_equal(got, tdist.brute_force_chebyshev(occ))


def test_empty_map_is_all_255():
    occ = np.full((5, 6, 7), 255, np.uint8)
    got = tdist.isotropic_distance(torch.from_numpy(occ)).numpy()
    assert (got == 255).all()


def test_wrapper_runs_plain_version_for_cpu_tensors():
    occ = torch.from_numpy(_occ(7, (8, 9, 10), 0.1))
    before = dict(distance_cuda.LAUNCHES)
    got = distance_cuda.isotropic_distance_cuda(occ)
    assert distance_cuda.LAUNCHES == before        # no kernel launched
    assert got.shape == (1, 8, 9, 10)
    np.testing.assert_array_equal(got[0].numpy(),
                                  tdist.isotropic_distance(occ).numpy())
