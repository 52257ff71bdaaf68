"""Anisotropic distance maps: the port's plain PyTorch transform (the plain
version of K3/K4) against the JAX package's Pallas kernels (interpret
mode), its XLA transform and brute force. All integer: bit-exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vkvolume_tpu.accel import distance as jdist
from vkvolume_tpu.accel import distance_pallas as jpal
from vkvolume_tpu_torch.accel import distance as tdist
from vkvolume_tpu_torch.accel import distance_cuda


def _occ(seed, shape, p):
    rng = np.random.default_rng(seed)
    return np.where(rng.random(shape) < p, 0, 255).astype(np.uint8)


# Shapes off the (8, 128) tiling, one taller than the cap, one with an
# x extent past 128 lanes.
CASES = [((9, 11, 13), 0.1), ((13, 7, 140), 0.03), ((24, 20, 16), 0.07)]


@pytest.mark.parametrize("shape,p", CASES)
def test_aniso_matches_pallas_interpret(shape, p):
    occ = _occ(1, shape, p)
    want = np.asarray(jpal.anisotropic_distance_pallas(jnp.asarray(occ),
                                                       interpret=True))
    got = tdist.anisotropic_distance(torch.from_numpy(occ)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,p", CASES)
def test_aniso_matches_xla(shape, p):
    occ = _occ(2, shape, p)
    want = np.asarray(jdist.anisotropic_distance(jnp.asarray(occ)))
    got = tdist.anisotropic_distance(torch.from_numpy(occ)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cap", [15, 255])
def test_aniso_cap(cap):
    """Sparse occupancy: the cap binds, and the capped maps are exactly the
    elementwise min of the uncapped maps and the cap, as in JAX."""
    occ = _occ(3, (24, 32, 40), 0.004)
    full = tdist.anisotropic_distance(torch.from_numpy(occ), cap=255).numpy()
    got = tdist.anisotropic_distance(torch.from_numpy(occ), cap=cap).numpy()
    assert (full > 15).any()
    np.testing.assert_array_equal(got, np.minimum(full, cap))
    want = np.asarray(jpal.anisotropic_distance_pallas(
        jnp.asarray(occ), cap=cap, interpret=True))
    np.testing.assert_array_equal(got, want)


def test_stages_match_pallas_stages():
    """K3 and K4's plain versions against the JAX stage functions."""
    occ = _occ(4, (10, 12, 14), 0.08)
    xys = jpal.scan_and_relax_multi(jnp.asarray(occ), (1, -1), (1, -1),
                                    interpret=True, cap=63)
    got_xy = tdist.scan_and_relax_multi(torch.from_numpy(occ), 63)
    np.testing.assert_array_equal(got_xy.numpy(),
                                  np.stack([np.asarray(a) for a in xys]))
    zs = jpal.relax_z_direct_multi(xys, (1, -1), interpret=True)
    got_z = tdist.relax_z_direct_multi(got_xy)
    np.testing.assert_array_equal(got_z.numpy(),
                                  np.stack([np.asarray(a) for a in zs]))


@pytest.mark.parametrize("idx", range(8))
def test_octant_map_matches_brute_force(idx):
    occ = _occ(5, (6, 7, 9), 0.06)
    maps = tdist.anisotropic_distance(torch.from_numpy(occ), cap=255).numpy()
    d = (-1 if idx & 4 else 1, -1 if idx & 2 else 1, -1 if idx & 1 else 1)
    np.testing.assert_array_equal(maps[idx],
                                  tdist.brute_force_chebyshev(occ, d))


def test_wrapper_runs_plain_version_for_cpu_tensors():
    occ = torch.from_numpy(_occ(6, (8, 9, 10), 0.1))
    before = dict(distance_cuda.LAUNCHES)
    got = distance_cuda.anisotropic_distance_cuda(occ)
    assert distance_cuda.LAUNCHES == before        # no kernel launched
    np.testing.assert_array_equal(got.numpy(),
                                  tdist.anisotropic_distance(occ).numpy())
