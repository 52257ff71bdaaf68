"""The distance kernels' own algorithms, stated in plain PyTorch
(``relax_search``: a search per cell over windowed-minimum levels;
``relax_walk``: runs of cells, the first by the search, each next by one
step from its neighbour; ``axis_scan_linear``: the x-scan's two linear
passes), against the JAX package's ``relax`` / ``axis_scan`` and
``relax_pallas`` in interpret mode. All integer: bit-exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vkvolume_tpu.accel import distance as jdist
from vkvolume_tpu.accel import distance_pallas as jpal
from vkvolume_tpu_torch.accel import distance as tdist
from torch_threads import one_torch_thread  # noqa: F401


def _occ(seed, shape, p):
    rng = np.random.default_rng(seed)
    return np.where(rng.random(shape) < p, 0, 255).astype(np.uint8)


def _scanned(occ, cap=255, direction=0):
    """The x-scan of an occupancy map (u8), capped as the octant maps are
    (63) or not (255)."""
    return tdist.axis_scan(torch.from_numpy(occ), 2, direction).clamp(
        max=cap).to(torch.uint8).numpy()


def _one_occupied(shape):
    occ = np.full(shape, 255, np.uint8)
    occ[shape[0] // 2, shape[1] // 2, shape[2] // 3] = 0
    return occ


# u8 maps to relax: x-scanned occupancy capped at 63 and uncapped, X off
# multiples of 32; edges: all 255 (no occupied cell), one occupied cell
# (distances up to 255), lines of 1, 2 and 3 cells along z and y.
CASES = {
    "capped 63, (5, 7, 33)": lambda: _scanned(_occ(1, (5, 7, 33), 0.05), 63,
                                              1),
    "uncapped, (3, 130, 9)": lambda: _scanned(_occ(2, (3, 130, 9), 0.01)),
    "all 255": lambda: np.full((4, 5, 33), 255, np.uint8),
    "one occupied cell": lambda: _scanned(_one_occupied((6, 40, 70))),
    "lines of 1": lambda: _scanned(_occ(3, (1, 1, 40), 0.1)),
    "lines of 2": lambda: _scanned(_occ(4, (2, 2, 40), 0.1)),
    "lines of 3": lambda: _scanned(_occ(5, (3, 3, 40), 0.05), 63, -1),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("direction", [0, 1, -1])
def test_search_and_walk_match_jax_relax(case, axis, direction):
    D = CASES[case]()
    want = np.asarray(jdist.relax(jnp.asarray(D), axis, direction))
    np.testing.assert_array_equal(
        np.asarray(jpal.relax_pallas(jnp.asarray(D), axis, direction,
                                     interpret=True)), want)
    d = torch.from_numpy(D)
    np.testing.assert_array_equal(
        tdist.relax_search(d, axis, direction).numpy(), want)
    # Runs of one cell (search only), of a few, and longer than the line.
    for run in (1, 3, 16, 300):
        np.testing.assert_array_equal(
            tdist.relax_walk(d, axis, direction, run).numpy(), want)


@pytest.mark.parametrize("shape,p", [((5, 7, 33), 0.05), ((3, 130, 9), 0.01),
                                     ((2, 3, 1), 0.5), ((4, 2, 300), 0.0)])
@pytest.mark.parametrize("direction", [0, 1, -1])
def test_linear_scan_matches_axis_scan(shape, p, direction):
    """The two linear passes against the closed form (cumulative minima)
    and the JAX ``axis_scan``; p = 0: no occupied cell, distances past 255
    before the cap."""
    occ = _occ(6, shape, p)
    got = tdist.axis_scan_linear(torch.from_numpy(occ), 2, direction)
    np.testing.assert_array_equal(
        got.numpy(), tdist.axis_scan(torch.from_numpy(occ), 2,
                                     direction).numpy())
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jdist.axis_scan(jnp.asarray(occ), 2,
                                                direction)))
