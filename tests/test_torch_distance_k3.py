"""K3's algorithm, stated in plain PyTorch
(``distance.scan_and_relax_multi_tiled``: x-tiles whose one-sided capped
scans see only ``cap - 1`` cells beyond the tile, y-segments with a halo
of ``cap`` rows, ``relax_walk`` runs in both y senses), against the plain
``scan_and_relax_multi`` and the JAX package's ``scan_and_relax_multi``
in interpret mode. All integer: bit-exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vkvolume_tpu.accel import distance_pallas as jpal
from vkvolume_tpu_torch.accel import distance as tdist
from vkvolume_tpu_torch.accel import distance_cuda
from torch_threads import one_torch_thread  # noqa: F401


def _occ(seed, shape, p):
    rng = np.random.default_rng(seed)
    return np.where(rng.random(shape) < p, 0, 255).astype(np.uint8)


def _one_occupied(shape):
    occ = np.full(shape, 255, np.uint8)
    occ[shape[0] // 2, shape[1] // 2, shape[2] // 3] = 0
    return occ


# Occupancy maps: X off multiples of 4 and of 32, Y of 1-3, all 255 (no
# occupied cell), one occupied cell (distances up to the cap and past it).
MAPS = {
    "(3, 9, 37)": lambda: _occ(1, (3, 9, 37), 0.04),
    "(2, 40, 70)": lambda: _occ(2, (2, 40, 70), 0.01),
    "Y 1, (2, 1, 45)": lambda: _occ(3, (2, 1, 45), 0.1),
    "Y 2, (2, 2, 33)": lambda: _occ(4, (2, 2, 33), 0.05),
    "Y 3, (1, 3, 66)": lambda: _occ(5, (1, 3, 66), 0.05),
    "all 255, (2, 7, 35)": lambda: np.full((2, 7, 35), 255, np.uint8),
    "one occupied cell, (3, 30, 67)": lambda: _one_occupied((3, 30, 67)),
}

# (columns, seg_len, run): one tile per line, tiles of 4 and 32 columns,
# segments shorter than the halo, runs of one cell and of several.
TILINGS = [(1 << 20, 1 << 20, 300), (4, 1 << 20, 3), (32, 5, 16),
           (8, 11, 1)]


@pytest.mark.parametrize("cap", [1, 15, 63, 255])
@pytest.mark.parametrize("case", list(MAPS))
def test_tiled_k3_matches_plain_and_jax(case, cap):
    occ = MAPS[case]()
    want = np.stack([np.asarray(a) for a in jpal.scan_and_relax_multi(
        jnp.asarray(occ), (1, -1), (1, -1), interpret=True, cap=cap)])
    occ_t = torch.from_numpy(occ)
    plain = tdist.scan_and_relax_multi(occ_t, cap)
    np.testing.assert_array_equal(plain.numpy(), want)
    assert int(plain.max()) <= cap
    for columns, seg_len, run in TILINGS:
        got = tdist.scan_and_relax_multi_tiled(
            occ_t, cap, columns=columns, seg_len=seg_len, run=run)
        np.testing.assert_array_equal(got.numpy(), want,
                                      err_msg=f"{columns}, {seg_len}, {run}")


def test_wrapper_checks_cap_and_runs_plain_version_on_cpu():
    occ = torch.from_numpy(_occ(6, (2, 5, 9), 0.1))
    before = dict(distance_cuda.LAUNCHES)
    got = distance_cuda.scan_and_relax_multi(occ, 15)
    assert distance_cuda.LAUNCHES == before
    np.testing.assert_array_equal(
        got.numpy(), tdist.scan_and_relax_multi(occ, 15).numpy())
    for cap in (0, 256):
        with pytest.raises(ValueError):
            distance_cuda.scan_and_relax_multi(occ, cap)
