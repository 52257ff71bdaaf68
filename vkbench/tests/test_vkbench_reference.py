"""The reference against cases with a closed form."""

import numpy as np
import torch

from vkbench import pose as P, reference

TF = {"intensity_min": 0.0, "intensity_max": 1.0, "gradient_min": 0.0,
      "gradient_max": 0.0}
MODEL = np.diag([100.0, 100.0, 100.0, 1.0])


def _brute(occ, sense=(0, 0, 0)):
    """Chebyshev distance to the nearest occupied cell, looking only
    along the given senses (x, y, z), capped at 255."""
    occ = occ.numpy()
    out = np.full(occ.shape, 255, np.int64)
    zz, yy, xx = np.indices(occ.shape)
    for oz, oy, ox in np.argwhere(occ == 0):
        dz, dy, dx = oz - zz, oy - yy, ox - xx
        ok = np.ones(occ.shape, bool)
        for dd, s in ((dx, sense[0]), (dy, sense[1]), (dz, sense[2])):
            if s:
                ok &= (dd == 0) | (np.sign(dd) == s)
        dist = np.maximum(np.maximum(abs(dx), abs(dy)), abs(dz))
        out = np.where(ok, np.minimum(out, dist), out)
    return out


def _occ(seed=0, shape=(7, 9, 11), p=0.04):
    g = torch.Generator().manual_seed(seed)
    occ = torch.full(shape, 255, dtype=torch.uint8)
    occ[torch.rand(shape, generator=g) < p] = 0
    return occ


def test_isotropic_distance_is_chebyshev():
    occ = _occ()
    got = reference.isotropic_distance(occ)[0].to(torch.int64).numpy()
    np.testing.assert_array_equal(got, _brute(occ))


def test_anisotropic_maps_per_octant():
    occ = _occ(1)
    got = reference.anisotropic_distance(occ).to(torch.int64).numpy()
    for j in range(8):
        sense = tuple(-1 if (j >> b) & 1 else 1 for b in (2, 1, 0))
        np.testing.assert_array_equal(
            got[j], np.minimum(_brute(occ, sense), reference.ANISO_CAP))


def test_occupancy_blocks():
    """A block is occupied iff one of its voxels is past the TF's
    intensity threshold; the last block of an axis is partial."""
    vol = torch.zeros((9, 8, 8), dtype=torch.uint8)
    vol[8, 0, 0] = 30          # alone in the partial last z block
    vol[0, 7, 7] = 20          # at the threshold of imin 0.086: empty
    tf = dict(TF, intensity_min=0.086)
    occ = reference.occupancy(vol, None, tf, 4)
    assert occ.shape == (3, 2, 2)
    assert int((occ == 0).sum()) == 1 and int(occ[2, 0, 0]) == 0


def test_gradient_of_a_ramp():
    """v = 3x: the x taps give 2 v[x + 1] - 2 v[x - 1] = 12 in the
    interior, the y and z taps cancel, so |0.25 * (12, 0, 0)| / 255 =
    3 / 255."""
    x = torch.arange(16, dtype=torch.uint8) * 3
    vol = x.expand(6, 5, 16).contiguous()
    g = reference.gradient_map(vol, slab=2)
    assert torch.all(g[1:-1, 1:-1, 1:-1] == 3)


def test_render_uniform_volume_closed_form():
    """A uniform volume of alpha a: a ray of n steps composites to
    1 - (1 - a)^n without ERT; every covered pixel sees its own n."""
    v = 128
    vol = torch.full((16, 16, 16), v, dtype=torch.uint8)
    a = np.float32(v) * np.float32(1 / 255)
    pose = P.orbit_pose(30.0, 20.0, 1.0)
    color = reference.render(vol, None, TF, pose.view, pose.proj, MODEL,
                             32, 32, clip_distance=50.0, ert=False)
    entry, _, dist, valid = reference.rays(pose.view, pose.proj, MODEL,
                                           32, 32, 50.0, "cpu")
    n = torch.ceil(16.0 * dist).to(torch.int64)
    want = 1.0 - (1.0 - float(a)) ** n.to(torch.float64)
    alpha = color.reshape(-1, 4)[:, 3].to(torch.float64)
    covered = alpha > 0
    assert int(covered.sum()) > 200
    assert torch.allclose(alpha[covered], want[covered], atol=1e-5)
    # Grey: each colour channel is alpha times the TF's grey value a.
    rgb = color.reshape(-1, 4)[covered, 0].to(torch.float64)
    assert torch.allclose(rgb, a * alpha[covered], atol=1e-5)


def test_render_ert_stops_at_099():
    vol = torch.full((16, 16, 16), 255, dtype=torch.uint8)
    pose = P.orbit_pose(0.0, 0.0, 1.0)
    color = reference.render(vol, None, TF, pose.view, pose.proj, MODEL,
                             16, 16, clip_distance=50.0)
    alpha = color[..., 3]
    assert set(alpha.unique().tolist()) <= {0.0, 1.0}
    assert float(alpha.max()) == 1.0


def test_render_empty_volume():
    vol = torch.zeros((8, 8, 8), dtype=torch.uint8)
    pose = P.orbit_pose(10.0, 5.0, 1.0)
    color = reference.render(vol, None, TF, pose.view, pose.proj, MODEL,
                             16, 16, clip_distance=50.0)
    assert float(color.abs().max()) == 0.0
