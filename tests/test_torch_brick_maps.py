"""K1's map inputs (``sweep_bricks.brick_maps``): the coarse leap map, the
tight skip map and the occupied brick range, on the CPU.

The shared shape arithmetic (``CoarseShape``) against the statement
``CoarseMap.build`` made of it, and the plain twin
(``brick_maps_plain``, which the CPU frame runs and the card's kernel,
``frame_cuda.brick_maps``, is held to bit for bit by the ``cuda`` tests)
against a direct numpy statement of each output's definition, over the
maps of ``torch_brick_map_cases``, the leap map with and without
distances, and aligned and plane-pair lerp slab counts. The launcher
refuses what the kernel cannot take.
"""

import numpy as np
import pytest
import torch

from vkvolume_tpu_torch.render import frame_cuda, sweep_bricks
from vkvolume_tpu_torch.render.sweep_bricks import (BRICK, CoarseMap,
                                                    CoarseShape,
                                                    brick_maps_plain,
                                                    planes_per_brick)
from torch_brick_map_cases import (CONTENTS, SHAPES, SLABS, case_map,
                                   case_slabs)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _old_shape(map_shape, vol_shape) -> dict:
    """The shape arithmetic as ``CoarseMap.build`` stated it."""
    Np, Sv, Su = vol_shape
    mp, mv, mu = map_shape
    bp_v = -(-Sv // mv)
    bp_u = -(-Su // mu)
    factor_v = max(1, -(-8 // bp_v))
    factor_u = max(-(-mu // 128), max(1, -(-8 // bp_u)))
    CV = -(-mv // factor_v)
    CU = -(-mu // factor_u)
    bp_p = -(-Np // mp)
    return dict(mp=mp, CV=CV, CU=CU, CVp=max(16, -(-CV // 8) * 8),
                bp_p=bp_p, bp_v=bp_v, bp_u=bp_u, factor_v=factor_v,
                factor_u=factor_u, Np=Np, Sv=Sv, Su=Su)


def _numpy_maps(occ: np.ndarray, vol_shape, n_slabs: int,
                dist_leap: bool) -> tuple:
    """(coarse, cskip, kb_occ) from their definitions."""
    s = _old_shape(occ.shape, vol_shape)
    mp, CV, CU = s["mp"], s["CV"], s["CU"]
    fv, fu = s["factor_v"], s["factor_u"]
    d = occ if dist_leap else np.minimum(occ, 1)
    # MIN over each coarse cell's map cells inside the map: cell (cv, cu)
    # takes map cell (cv * fv + i, cu * fu + j) for every offset (i, j) that
    # lies inside (the last row and column of cells may take fewer).
    pooled = np.full((mp, CV, CU), 255, np.uint8)
    for i in range(fv):
        for j in range(fu):
            part = d[:, i::fv, j::fu]
            rows, cols = part.shape[1:]
            pooled[:, :rows, :cols] = np.minimum(pooled[:, :rows, :cols],
                                                 part)
    # A slab between planes m and m + 1 reads both: the leap map.
    leap = np.minimum(pooled, pooled[np.minimum(np.arange(mp) + 1, mp - 1)])
    # Tight: 0 iff a plane in [m, m + span] holds an occupied cell.
    span = -(-(planes_per_brick(s["Np"], n_slabs) - 1) // s["bp_p"])
    tight = np.stack([np.where((pooled[m:m + span + 1] == 0).any(axis=0), 0,
                               1) for m in range(mp)]).astype(np.uint8)

    def pad(a):
        out = np.full((mp, s["CVp"], 128), 255, np.uint8)
        out[:, :CV, :CU] = a
        return out

    # Slab k's voxel plane, in float32 step by step, and its map planes.
    f32 = np.float32
    held = (occ == 0).any(axis=(1, 2))
    ds = f32(1.0 / n_slabs)
    n_bricks = -(-n_slabs // BRICK)
    lo, hi = n_bricks, -1
    for k in range(n_slabs):
        z = f32(f32(f32(f32(k) + f32(0.5)) * ds) * f32(s["Np"])) - f32(0.5)
        k0 = min(max(int(np.floor(z)), 0), s["Np"] - 2)
        planes = (min(k0 // s["bp_p"], mp - 1),
                  min((k0 + 1) // s["bp_p"], mp - 1))
        if held[planes[0]] or held[planes[1]]:
            lo, hi = min(lo, k // BRICK), max(hi, k // BRICK)
    return pad(leap), pad(tight), np.array([lo, hi], np.int32)


@pytest.mark.parametrize("name", SHAPES)
def test_shape_arithmetic_is_coarse_maps(name):
    """``CoarseShape.of`` gives the numbers ``CoarseMap.build`` stated, its
    scalars and tight span are the old formulas', and ``CoarseMap`` carries
    them."""
    map_shape, vol_shape = SHAPES[name]
    shape = CoarseShape.of(map_shape, vol_shape)
    old = _old_shape(map_shape, vol_shape)
    assert {k: getattr(shape, k) for k in old} == old
    assert (shape.mv, shape.mu) == map_shape[1:]
    assert shape.CU <= 128 and shape.CVp % 8 == 0
    f32 = np.float32
    assert shape.scalars() == dict(
        inv_cvox_v=float(f32(1.0 / (old["factor_v"] * old["bp_v"]))),
        inv_cvox_u=float(f32(1.0 / (old["factor_u"] * old["bp_u"]))),
        drift_u=float(f32(old["Su"] * old["bp_p"]
                          / (old["Np"] * old["bp_u"]))),
        drift_v=float(f32(old["Sv"] * old["bp_p"]
                          / (old["Np"] * old["bp_v"]))))
    for slabs in SLABS:
        n = case_slabs(vol_shape, slabs)
        assert shape.mp_span(n) == -(-(planes_per_brick(vol_shape[0], n) - 1)
                                     // old["bp_p"])
    cm = CoarseMap.build(torch.zeros(map_shape, dtype=torch.uint8),
                         vol_shape, True)
    assert {k: getattr(cm, k) for k in old} == old
    assert tuple(cm.coarse.shape) == (old["mp"], old["CV"], old["CU"])


@pytest.mark.parametrize("content", CONTENTS)
@pytest.mark.parametrize("slabs", SLABS)
@pytest.mark.parametrize("dist_leap", [True, False])
@pytest.mark.parametrize("name", SHAPES)
def test_plain_twin_is_the_definition(name, dist_leap, slabs, content):
    map_shape, vol_shape = SHAPES[name]
    occ = case_map(map_shape, content)
    n_slabs = case_slabs(vol_shape, slabs)
    shape = CoarseShape.of(map_shape, vol_shape)
    got = brick_maps_plain(torch.from_numpy(occ), shape, n_slabs, dist_leap)
    want = _numpy_maps(occ, vol_shape, n_slabs, dist_leap)
    for what, g, w in zip(("coarse", "cskip", "kb_occ"), got, want):
        assert g.dtype == torch.from_numpy(w).dtype, what
        assert g.is_contiguous(), what
        np.testing.assert_array_equal(g.numpy(), w, err_msg=what)
    n_bricks = -(-n_slabs // BRICK)
    held = (occ == 0).any(axis=(1, 2))
    if not held.any():
        assert tuple(want[2]) == (n_bricks, -1)
    elif held.all():
        assert tuple(want[2]) == (0, n_bricks - 1)
    elif content == "first":
        assert want[2][0] == 0
    elif content == "last":
        assert want[2][1] == n_bricks - 1


def test_cpu_maps_take_the_twin():
    """``brick_maps`` on a CPU map is the twin and launches nothing."""
    map_shape, vol_shape = SHAPES["ragged"]
    occ = torch.from_numpy(case_map(map_shape, "random"))
    shape = CoarseShape.of(map_shape, vol_shape)
    before = dict(frame_cuda.LAUNCHES)
    for a, b in zip(sweep_bricks.brick_maps(occ, shape, 40, True),
                    brick_maps_plain(occ, shape, 40, True)):
        assert torch.equal(a, b)
    assert frame_cuda.LAUNCHES == before


@pytest.mark.parametrize("bad", ["cpu", "int16", "strided", "shape"])
def test_kernel_refuses_what_it_cannot_take(bad):
    """The launcher raises, before any build or launch, on a CPU map, a
    map other than u8, a strided one and one of another shape."""
    map_shape, vol_shape = SHAPES["ragged"]
    shape = CoarseShape.of(map_shape, vol_shape)
    occ = torch.from_numpy(case_map(map_shape, "random"))
    if bad == "int16":
        occ = occ.to(torch.int16)
    elif bad == "strided":
        occ = occ.transpose(1, 2).contiguous().transpose(1, 2)
        assert not occ.is_contiguous()
    elif bad == "shape":
        occ = occ[:, :-1].contiguous()
    before = dict(frame_cuda.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA" if bad == "cpu" else None):
        frame_cuda.brick_maps(occ, shape, 40, True)
    assert frame_cuda.LAUNCHES == before
