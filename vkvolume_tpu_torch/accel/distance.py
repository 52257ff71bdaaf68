"""Chebyshev distance transform — anisotropic (8-octant), plain PyTorch.

Port of ``vkvolume_tpu/accel/distance.py`` (the 3-pass Saito–Toriwaki
transform of shaders/distance_map_anisotropic.comp, host schedule
src/compute_distance_map.cpp:229-252):

* the one-sided x-line scan has the closed form
  ``g[x] = min_{x'} (occ[x'] + |x - x'|)`` over the scan's half-line — a
  cumulative min of ``occ ± index``;
* the y and z stages are the zig-zag relaxation
  ``A[y] = min_n max(n, D[y ± n])``, run for n = 1, 2, ... over the whole
  array with the global early exit ``n >= max(A)`` (no candidate can win
  past it — the same bound as the shader's per-line exit).

This module is the plain version of the kernels in ``distance_cuda.py``
(K3 = x-scan + y-relax, K4 = z-relax). Occupancy convention: OCCUPIED = 0,
EMPTY = 255.
"""

from __future__ import annotations

import numpy as np
import torch

# Value cap of the anisotropic maps (see vkvolume_tpu/accel/distance.py):
# one-sided octant distances hit 255 at every axis-facing boundary, so an
# uncapped max-bounded relaxation never exits early. Capped values are
# never larger than the true distance, so ESS stays conservative.
ANISO_CAP = 63


def axis_scan(occ: torch.Tensor, axis: int, direction: int) -> torch.Tensor:
    """One-sided 1-D distance scan along ``axis`` (int32 out):
    direction=+1: g[x] = min_{x' >= x} occ[x'] + (x' - x);
    direction=-1: g[x] = min_{x' <= x} occ[x'] + (x - x')."""
    occ = occ.to(torch.int32)
    shape = [1] * occ.ndim
    shape[axis] = occ.shape[axis]
    idx = torch.arange(occ.shape[axis], dtype=torch.int32,
                       device=occ.device).reshape(shape)
    if direction > 0:
        suff = torch.cummin((occ + idx).flip(axis), dim=axis).values.flip(axis)
        return suff - idx
    return torch.cummin(occ - idx, dim=axis).values + idx


def relax(D: torch.Tensor, axis: int, direction: int) -> torch.Tensor:
    """One-sided zig-zag relaxation along ``axis`` (int32 out):
    A[y] = min_{n >= 0, in bounds} max(n, D[y + direction·n])."""
    src = D.to(torch.int32)
    A = src.clone()
    L = A.shape[axis]
    n = 1
    while n < L and n < int(A.max()):
        if direction > 0:
            cand = src.narrow(axis, n, L - n)
            dst = A.narrow(axis, 0, L - n)
        else:
            cand = src.narrow(axis, 0, L - n)
            dst = A.narrow(axis, n, L - n)
        # Out-of-bounds candidates are 255-padding: they never win, so only
        # the in-bounds slice is updated.
        dst.copy_(torch.minimum(dst, cand.clamp(min=n)))
        n += 1
    return A


def scan_and_relax_multi(occ_u8: torch.Tensor,
                         cap: int = ANISO_CAP) -> torch.Tensor:
    """Plain version of K3: the 4 (x-scan ± capped at ``cap``) × (y-relax ±)
    maps, scan-major ((+,+), (+,-), (-,+), (-,-)), as (4, Z, Y, X) u8."""
    outs = []
    for sx in (1, -1):
        g = axis_scan(occ_u8, 2, sx).clamp(max=cap)
        for sy in (1, -1):
            outs.append(relax(g, 1, sy).to(torch.uint8))
    return torch.stack(outs)


def relax_z_direct_multi(xys: torch.Tensor) -> torch.Tensor:
    """Plain version of K4: z-relax each of the (4, Z, Y, X) inputs in both
    directions, input-major, as (8, Z, Y, X) u8."""
    return torch.stack([relax(d, 0, sz).to(torch.uint8)
                        for d in xys for sz in (1, -1)])


def anisotropic_distance(occ_u8: torch.Tensor,
                         cap: int = ANISO_CAP) -> torch.Tensor:
    """All 8 octant maps, (8, mz, my, mx) u8. The scan-major / input-major
    orders above make stage-2 output j exactly octant map j
    (idx = (sx<0)<<2 | (sy<0)<<1 | (sz<0), volume_render.frag:209)."""
    return relax_z_direct_multi(scan_and_relax_multi(occ_u8, cap))


def brute_force_chebyshev(occ_u8, direction_xyz=(0, 0, 0)) -> np.ndarray:
    """O(cells²) numpy reference for tests: per cell, the Chebyshev distance
    to the nearest occupied cell, restricted to an octant when a direction
    component is ±1 (0 = both ways on that axis), capped at 255."""
    occ = np.asarray(occ_u8)
    out = np.full(occ.shape, 255, dtype=np.int32)
    occ_idx = np.argwhere(occ == 0)
    if occ_idx.size == 0:
        return out.astype(np.uint8)
    zz, yy, xx = np.indices(occ.shape)
    for oz, oy, ox in occ_idx:
        dz, dy, dx = oz - zz, oy - yy, ox - xx
        ok = np.ones(occ.shape, bool)
        for d, s in ((dx, direction_xyz[0]), (dy, direction_xyz[1]),
                     (dz, direction_xyz[2])):
            if s:
                ok &= (np.sign(d) == 0) | (np.sign(d) == s)
        dist = np.maximum(np.maximum(np.abs(dx), np.abs(dy)), np.abs(dz))
        out = np.where(ok, np.minimum(out, dist), out)
    return out.astype(np.uint8)
