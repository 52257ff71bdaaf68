"""Chebyshev distance transform — isotropic and anisotropic (8-octant),
plain PyTorch.

Port of ``vkvolume_tpu/accel/distance.py`` (the 3-pass Saito–Toriwaki
transform of shaders/distance_map.comp and distance_map_anisotropic.comp,
host schedules src/compute_distance_map.cpp:142-175 and :229-252):

* the x-line scan has the closed form ``g[x] = min_{x'} (occ[x'] + |x - x'|)``
  over both half-lines (isotropic) or the scan's half-line (octant) — a
  cumulative min of ``occ ± index``;
* the y and z stages are the zig-zag relaxation
  ``A[y] = min_n max(n, D[y ± n])`` (both senses, or one), run for
  n = 1, 2, ... over the whole array with the global early exit
  ``n >= max(A)`` (no candidate can win past it — the same bound as the
  shader's per-line exit).

This module is the plain version of the kernels in ``distance_cuda.py``
(K3 = one-sided x-scan + y-relax, K4 = z-relax, K5 = two-sided x-scan +
y-relax); ``relax_search``, ``relax_walk``, ``axis_scan_linear`` and
``scan_and_relax_multi_tiled`` state the kernels' own algorithms for the
tests. Occupancy convention:
OCCUPIED = 0, EMPTY = 255. Isotropic maps are uncapped (values up to
255); only the octant maps take ``ANISO_CAP``.
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
    """1-D distance scan along ``axis`` (int32 out):
    direction=+1: g[x] = min_{x' >= x} occ[x'] + (x' - x);
    direction=-1: g[x] = min_{x' <= x} occ[x'] + (x - x');
    direction=0: both, g[x] = min_{x'} occ[x'] + |x - x'|."""
    occ = occ.to(torch.int32)
    shape = [1] * occ.ndim
    shape[axis] = occ.shape[axis]
    idx = torch.arange(occ.shape[axis], dtype=torch.int32,
                       device=occ.device).reshape(shape)
    g = None
    if direction >= 0:
        suff = torch.cummin((occ + idx).flip(axis), dim=axis).values.flip(axis)
        g = suff - idx
    if direction <= 0:
        bwd = torch.cummin(occ - idx, dim=axis).values + idx
        g = bwd if g is None else torch.minimum(g, bwd)
    return g


def relax(D: torch.Tensor, axis: int, direction: int) -> torch.Tensor:
    """Zig-zag relaxation along ``axis`` (int32 out):
    A[y] = min_{n >= 0, in bounds} max(n, D[y + s·n]) over s = direction,
    or over both senses when direction is 0."""
    src = D.to(torch.int32)
    A = src.clone()
    L = A.shape[axis]
    n = 1
    while n < L and n < int(A.max()):
        # Out-of-bounds candidates are 255-padding: they never win, so only
        # the in-bounds slice is updated.
        if direction >= 0:
            dst = A.narrow(axis, 0, L - n)
            dst.copy_(torch.minimum(dst, src.narrow(axis, n, L - n)
                                    .clamp(min=n)))
        if direction <= 0:
            dst = A.narrow(axis, n, L - n)
            dst.copy_(torch.minimum(dst, src.narrow(axis, 0, L - n)
                                    .clamp(min=n)))
        n += 1
    return A


def axis_scan_linear(occ: torch.Tensor, axis: int,
                     direction: int) -> torch.Tensor:
    """``axis_scan`` as two linear passes along ``axis`` (int32 out): the
    ascending pass g[x] = min(g[x], g[x - 1] + 1) takes the -1 sense, the
    descending pass g[x] = min(g[x], g[x + 1] + 1) the +1 sense, both the
    two-sided scan. K5's x-scan is their closed form."""
    g = occ.to(torch.int32).movedim(axis, 0).clone()
    L = g.shape[0]
    if direction <= 0:
        for x in range(1, L):
            torch.minimum(g[x], g[x - 1] + 1, out=g[x])
    if direction >= 0:
        for x in range(L - 2, -1, -1):
            torch.minimum(g[x], g[x + 1] + 1, out=g[x])
    return g.movedim(0, axis)


def _window_table(d: torch.Tensor):
    """The minima of the windows of 2^k cells along the last axis of the
    int32 ``d`` (k up to 7: no window of a one-sided relaxation of u8
    values is longer), and ``window_min(a, b)``: min(d[..., a:b + 1]) per
    element, a <= b, from two entries of the level of the largest power of
    two within the window."""
    L = d.shape[-1]
    levels = [d]
    while (2 << (len(levels) - 1)) <= min(L, 255):
        half = 1 << (len(levels) - 1)
        prev = levels[-1]
        nxt = torch.full_like(prev, 255)
        nxt[..., :L - 2 * half + 1] = torch.minimum(
            prev[..., :L - 2 * half + 1], prev[..., half:L - half + 1])
        levels.append(nxt)
    table = torch.stack(levels, -2).flatten(-2)          # (..., K * L)

    def window_min(a, b):
        n = b - a + 1
        k = torch.zeros_like(n)
        for j in range(1, len(levels)):
            k += (n >= (1 << j)).to(torch.int32)
        first = torch.gather(table, -1, (k * L + a).long())
        last = torch.gather(table, -1,
                            (k * L + b - (torch.ones_like(k) << k) + 1).long())
        return torch.minimum(first, last)

    return window_min


def relax_search(D: torch.Tensor, axis: int, direction: int) -> torch.Tensor:
    """``relax`` of a u8 map by a search per cell (int32 out; the tests
    hold it against ``relax``).

    A[l] = min_n max(n, D[l + s n]) (one sense s) is the least t for which
    the window [l, l + t] (s = +1) or [l - t, l] (s = -1), clipped to the
    line, holds a value <= t: its minimum only falls as t grows, and
    t = D[l] always qualifies. t is found by descending powers of two
    (t <= 254), keeping the largest t that fails. Two-sided (direction 0):
    the minimum of the two senses."""
    if direction == 0:
        return torch.minimum(relax_search(D, axis, 1),
                             relax_search(D, axis, -1))
    d = D.to(torch.int32).movedim(axis, -1)
    L = d.shape[-1]
    window_min = _window_table(d)
    pos = torch.arange(L, dtype=torch.int32, device=d.device).expand_as(d)
    t0 = torch.full_like(d, -1)          # the largest t known to fail
    for k in range(7, -1, -1):
        t = t0 + (1 << k)
        if direction > 0:
            w = window_min(pos, (pos + t).clamp(max=L - 1))
        else:
            w = window_min((pos - t).clamp(min=0), pos)
        t0 = torch.where((t < d) & (w > t), t, t0)
    return (t0 + 1).movedim(-1, axis)


def relax_walk(D: torch.Tensor, axis: int, direction: int,
               run: int) -> torch.Tensor:
    """``relax`` of a u8 map as the kernels compute it (int32 out; the
    tests hold it against ``relax``): each line in runs of ``run`` cells,
    walked in the sense's order (+1: from the run's last cell down), the
    first cell by ``relax_search``, each next one by one step from its
    neighbour's a: A[l] = min(D[l], B), B = min_{n >= 1} max(n, D[l + s n])
    is a or a + 1, and a exactly when one of the a cells past l holds at
    most a. Two-sided (direction 0): the minimum of the two senses."""
    if direction == 0:
        return torch.minimum(relax_walk(D, axis, 1, run),
                             relax_walk(D, axis, -1, run))
    d = D.to(torch.int32).movedim(axis, -1)
    L = d.shape[-1]
    window_min = _window_table(d)
    first = relax_search(D, axis, direction).movedim(axis, -1)
    out = torch.empty_like(d)
    for r0 in range(0, L, run):
        cells = range(r0, min(L, r0 + run))
        order = list(cells)[::-1] if direction > 0 else list(cells)
        out[..., order[0]] = first[..., order[0]]
        for prev, m in zip(order, order[1:]):
            a = out[..., prev:prev + 1]
            if direction > 0:
                w = window_min(torch.full_like(a, m + 1),
                               (m + a).clamp(min=m + 1, max=L - 1))
            else:
                w = window_min((m - a).clamp(min=0, max=m - 1),
                               torch.full_like(a, m - 1))
            b = torch.where((a > 0) & (w <= a), a, a + 1)
            out[..., m:m + 1] = torch.minimum(d[..., m:m + 1], b)
    return out.movedim(-1, axis)


def scan_and_relax(occ_u8: torch.Tensor, scan_dir: int = 0,
                   relax_dirs: tuple = (0,)) -> torch.Tensor:
    """Plain version of K5 (``distance_pallas.scan_and_relax``): the x-scan
    in sense ``scan_dir`` (0 = two-sided; its cap of 255 is a no-op) and
    the y-relaxation in each sense of ``relax_dirs`` (0 = two-sided), as
    (len(relax_dirs), Z, Y, X) u8."""
    g = axis_scan(occ_u8, 2, scan_dir).clamp(max=255)
    return torch.stack([relax(g, 1, d).to(torch.uint8) for d in relax_dirs])


def relax_z_direct(d_u8: torch.Tensor, relax_dirs: tuple = (0,)
                   ) -> torch.Tensor:
    """Plain version of K4 on one input (``distance_pallas.relax_z_direct``):
    the z-relaxation of a (Z, Y, X) map in each sense of ``relax_dirs``
    (0 = two-sided), as (len(relax_dirs), Z, Y, X) u8."""
    return torch.stack([relax(d_u8, 0, d).to(torch.uint8)
                        for d in relax_dirs])


def isotropic_distance(occ_u8: torch.Tensor) -> torch.Tensor:
    """Isotropic Chebyshev distance map (Z, Y, X) u8, uncapped: two-sided
    x-scan, y-relax, z-relax (``distance.isotropic_distance``)."""
    return relax_z_direct(scan_and_relax(occ_u8)[0])[0]


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


def scan_and_relax_multi_tiled(occ_u8: torch.Tensor, cap: int = ANISO_CAP,
                               *, columns: int, seg_len: int,
                               run: int) -> torch.Tensor:
    """``scan_and_relax_multi`` as K3's kernel computes it (u8 out; the
    tests hold it against ``scan_and_relax_multi``): tiles of ``columns``
    x-columns and segments of ``seg_len`` y-rows. Per tile, each x-scan
    sense runs its linear pass (``axis_scan_linear``) over the tile's
    columns and only the ``cap - 1`` cells beyond them on its own side
    (a cell further out adds at least ``cap``), capped; each segment's
    lines are relaxed from ``cap`` rows out on both sides (no window of
    values <= cap reaches further) by ``relax_walk`` in each y sense, in
    runs of ``run`` cells. Scan-major, as (4, Z, Y, X)."""
    Z, Y, X = occ_u8.shape
    out = torch.empty((4, Z, Y, X), dtype=torch.uint8, device=occ_u8.device)
    for c0 in range(0, X, columns):
        c1 = min(X, c0 + columns)
        for s0 in range(0, Y, seg_len):
            s1 = min(Y, s0 + seg_len)
            lo, hi = max(0, s0 - cap), min(Y, s1 + cap)
            for i, sx in enumerate((1, -1)):
                xa, xb = ((c0, min(X, c1 + cap - 1)) if sx > 0
                          else (max(0, c0 - cap + 1), c1))
                g = axis_scan_linear(occ_u8[:, lo:hi, xa:xb], 2, sx)
                g = g[..., c0 - xa:c1 - xa].clamp(max=cap)
                for j, sy in enumerate((1, -1)):
                    out[2 * i + j, :, s0:s1, c0:c1] = relax_walk(
                        g, 1, sy, run)[:, s0 - lo:s1 - lo]
    return out


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
