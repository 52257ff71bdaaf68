"""Chebyshev distance maps on the card — K3, K4, K5 and K6
(csrc/distance.cu), the counterparts of
``vkvolume_tpu/accel/distance_pallas.py``'s ``scan_and_relax_multi`` and
``relax_z_direct_multi`` (the octant maps), ``scan_and_relax`` and
``relax_z_direct`` with ``relax_dirs=(0,)`` (the isotropic map), and
``relax_pallas`` / ``relax_z`` (one relaxation along z or y, an accel
entry point that no engine path calls).

A CPU tensor runs the plain versions in ``distance.py``; a CUDA tensor
launches the kernels (or raises). ``LAUNCHES`` counts kernel launches per
wrapper.
"""

from __future__ import annotations

import torch

from ..utils import cuda_build
from . import distance

LAUNCHES = {"scan_and_relax_multi": 0, "relax_z_direct_multi": 0,
            "scan_and_relax": 0, "relax_z_direct": 0, "relax": 0}


def _require_zyx(name: str, t: torch.Tensor) -> None:
    cuda_build.require_cuda(name, t, torch.uint8)
    if t.ndim != 3:
        raise ValueError(f"{name}: expected (Z, Y, X), got {tuple(t.shape)}")


def scan_and_relax(occ_u8: torch.Tensor) -> torch.Tensor:
    """K5: the two-sided x-scan and two-sided y-relaxation of a (Z, Y, X)
    u8 occupancy map, as (1, Z, Y, X) u8 (``relax_dirs=(0,)``)."""
    if occ_u8.device.type == "cpu":
        return distance.scan_and_relax(occ_u8, 0, (0,))
    _require_zyx("occ_u8", occ_u8)
    lib = cuda_build.load_kernels()
    Z, Y, X = occ_u8.shape
    xs = torch.empty((Z, Y, X), dtype=torch.uint8, device=occ_u8.device)
    out = torch.empty((1, Z, Y, X), dtype=torch.uint8, device=occ_u8.device)
    s = cuda_build.stream()
    cuda_build.check(lib.vkv_x_scan2(occ_u8.data_ptr(), xs.data_ptr(),
                                     Z, Y, X, s), "x_scan2")
    cuda_build.check(lib.vkv_relax(xs.data_ptr(), out.data_ptr(), Z, Y, X,
                                   1, 0, s), "relax (y)")
    LAUNCHES["scan_and_relax"] += 1
    return out


def relax_z_direct(d_u8: torch.Tensor) -> torch.Tensor:
    """K4, two-sided: the z-relaxation of one (Z, Y, X) u8 map in both
    senses at once, as (1, Z, Y, X) u8 (``relax_dirs=(0,)``)."""
    if d_u8.device.type == "cpu":
        return distance.relax_z_direct(d_u8, (0,))
    _require_zyx("d_u8", d_u8)
    lib = cuda_build.load_kernels()
    Z, Y, X = d_u8.shape
    out = torch.empty((1, Z, Y, X), dtype=torch.uint8, device=d_u8.device)
    cuda_build.check(lib.vkv_relax(d_u8.data_ptr(), out.data_ptr(), Z, Y, X,
                                   0, 0, cuda_build.stream()), "relax (z)")
    LAUNCHES["relax_z_direct"] += 1
    return out


def relax(D: torch.Tensor, axis: int, direction: int = 0) -> torch.Tensor:
    """K6: the uncapped zig-zag relaxation of a (Z, Y, X) u8 map along
    ``axis`` 0 (z) or 1 (y), two-sided (``direction`` 0) or one-sided
    (+1 / -1), as (Z, Y, X) u8 — the drop-in of ``relax_pallas``."""
    if axis not in (0, 1) or direction not in (-1, 0, 1):
        raise ValueError(f"relax: axis {axis} / direction {direction} "
                         "(axis 0 or 1, direction -1, 0 or +1)")
    if D.device.type == "cpu":
        return distance.relax(D, axis, direction).to(torch.uint8)
    _require_zyx("D", D)
    lib = cuda_build.load_kernels()
    Z, Y, X = D.shape
    out = torch.empty_like(D)
    cuda_build.check(lib.vkv_relax(D.data_ptr(), out.data_ptr(), Z, Y, X,
                                   axis, direction, cuda_build.stream()),
                     "relax")
    LAUNCHES["relax"] += 1
    return out


def isotropic_distance_cuda(occ_u8: torch.Tensor) -> torch.Tensor:
    """The isotropic map as (1, Z, Y, X) u8 — counterpart of
    ``isotropic_distance_pallas``: K5, then the two-sided K4."""
    return relax_z_direct(scan_and_relax(occ_u8)[0])


def scan_and_relax_multi(occ_u8: torch.Tensor,
                         cap: int = distance.ANISO_CAP) -> torch.Tensor:
    """K3: the four (x-scan ± capped at ``cap``) × (y-relax ±) maps of a
    (Z, Y, X) u8 occupancy map, scan-major, as (4, Z, Y, X) u8."""
    if occ_u8.device.type == "cpu":
        return distance.scan_and_relax_multi(occ_u8, cap)
    _require_zyx("occ_u8", occ_u8)
    lib = cuda_build.load_kernels()
    Z, Y, X = occ_u8.shape
    xs = torch.empty((2, Z, Y, X), dtype=torch.uint8, device=occ_u8.device)
    out = torch.empty((4, Z, Y, X), dtype=torch.uint8, device=occ_u8.device)
    s = cuda_build.stream()
    cuda_build.check(lib.vkv_x_scan(occ_u8.data_ptr(), xs[0].data_ptr(),
                                    xs[1].data_ptr(), Z, Y, X, int(cap), s),
                     "x_scan")
    cuda_build.check(lib.vkv_y_relax4(xs[0].data_ptr(), xs[1].data_ptr(),
                                      out.data_ptr(), Z, Y, X, s),
                     "y_relax4")
    LAUNCHES["scan_and_relax_multi"] += 1
    return out


def relax_z_direct_multi(xys: torch.Tensor) -> torch.Tensor:
    """K4: z-relax each of the (4, Z, Y, X) K3 maps along +z and -z;
    input-major, so output j is octant map j. (8, Z, Y, X) u8."""
    if xys.device.type == "cpu":
        return distance.relax_z_direct_multi(xys)
    cuda_build.require_cuda("xys", xys, torch.uint8)
    if xys.ndim != 4 or xys.shape[0] != 4:
        raise ValueError(f"xys: expected (4, Z, Y, X), got {xys.shape}")
    lib = cuda_build.load_kernels()
    _, Z, Y, X = xys.shape
    out = torch.empty((8, Z, Y, X), dtype=torch.uint8, device=xys.device)
    cuda_build.check(lib.vkv_z_relax8(xys.data_ptr(), out.data_ptr(),
                                      Z, Y, X, cuda_build.stream()),
                     "z_relax8")
    LAUNCHES["relax_z_direct_multi"] += 1
    return out


def anisotropic_distance_cuda(occ_u8: torch.Tensor,
                              cap: int = distance.ANISO_CAP) -> torch.Tensor:
    """All 8 octant maps, (8, Z, Y, X) u8 — counterpart of
    ``anisotropic_distance_pallas``; octant order
    idx = (sx<0)<<2 | (sy<0)<<1 | (sz<0)."""
    return relax_z_direct_multi(scan_and_relax_multi(occ_u8, cap))
