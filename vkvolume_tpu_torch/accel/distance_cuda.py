"""Anisotropic Chebyshev distance maps on the card — K3 and K4
(csrc/distance.cu), the counterparts of ``vkvolume_tpu/accel/
distance_pallas.py``'s ``scan_and_relax_multi`` and ``relax_z_direct_multi``.

A CPU tensor runs the plain versions in ``distance.py``; a CUDA tensor
launches the kernels (or raises). ``LAUNCHES`` counts kernel launches per
wrapper.
"""

from __future__ import annotations

import torch

from ..utils import cuda_build
from . import distance

LAUNCHES = {"scan_and_relax_multi": 0, "relax_z_direct_multi": 0}


def scan_and_relax_multi(occ_u8: torch.Tensor,
                         cap: int = distance.ANISO_CAP) -> torch.Tensor:
    """K3: the four (x-scan ± capped at ``cap``) × (y-relax ±) maps of a
    (Z, Y, X) u8 occupancy map, scan-major, as (4, Z, Y, X) u8."""
    if occ_u8.device.type == "cpu":
        return distance.scan_and_relax_multi(occ_u8, cap)
    cuda_build.require_cuda("occ_u8", occ_u8, torch.uint8)
    if occ_u8.ndim != 3:
        raise ValueError(f"occ_u8: expected (Z, Y, X), got {occ_u8.shape}")
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
