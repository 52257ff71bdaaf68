from .distance import (
    ANISO_CAP,
    anisotropic_distance,
    axis_scan,
    brute_force_chebyshev,
    isotropic_distance,
    relax,
)
from .distance_cuda import anisotropic_distance_cuda, isotropic_distance_cuda
from .gradient import gradient_map
from .occupancy import (
    EMPTY,
    OCCUPIED,
    effective_block_size,
    map_extent,
    occupancy_map,
    occupied_voxel_count,
    voxel_alpha_positive,
)

__all__ = [
    "ANISO_CAP",
    "anisotropic_distance",
    "anisotropic_distance_cuda",
    "axis_scan",
    "brute_force_chebyshev",
    "isotropic_distance",
    "isotropic_distance_cuda",
    "relax",
    "gradient_map",
    "EMPTY",
    "OCCUPIED",
    "effective_block_size",
    "map_extent",
    "occupancy_map",
    "occupied_voxel_count",
    "voxel_alpha_positive",
]
