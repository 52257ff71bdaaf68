"""Camera poses of the benchmark's traffic, as the host matrices a GUI
camera would hand the renderer.

Frozen copy (commit 6863543) of ``vkvolume_tpu_torch/utils/math3d.py``
(``look_at``, ``perspective``, ``vulkan_style_projection``) and
``vkvolume_tpu_torch/camera/camera.py`` (``orbit_camera``,
``fit_distance``), so that a later change to the program's pose math
cannot move the poses the benchmark asks for. ``Pose`` holds the
matrices; ``run.py`` wraps them in the program's ``Camera`` type.
"""

from __future__ import annotations

import dataclasses

import numpy as np

FOVY_DEG = 60.0
NEAR, FAR = 0.1, 4000.0
CUBE_HALF = 50.0        # the stretch fit's 100-unit cube at the origin


@dataclasses.dataclass(frozen=True)
class Pose:
    view: np.ndarray      # (4, 4) float32, world -> view
    proj: np.ndarray      # (4, 4) float32, view -> Vulkan clip, reverse-Z
    azimuth_deg: float
    elevation_deg: float


def look_at(eye, center, up) -> np.ndarray:
    """View matrix (GLM ``glm::lookAt``, right-handed)."""
    eye = np.asarray(eye, dtype=np.float64)
    f = np.asarray(center, dtype=np.float64) - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, np.asarray(up, dtype=np.float64))
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4, dtype=np.float64)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -np.dot(s, eye)
    m[1, 3] = -np.dot(u, eye)
    m[2, 3] = np.dot(f, eye)
    return m.astype(np.float32)


def perspective(fovy_rad: float, aspect: float, znear: float,
                zfar: float) -> np.ndarray:
    """GLM ``glm::perspective`` with depth in [0, 1]; passing (far, near)
    swapped gives reverse-Z, as the reference's camera does."""
    t = np.tan(fovy_rad / 2.0)
    m = np.zeros((4, 4), dtype=np.float64)
    m[0, 0] = 1.0 / (aspect * t)
    m[1, 1] = 1.0 / t
    m[2, 2] = zfar / (znear - zfar)
    m[2, 3] = -(zfar * znear) / (zfar - znear)
    m[3, 2] = -1.0
    return m.astype(np.float32)


def fit_distance(cube_half_extent: float, fovy_rad: float,
                 aspect: float) -> float:
    """Distance at which a cube of the given half extent fills the
    viewport (src/volume_render.cpp:224-238)."""
    half_fov = fovy_rad / 2.0
    min_half_fov = min(half_fov, np.arctan(np.tan(half_fov) * aspect))
    return float(cube_half_extent / np.tan(min_half_fov))


def orbit_pose(azimuth_deg: float, elevation_deg: float,
               aspect: float) -> Pose:
    """The benchmark pose: an orbit round the origin at 1.05 times the
    fit distance of the 100-unit cube, 60 degree vertical field of view,
    reverse-Z with a Vulkan Y flip."""
    radius = fit_distance(CUBE_HALF, np.deg2rad(FOVY_DEG), aspect) * 1.05
    az = np.deg2rad(azimuth_deg)
    el = np.deg2rad(elevation_deg)
    eye = radius * np.asarray(
        [np.cos(el) * np.sin(az), np.sin(el), np.cos(el) * np.cos(az)])
    view = look_at(eye, (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))
    proj = perspective(np.deg2rad(FOVY_DEG), aspect, FAR, NEAR)
    proj[1, 1] *= -1.0
    return Pose(view=view, proj=proj, azimuth_deg=float(azimuth_deg),
                elevation_deg=float(elevation_deg))
