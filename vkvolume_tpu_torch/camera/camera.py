"""Perspective camera — replaces vkb's scene-graph camera + free-camera input.

Reproduces the reference's projection conventions exactly
(src/volume_render_subpass.cpp:224-226):

* ``proj = vulkan_style_projection(glm::perspective(fovy, aspect, FAR, NEAR))``
  — note far/near are swapped by ``vkb::sg::PerspectiveCamera`` to get
  reverse-Z (the fragment shader's ``REVERSE_DEPTH``: depth cleared to 0,
  GREATER_OR_EQUAL test, volume_render.frag:21, 139-143),
* Vulkan clip space: Y flipped, depth in [0, 1].

Also provides orbit/benchmark poses standing in for the interactive free
camera (WASD/mouse) of the reference framework.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..utils import math3d


@dataclasses.dataclass
class Camera:
    view: np.ndarray      # world -> view
    proj: np.ndarray      # view -> vulkan clip (reverse-Z)
    fovy_rad: float
    near: float
    far: float

    @property
    def view_inv(self) -> np.ndarray:
        return math3d.inverse(self.view)

    @property
    def position(self) -> np.ndarray:
        """Camera position in world space = viewInv[3] (GLM column 3);
        reference: src/volume_render_subpass.cpp:234."""
        return self.view_inv[:3, 3].copy()

    @property
    def direction(self) -> np.ndarray:
        """World-space view direction = viewInv * (0,0,-1,0)
        (src/volume_render_subpass.cpp:237)."""
        return (-self.view_inv[:3, 2]).copy()

    @property
    def view_proj_inv(self) -> np.ndarray:
        return math3d.inverse(self.proj @ self.view)


def perspective_camera(
    *,
    eye,
    center,
    up=(0.0, 1.0, 0.0),
    fovy_deg: float = 60.0,
    aspect: float = 1.0,
    near: float = 0.1,
    far: float = 4000.0,
) -> Camera:
    view = math3d.look_at(eye, center, up)
    # Reverse-Z: pass (far, near) swapped, then Vulkan Y flip.
    proj = math3d.vulkan_style_projection(
        math3d.perspective(np.deg2rad(fovy_deg), aspect, far, near)
    )
    return Camera(view=view, proj=proj, fovy_rad=float(np.deg2rad(fovy_deg)),
                  near=near, far=far)


def orbit_camera(
    *,
    target=(0.0, 0.0, 0.0),
    radius: float = 200.0,
    azimuth_deg: float = 0.0,
    elevation_deg: float = 0.0,
    fovy_deg: float = 60.0,
    aspect: float = 1.0,
    near: float = 0.1,
    far: float = 4000.0,
) -> Camera:
    """Orbit pose around a target (scripted stand-in for the free camera)."""
    az = np.deg2rad(azimuth_deg)
    el = np.deg2rad(elevation_deg)
    t = np.asarray(target, np.float64)
    eye = t + radius * np.asarray(
        [np.cos(el) * np.sin(az), np.sin(el), np.cos(el) * np.cos(az)]
    )
    return perspective_camera(
        eye=eye, center=t, fovy_deg=fovy_deg, aspect=aspect, near=near, far=far
    )


def fit_distance(cube_half_extent: float, fovy_rad: float, aspect: float) -> float:
    """Distance at which a cube of the given half extent fills the viewport
    height — the analytic equivalent of benchmark mode's fit-to-viewport
    scaling (src/volume_render.cpp:224-238)."""
    half_fov = fovy_rad / 2.0
    min_half_fov = min(half_fov, np.arctan(np.tan(half_fov) * aspect))
    return float(cube_half_extent / np.tan(min_half_fov))


def pad_viewport(cam: Camera, width: int, height: int,
                 width_pad: int, height_pad: int) -> Camera:
    """Camera whose (height_pad × width_pad) render produces pixel-identical
    rays for the original (height × width) window in its top-left corner.

    Pixel j of the padded image has ndc'_x = (j+0.5)·2/W' − 1 while the
    original pixel has ndc_x = (j+0.5)·2/W − 1, i.e. ndc' = a·ndc + (a−1)
    with a = W/W'. Remixing clip-space x (and y) with w as
    x' = a·x + (a−1)·w makes the padded unprojection reproduce the original
    rays exactly; depth (z, w rows) is untouched. Used by the engine to run
    the tile-aligned Pallas pipeline on arbitrary image sizes (extra
    rows/columns are rendered past the right/bottom edge and cropped)."""
    ax = width / width_pad
    ay = height / height_pad
    p = cam.proj.astype(np.float64).copy()
    p[0, :] = ax * p[0, :] + (ax - 1.0) * p[3, :]
    p[1, :] = ay * p[1, :] + (ay - 1.0) * p[3, :]
    return dataclasses.replace(cam, proj=p.astype(cam.proj.dtype))
