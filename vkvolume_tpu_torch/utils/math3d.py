"""Small 3D math library (GLM-equivalent helpers, numpy, float32).

The reference uses GLM on the host for all camera / model / clip-plane math
(reference: src/volume_render_subpass.cpp:223-249, src/load_volume.cpp:81-83).
These helpers reproduce the same conventions:

* matrices are 4x4, applied as ``M @ v`` with column vectors,
* composition reads left-to-right like GLM expressions
  (``glm::rotate(..) * glm::scale(..)`` == ``rotate(..) @ scale(..)``),
* ``perspective`` matches ``glm::perspective`` (right-handed, depth [0,1]
  after the Vulkan-style Y flip is applied by :func:`vulkan_style_projection`).
"""

from __future__ import annotations

import numpy as np

F = np.float32


def identity() -> np.ndarray:
    return np.eye(4, dtype=F)


def scale(s) -> np.ndarray:
    m = np.eye(4, dtype=F)
    m[0, 0], m[1, 1], m[2, 2] = np.asarray(s, dtype=F)
    return m


def translate(t) -> np.ndarray:
    m = np.eye(4, dtype=F)
    m[:3, 3] = np.asarray(t, dtype=F)
    return m


def rotate(angle_rad: float, axis) -> np.ndarray:
    """Rotation about an axis (GLM ``glm::rotate(angle, axis)``)."""
    axis = np.asarray(axis, dtype=np.float64)
    n = np.linalg.norm(axis)
    if n == 0.0:
        return identity()
    x, y, z = axis / n
    c, s = np.cos(angle_rad), np.sin(angle_rad)
    C = 1.0 - c
    m = np.eye(4, dtype=np.float64)
    m[:3, :3] = [
        [c + x * x * C, x * y * C - z * s, x * z * C + y * s],
        [y * x * C + z * s, c + y * y * C, y * z * C - x * s],
        [z * x * C - y * s, z * y * C + x * s, c + z * z * C],
    ]
    return m.astype(F)


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
    return m.astype(F)


def perspective(fovy_rad: float, aspect: float, znear: float, zfar: float) -> np.ndarray:
    """GLM ``glm::perspective`` with GLM_FORCE_DEPTH_ZERO_TO_ONE (Vulkan).

    The reference passes (far, near) swapped to get reverse-Z
    (vkb::sg::PerspectiveCamera::get_projection uses
    ``glm::perspective(fov, aspect, far_plane, near_plane)``); callers here do
    the same swap explicitly when they want reverse-Z.
    """
    t = np.tan(fovy_rad / 2.0)
    m = np.zeros((4, 4), dtype=np.float64)
    m[0, 0] = 1.0 / (aspect * t)
    m[1, 1] = 1.0 / t
    m[2, 2] = zfar / (znear - zfar)
    m[2, 3] = -(zfar * znear) / (zfar - znear)
    m[3, 2] = -1.0
    return m.astype(F)


def vulkan_style_projection(proj: np.ndarray) -> np.ndarray:
    """Flip Y in clip space (vkb::vulkan_style_projection);
    reference call-site: src/volume_render_subpass.cpp:225."""
    m = proj.copy()
    m[1, 1] *= -1.0
    return m


def inverse(m: np.ndarray) -> np.ndarray:
    return np.linalg.inv(m.astype(np.float64)).astype(F)


def inverse_transpose(m: np.ndarray) -> np.ndarray:
    """glm::inverseTranspose — used for transforming plane equations
    (reference: src/volume_render_subpass.cpp:239)."""
    return np.linalg.inv(m.astype(np.float64)).T.astype(F)


def transform_point(m: np.ndarray, p) -> np.ndarray:
    v = m.astype(np.float64) @ np.append(np.asarray(p, dtype=np.float64), 1.0)
    return (v[:3] / v[3]).astype(F)


def transform_vector(m: np.ndarray, v) -> np.ndarray:
    return (m.astype(np.float64)[:3, :3] @ np.asarray(v, dtype=np.float64)).astype(F)
