"""The forward mesh pass — port of ``vkvolume_tpu/render/forward.py``, the
counterpart of the reference's optional scene pass (a ForwardSubpass
drawing the Sponza glTF, wired in ``src/volume_render.cpp:329-356``). Its
two products are what the volume pass reads:

* a reverse-Z depth attachment the volume's rays clip against
  (``volume_render.frag:122-165``, ``render/ray_setup.make_rays`` with
  ``use_depth``: depth 0 = far plane, greater = nearer), and
* the opaque scene colour the volume's front-to-back blend composites
  over (``src/volume_render_subpass.cpp:177-186``:
  ``final = vol + (1 - vol.a) * scene``).

The glTF asset is out of scope; :func:`sponza_lite` builds a stand-in hall
around the 100-unit volume cube.

Rasterisation: the per-triangle quantities (screen vertices, NDC depths,
flat Lambert shade) are computed for the whole mesh at once; the
triangles then fold into the (H, W) depth and colour targets as a
z-buffer. The JAX package folds one triangle per loop step; the port
folds batches of triangles, each batch reduced to its nearest triangle per
pixel (the first in mesh order among equal depths) before the strict
``>`` test against the target. That is the JAX loop's winner at every
pixel, ties included: a later triangle replaces the target only when it
is strictly nearer.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

_BATCH_ELEMS = 1 << 24      # triangles x pixels per batch of the fold


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Opaque triangle soup in world coordinates (flat-shaded)."""

    verts: np.ndarray    # (N, 3) f32 world positions
    faces: np.ndarray    # (T, 3) i32 vertex indices, CCW front-facing
    albedo: np.ndarray   # (T, 3) f32 per-face base colour in [0, 1]


def rasterize(mesh: Mesh, camera, height: int, width: int,
              light_dir=(-0.4, -0.8, -0.45), cull: bool = True,
              device: str | torch.device = "cpu"):
    """Render ``mesh`` from ``camera``: ``(color (H, W, 3) f32, depth (H, W)
    f32)`` on ``device``, with the volume pass's depth conventions
    (reverse-Z, 0 = far / uncovered). Feed ``depth`` to
    ``Engine.render(depth_image=...)`` with
    ``RenderOptions.depth_attachment`` and composite the volume over
    ``color``, or call ``Engine.render_with_scene``."""
    f = torch.float32
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    vp = t((np.asarray(camera.proj, np.float64)
            @ np.asarray(camera.view, np.float64)).astype(np.float32))
    ld = np.asarray(light_dir, np.float64)
    ld = t(ld / np.linalg.norm(ld))
    verts = t(mesh.verts)
    faces = torch.as_tensor(np.asarray(mesh.faces, np.int64), device=device)
    albedo = t(mesh.albedo)

    # ---- per-triangle setup over the whole mesh ----
    tri = verts[faces]                                     # (T, 3, 3)
    clip = torch.cat([tri, torch.ones_like(tri[..., :1])], -1) @ vp.T
    w = clip[..., 3]
    # Near-plane guard: triangles with a vertex at or behind the eye plane
    # are dropped, not clipped.
    w_ok = (w > 1e-6).all(-1)
    ndc = clip[..., :3] / torch.where(w[..., None] == 0, 1.0, w[..., None])
    # The pixel-centre mapping of make_rays: ndc = (px + 0.5)/W*2 - 1.
    sx = (ndc[..., 0] + 1.0) * (0.5 * width) - 0.5          # (T, 3)
    sy = (ndc[..., 1] + 1.0) * (0.5 * height) - 0.5
    z = ndc[..., 2]                                         # reverse-Z

    # Flat Lambert shade per face: key light plus ambient.
    n = torch.linalg.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    n_len = torch.sqrt(n[:, 0] * n[:, 0] + n[:, 1] * n[:, 1]
                       + n[:, 2] * n[:, 2])
    n = n / torch.clamp(n_len, min=1e-12)[:, None]
    lam = torch.clamp(-(n @ ld), min=0.0)
    shade = albedo * (0.3 + 0.7 * lam)[:, None]             # (T, 3)

    # Signed doubled area; world-CCW front faces land with negative screen
    # area (image rows grow downward), so culling keeps area < 0
    # (src/volume_render_subpass.cpp:200-203).
    area = ((sx[:, 1] - sx[:, 0]) * (sy[:, 2] - sy[:, 0])
            - (sy[:, 1] - sy[:, 0]) * (sx[:, 2] - sx[:, 0]))
    face_ok = w_ok & ((area < -1e-12) if cull else (area.abs() > 1e-12))
    inv_area = torch.where(area == 0, 1.0, 1.0 / area)
    # Edge-function rounding at large screen coordinates leaves a seam of
    # pixels outside both triangles of a shared edge; a tolerance scaled
    # by the area, with a floor for small triangles, closes it.
    eps = 1e-6 * area.abs() + 1e-2
    sgn = torch.sign(area)

    py, px = torch.meshgrid(torch.arange(height, device=device, dtype=f),
                            torch.arange(width, device=device, dtype=f),
                            indexing="ij")

    def edge(ax, ay, bx, by):
        """Edge function of (a→b) at every pixel centre: (B, H, W)."""
        ax, ay, bx, by = (v[:, None, None] for v in (ax, ay, bx, by))
        return (bx - ax) * (py - ay) - (by - ay) * (px - ax)

    depth = torch.zeros((height, width), dtype=f, device=device)
    color = torch.zeros((height, width, 3), dtype=f, device=device)
    T = faces.shape[0]
    batch = max(1, _BATCH_ELEMS // max(1, height * width))
    for b0 in range(0, T, batch):
        k = slice(b0, min(T, b0 + batch))
        e0 = edge(sx[k, 1], sy[k, 1], sx[k, 2], sy[k, 2])   # opposite v0
        e1 = edge(sx[k, 2], sy[k, 2], sx[k, 0], sy[k, 0])
        e2 = edge(sx[k, 0], sy[k, 0], sx[k, 1], sy[k, 1])
        s = sgn[k, None, None]
        ep = eps[k, None, None]
        inside = ((e0 * s >= -ep) & (e1 * s >= -ep) & (e2 * s >= -ep)
                  & face_ok[k, None, None])
        zk = z[k]
        zpix = (e0 * zk[:, 0, None, None] + e1 * zk[:, 1, None, None]
                + e2 * zk[:, 2, None, None]) * inv_area[k, None, None]
        # A triangle that fails the z-range never wins: 0 is the clear
        # depth, and the test against the target is strict.
        ok = inside & (zpix <= 1.0) & (zpix > 0.0)
        zb, ib = torch.where(ok, zpix, 0.0).max(dim=0)
        better = zb > depth
        depth = torch.where(better, zb, depth)
        color = torch.where(better[..., None], shade[k][ib], color)
    return color, depth


# ---------------------------------------------------------------------------
# Demo scene: a stand-in for the Sponza hall, scaled to the reference's
# world (the volume is a 100-unit cube centred at the origin,
# src/volume_render.cpp:233).
# ---------------------------------------------------------------------------


def _box(cx, cy, cz, hx, hy, hz):
    """12 CCW (outward-facing) triangles of an axis-aligned box."""
    v = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                  for sz in (-1, 1)], np.float32)
    v = v * np.array([hx, hy, hz], np.float32) + np.array(
        [cx, cy, cz], np.float32)
    # Faces as quads (a, b, c, d), CCW seen from outside; vertex index =
    # 4*sx + 2*sy + sz over (0, 1) signs.
    quads = [
        (0, 1, 3, 2),   # -x
        (6, 7, 5, 4),   # +x
        (0, 4, 5, 1),   # -y
        (2, 3, 7, 6),   # +y
        (0, 2, 6, 4),   # -z
        (1, 5, 7, 3),   # +z
    ]
    faces = []
    for a, b, c, d in quads:
        faces += [(a, b, c), (a, c, d)]
    return v, np.asarray(faces, np.int32)


def _quad(a, b, c, d, nsub: int = 8):
    """A bilinearly subdivided quad (nsub×nsub tiles, 2 triangles each):
    the rasteriser drops a triangle with a vertex behind the eye plane, so
    a camera inside the hall loses only the tiles behind it."""
    a, b, c, d = (np.asarray(p, np.float64) for p in (a, b, c, d))
    us = np.linspace(0.0, 1.0, nsub + 1)
    grid = np.asarray([
        [(a * (1 - u) + b * u) * (1 - t) + (d * (1 - u) + c * u) * t
         for u in us] for t in us], np.float32)          # (n+1, n+1, 3)
    v = grid.reshape(-1, 3)
    idx = np.arange((nsub + 1) * (nsub + 1)).reshape(nsub + 1, nsub + 1)
    faces = []
    for i in range(nsub):
        for j in range(nsub):
            p00, p01 = idx[i, j], idx[i, j + 1]
            p10, p11 = idx[i + 1, j], idx[i + 1, j + 1]
            faces += [(p00, p01, p11), (p00, p11, p10)]
    return v, np.asarray(faces, np.int32)


def sponza_lite(*, floor_y=-50.0, extent=320.0) -> Mesh:
    """A small hall around the volume cube (560 triangles, 356 vertices):
    floor, back and side walls and four columns, so that scene geometry
    lies in front of, behind and through the volume across an orbit."""
    parts = []            # (verts, faces, albedo_rgb)
    e = extent

    def add(vf, rgb):
        parts.append((vf[0], vf[1], np.asarray(rgb, np.float32)))

    # Floor at the volume cube's bottom face (+y up).
    add(_quad([-e, floor_y, -e], [-e, floor_y, e],
              [e, floor_y, e], [e, floor_y, -e]), (0.55, 0.50, 0.42))
    # Back wall (behind the volume at the benchmark orbit's start).
    add(_quad([-e, floor_y, -e], [e, floor_y, -e],
              [e, floor_y + 2 * e, -e], [-e, floor_y + 2 * e, -e]),
        (0.62, 0.58, 0.52))
    # Side walls.
    add(_quad([-e, floor_y, e], [-e, floor_y, -e],
              [-e, floor_y + 2 * e, -e], [-e, floor_y + 2 * e, e]),
        (0.50, 0.44, 0.38))
    add(_quad([e, floor_y, -e], [e, floor_y, e],
              [e, floor_y + 2 * e, e], [e, floor_y + 2 * e, -e]),
        (0.50, 0.44, 0.38))
    # Four columns flanking the volume.
    for cx, cz, rgb in ((-95.0, -95.0, (0.75, 0.68, 0.55)),
                        (95.0, -95.0, (0.75, 0.68, 0.55)),
                        (-95.0, 95.0, (0.70, 0.62, 0.50)),
                        (95.0, 95.0, (0.70, 0.62, 0.50))):
        add(_box(cx, floor_y + 85.0, cz, 14.0, 85.0, 14.0), rgb)

    verts, faces, albedo = [], [], []
    off = 0
    for v, fcs, rgb in parts:
        verts.append(v)
        faces.append(fcs + off)
        albedo.append(np.tile(rgb, (len(fcs), 1)))
        off += len(v)
    return Mesh(verts=np.concatenate(verts),
                faces=np.concatenate(faces),
                albedo=np.concatenate(albedo))
