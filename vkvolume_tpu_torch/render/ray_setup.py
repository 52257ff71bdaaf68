"""Per-pixel ray setup — port of ``vkvolume_tpu/render/ray_setup.py``.

The reference's two rasterised draws (back-face-culled cube + clip-plane
cap) reduce to per-pixel interval arithmetic:

    t_entry = max(t_near(AABB), t_plane),  t_exit = t_far(AABB),
    valid   = t_entry < t_exit and t_exit > 0.

``FrameUniforms`` stays host numpy (float32, built by ``make_uniforms``),
so the host frame plan reads it with no device round trip. Also here: the
principal-axis permutations of ``vkvolume_tpu/render/sweep.py`` and the
``RenderOutput`` record of ``render/marcher_xla.py`` (the marcher itself is
not ported yet), and ``ray_caster_get_back``, the frag-exact ray exit that
``render/frustum.py:rays_from_dirs`` computes.
The depth-attachment ray clamp is not ported yet (ROADMAP A.4).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils import math3d

# Axis permutations: for principal axis p (0=x, 1=y, 2=z), the slab planes
# are indexed by p and the in-plane (row, col) axes are (v, u) in xyz terms.
#   p=z: rows=y, cols=x ; p=y: rows=z, cols=x ; p=x: rows=z, cols=y
_SLICE_AXES = {2: (1, 0), 1: (2, 0), 0: (2, 1)}  # p -> (v_axis, u_axis)


def transpose_for_axis(volume_zyx: torch.Tensor, p: int) -> torch.Tensor:
    """(D,H,W) → (Np, Sv, Su) with the principal axis leading, contiguous."""
    if p == 2:
        return volume_zyx.contiguous()
    if p == 1:
        return volume_zyx.permute(1, 0, 2).contiguous()
    return volume_zyx.permute(2, 0, 1).contiguous()


def axis_shape(shape_zyx, p: int) -> tuple:
    """The shape ``transpose_for_axis`` gives a (D, H, W) volume."""
    d, h, w = shape_zyx
    return {2: (d, h, w), 1: (h, d, w), 0: (w, d, h)}[p]


@dataclasses.dataclass(frozen=True)
class RenderOutput:
    color: torch.Tensor          # (H, W, 4) premultiplied rgba, float32
    depth: torch.Tensor          # (H, W) reverse-Z gl_FragDepth equivalent
    num_volume_samples: torch.Tensor    # (H, W) int32
    num_distance_samples: torch.Tensor  # (H, W) int32
    num_empty_samples: torch.Tensor     # (H, W) int32
    iterations: int              # slab count of the sweep


@dataclasses.dataclass(frozen=True)
class FrameUniforms:
    """Host twin of CameraUniform + RayCastUniform
    (src/volume_render_subpass.h:32-53), float32 numpy."""

    view: np.ndarray            # (4,4)
    proj: np.ndarray            # (4,4)
    view_proj_inv: np.ndarray   # (4,4)
    model: np.ndarray           # (4,4) node_transform @ image_transform
    model_inv: np.ndarray       # (4,4)
    global_to_tex: np.ndarray   # (4,4) translate(0.5) @ model_inv
    plane: np.ndarray           # (4,) world-space clip plane
    plane_tex: np.ndarray       # (4,) texture-space clip plane
    cam_pos_tex: np.ndarray     # (3,)
    block_size: np.ndarray      # (3,) effective per-axis block size
    front_index: np.int32       # octant of plane_tex (kept for parity)


def make_uniforms(
    camera,
    node_transform: np.ndarray,
    image_transform: np.ndarray,
    clip_distance: float,
    block_size_xyz,
) -> FrameUniforms:
    """Host-side uniform assembly (src/volume_render_subpass.cpp:221-249)."""
    view = camera.view.astype(np.float64)
    proj = camera.proj.astype(np.float64)
    model = node_transform.astype(np.float64) @ image_transform.astype(np.float64)
    model_inv = np.linalg.inv(model)
    view_proj_inv = np.linalg.inv(proj @ view)
    model_to_tex = math3d.translate((0.5, 0.5, 0.5)).astype(np.float64)
    global_to_tex = model_to_tex @ model_inv

    view_inv = np.linalg.inv(view)
    cam_pos_global = view_inv[:3, 3]
    cam_pos_model = (model_inv @ np.append(cam_pos_global, 1.0))[:3]
    cam_pos_tex = cam_pos_model + 0.5
    cam_dir_global = -view_inv[:3, 2]
    plane = np.append(
        cam_dir_global, -clip_distance - float(np.dot(cam_pos_global, cam_dir_global))
    )
    plane_tex = np.linalg.inv(global_to_tex).T @ plane
    front_index = (
        (1 if plane_tex[0] < 0 else 0)
        + (2 if plane_tex[1] < 0 else 0)
        + (4 if plane_tex[2] < 0 else 0)
    )
    f32 = lambda a: np.asarray(a, np.float32)
    return FrameUniforms(
        view=f32(view),
        proj=f32(proj),
        view_proj_inv=f32(view_proj_inv),
        model=f32(model),
        model_inv=f32(model_inv),
        global_to_tex=f32(global_to_tex),
        plane=f32(plane),
        plane_tex=f32(plane_tex),
        cam_pos_tex=f32(cam_pos_tex),
        block_size=f32(block_size_xyz),
        front_index=np.int32(front_index),
    )


@dataclasses.dataclass(frozen=True)
class RaySetup:
    """The JAX package's RaySetup, less the two fields of its depth
    attachment (``ray_distance``, ``entry_clip_zw``; ROADMAP A.4), which no
    port path reads. ``make_rays`` (the pixel rays of the w-grid frame)
    fills only the first three fields: PyTorch, unlike XLA, would compute
    the others every frame for no reader. ``rays_from_dirs`` fills them
    all, for the per-slab sweep's w-grid rays and, on ``make_rays``'
    directions, for the XLA sweep and the entry / exit frames."""

    ray_dir: torch.Tensor        # (H, W, 3) normalized, texture space
    valid: torch.Tensor          # (H, W) bool — pixel covered by the draws
    depth_init: torch.Tensor     # (H, W) initial gl_FragDepth (reverse-Z)
    entry: torch.Tensor | None = None          # (H, W, 3) texture coords
    exit: torch.Tensor | None = None           # (H, W, 3)


def ray_caster_get_back(front: torch.Tensor,
                        direction: torch.Tensor) -> torch.Tensor:
    """Exact port of ``ray_caster_get_back`` (volume_render.frag:71-83): the
    ray's exit from the unit cube, recomputed from its entry point."""
    dir_inv = 1.0 / direction
    t_min = -front * dir_inv
    t_max = (1.0 - front) * dir_inv
    t_far = torch.maximum(t_min, t_max).amin(dim=-1, keepdim=True)
    return t_far * direction + front


def make_rays(u: FrameUniforms, height: int, width: int,
              device: str | torch.device = "cpu") -> RaySetup:
    """The per-pixel rays of an H×W image on ``device``."""
    f = torch.float32
    m = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    py, px = torch.meshgrid(torch.arange(height, device=device),
                            torch.arange(width, device=device), indexing="ij")
    ndc_x = (px.to(f) + 0.5) / width * 2.0 - 1.0
    ndc_y = (py.to(f) + 0.5) / height * 2.0 - 1.0

    # Unproject at the FAR plane (reverse-Z: z_ndc = 0): a near-camera depth
    # would cancel catastrophically in f32.
    clip = torch.stack(
        [ndc_x, ndc_y, torch.zeros_like(ndc_x), torch.ones_like(ndc_x)], -1)
    world = clip @ m(u.view_proj_inv).T
    world = world[..., :3] / world[..., 3:4]
    pt_tex = (torch.cat([world, torch.ones_like(world[..., :1])], -1)
              @ m(u.global_to_tex).T)[..., :3]

    o = m(u.cam_pos_tex)
    d = pt_tex - o
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)

    dir_inv = 1.0 / d
    t0 = (0.0 - o) * dir_inv
    t1 = (1.0 - o) * dir_inv
    t_near = torch.minimum(t0, t1).amax(dim=-1)
    t_far = torch.maximum(t0, t1).amin(dim=-1)

    plane = m(u.plane_tex)
    s_o = torch.dot(plane[:3], o) + plane[3]
    s_d = d @ plane[:3]
    t_plane = torch.where(s_d != 0.0, -s_o / s_d,
                          torch.tensor(float("inf"), device=device))
    t_entry = torch.where(s_d > 0.0, torch.maximum(t_near, t_plane), t_near)
    valid = (t_entry < t_far) & (t_far > 0.0)
    # No depth attachment: gl_FragDepth starts at 0 (reverse-Z far plane).
    depth_init = torch.zeros((height, width), dtype=f, device=device)
    return RaySetup(ray_dir=d, valid=valid, depth_init=depth_init)
