"""Per-pixel ray setup — port of ``vkvolume_tpu/render/ray_setup.py``.

The reference's two rasterised draws (back-face-culled cube + clip-plane
cap) reduce to per-pixel interval arithmetic:

    t_entry = max(t_near(AABB), t_plane),  t_exit = t_far(AABB),
    valid   = t_entry < t_exit and t_exit > 0.

``FrameUniforms`` stays host numpy (float32, built by ``make_uniforms``),
so the host frame plan reads it with no device round trip. Also here: the
principal-axis permutations of ``vkvolume_tpu/render/sweep.py``, the
``RenderOutput`` record of ``render/marcher_xla.py`` (``render/marcher.py``
here), ``ray_caster_get_back``, the frag-exact ray exit, and
``rays_from_dirs`` of ``render/frustum.py``: the entry and exit of rays
along given directions, which ``make_rays``' full form and the per-slab
sweep's w-grid rays share.

With a depth attachment (the DEPTH_ATTACHMENT variant,
volume_render.frag:122-165) ``make_rays`` discards the pixels whose scene
depth lies in front of the ray's entry (a manual reverse-Z test), starts
gl_FragDepth at the scene depth and clamps the ray's exit at the scene.
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
    iterations: int              # sweep: slab count; marcher: trip count


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
    """The JAX package's RaySetup. ``make_rays`` (the pixel rays of the
    w-grid frame) fills only the first three fields unless asked for the
    full setup: PyTorch, unlike XLA, would compute the others every frame
    for no reader. ``rays_from_dirs`` fills the entry and exit, for the
    per-slab sweep's w-grid rays. The full setup (the XLA sweep, the
    entry / exit frames, the marcher and edge repair) fills every
    field."""

    ray_dir: torch.Tensor        # (H, W, 3) normalized, texture space
    valid: torch.Tensor          # (H, W) bool — pixel covered by the draws
    depth_init: torch.Tensor     # (H, W) initial gl_FragDepth (reverse-Z)
    entry: torch.Tensor | None = None          # (H, W, 3) texture coords
    exit: torch.Tensor | None = None           # (H, W, 3)
    ray_distance: torch.Tensor | None = None   # (H, W) |exit - entry|
    entry_clip_zw: torch.Tensor | None = None  # (H, W, 2) clip z, w at entry


def ray_caster_get_back(front: torch.Tensor,
                        direction: torch.Tensor) -> torch.Tensor:
    """Exact port of ``ray_caster_get_back`` (volume_render.frag:71-83): the
    ray's exit from the unit cube, recomputed from its entry point."""
    dir_inv = 1.0 / direction
    t_min = -front * dir_inv
    t_max = (1.0 - front) * dir_inv
    t_far = torch.maximum(t_min, t_max).amin(dim=-1, keepdim=True)
    return t_far * direction + front


def _norm(v: torch.Tensor) -> torch.Tensor:
    """Euclidean length over the last axis, summed in order."""
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]
                      + v[..., 2] * v[..., 2])


def _interval(u: FrameUniforms, o: torch.Tensor, d: torch.Tensor):
    """Each ray's entry parameter and its coverage, from the camera's
    texture-space position ``o`` along the directions ``d`` (the AABB slab
    test and the clip-plane entry clamp)."""
    dev = d.device
    dir_inv = 1.0 / d
    t0 = (0.0 - o) * dir_inv
    t1 = (1.0 - o) * dir_inv
    t_near = torch.minimum(t0, t1).amax(dim=-1)
    t_far = torch.maximum(t0, t1).amin(dim=-1)
    plane = torch.as_tensor(np.asarray(u.plane_tex, np.float32), device=dev)
    s_o = torch.dot(plane[:3], o) + plane[3]
    s_d = d @ plane[:3]
    t_plane = torch.where(s_d != 0.0, -s_o / s_d,
                          torch.tensor(float("inf"), device=dev))
    t_entry = torch.where(s_d > 0.0, torch.maximum(t_near, t_plane), t_near)
    valid = (t_entry < t_far) & (t_far > 0.0)
    return t_entry, valid


def rays_from_dirs(u: FrameUniforms, dirs: torch.Tensor) -> RaySetup:
    """Entry / exit / coverage of rays from the camera along ``dirs``
    ((H, W, 3) normalised texture-space directions), on their device —
    port of ``rays_from_dirs`` in ``vkvolume_tpu/render/frustum.py``. A
    w-grid cell's ray leaves the camera along ``dir ∝ (w_u, w_v, 1)`` in
    (u, v, p) texture axes; the per-slab sweep (K7) reads each cell's
    interval."""
    o = torch.as_tensor(np.asarray(u.cam_pos_tex, np.float32),
                        device=dirs.device)
    t_entry, valid = _interval(u, o, dirs)
    entry = o + t_entry[..., None] * dirs
    # The exit recomputed from the entry, as the fragment shader does.
    exit_ = ray_caster_get_back(entry, dirs)
    return RaySetup(
        ray_dir=dirs, valid=valid,
        depth_init=torch.zeros(dirs.shape[:2], dtype=torch.float32,
                               device=dirs.device),
        entry=entry, exit=exit_)


def make_rays(u: FrameUniforms, height: int, width: int,
              device: str | torch.device = "cpu",
              depth_image: torch.Tensor | None = None,
              use_depth: bool = False, full: bool = False) -> RaySetup:
    """The per-pixel rays of an H×W image on ``device``: directions,
    coverage and the initial depth, or with ``full`` (implied by a depth
    attachment) every field. ``depth_image`` (H, W), reverse-Z like the
    D32 attachment, clips the rays when ``use_depth``."""
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

    use_depth = use_depth and depth_image is not None
    if not (full or use_depth):
        # No depth attachment: gl_FragDepth starts at 0 (reverse-Z far).
        depth_init = torch.zeros((height, width), dtype=f, device=device)
        return RaySetup(ray_dir=d, valid=_interval(u, o, d)[1],
                        depth_init=depth_init)

    # The entry and exit of the XLA sweep's rays, then the depth fields.
    rays = rays_from_dirs(u, d)
    valid, entry, exit_ = rays.valid, rays.entry, rays.exit
    # Clip-space position of the entry (depth write, manual z-test).
    one = torch.ones_like(entry[..., :1])
    world_entry = torch.cat([entry - 0.5, one], -1) @ m(u.model).T
    clip_entry = world_entry @ (m(u.view).T @ m(u.proj).T)
    entry_clip_zw = clip_entry[..., 2:4]
    if use_depth:
        frag_depth = depth_image.to(device=device, dtype=f)
        depth_front = entry_clip_zw[..., 0] / entry_clip_zw[..., 1]
        # Manual reverse-Z test of the front face (volume_render.frag:
        # 127-135).
        valid = valid & (frag_depth <= depth_front)
        depth_init = frag_depth
        # The ray meets the depth buffer where the entry fragment's clip
        # xyz, scaled by frag_depth / depth_front, unprojects
        # (volume_render.frag:152-164).
        safe_front = torch.where(depth_front == 0.0, 1.0, depth_front)
        scale = frag_depth / safe_front
        clip_at_depth = torch.cat([clip_entry[..., :3] * scale[..., None],
                                   clip_entry[..., 3:4]], -1)
        pos = clip_at_depth @ m(u.view_proj_inv).T
        pos = pos[..., :3] / pos[..., 3:4]
        hit_tex = (torch.cat([pos, one], -1)
                   @ m(u.model_inv).T)[..., :3] + 0.5
        nearer = _norm(hit_tex - entry) < _norm(exit_ - entry)
        exit_ = torch.where(nearer[..., None], hit_tex, exit_)
    else:
        # gl_FragDepth starts at 0, the reverse-Z far plane
        # (volume_render.frag:139-141).
        depth_init = rays.depth_init
    return RaySetup(ray_dir=d, valid=valid, depth_init=depth_init,
                    entry=entry, exit=exit_,
                    ray_distance=_norm(exit_ - entry),
                    entry_clip_zw=entry_clip_zw)
