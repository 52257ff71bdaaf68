"""The plain reference that decides ``correct``: the maps and the frame of
the reference renderer (VkVolume), worked out again from the volume, the
transfer function and the camera, in plain PyTorch. It imports nothing of
the program and takes nothing the program has made.

* ``gradient_map``: the 4-tap tetrahedron gradient magnitude as R8 unorm
  (shaders/gradient_map.comp, get_gradient_compute.glsl:5-23);
* ``occupancy``: the per-voxel closed-form test ``alpha > 0``
  (occupancy_map.comp:45-73, transfer_function.glsl:40-43), any voxel of a
  block occupied, OCCUPIED = 0 / EMPTY = 255;
* ``isotropic_distance`` / ``anisotropic_distance``: the Chebyshev
  distance to the nearest occupied block, uncapped, or per octant capped
  at 63 (distance_map.comp, distance_map_anisotropic.comp): a frozen copy
  (commit 6863543) of ``axis_scan`` and ``relax`` in
  ``vkvolume_tpu_torch/accel/distance.py``, the separable
  Saito-Toriwaki passes;
* ``render``: a per-ray march with the reference's semantics
  (volume_render.frag:117-336): the rays of the pixel centres through the
  volume's unit texture cube, clipped by the camera's clip plane; steps of
  1 / (dim_max * sampling_factor) of the ray's length; trilinear samples
  with CLAMP_TO_EDGE; the closed-form grayscale TF (intensity, times the
  gradient term when the TF has a gradient window); opacity correction;
  front-to-back compositing; early ray termination at alpha > 0.99. It
  marches every step, without empty-space skipping, which only leaps
  over steps whose samples are transparent.

Every float operation runs in ``dtype``: float32, the precision the
configurations state, or a lower one for the control.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

OCCUPIED, EMPTY = 0, 255
ANISO_CAP = 63
_TAPS = ((1, -1, -1), (-1, -1, 1), (-1, 1, -1), (1, 1, 1))
_CHECK = 16             # march steps between compactions of the live rays


def _f32(x: float) -> float:
    return float(np.float32(x))


def tf_terms(tf: dict) -> dict:
    """The TF's float32 uniforms (src/volume_component.cpp:226-240)."""
    g_range = tf["gradient_max"] - tf["gradient_min"]
    return dict(
        imin=_f32(tf["intensity_min"]),
        iinv=_f32(1.0 / (tf["intensity_max"] - tf["intensity_min"])),
        gmin=_f32(tf["gradient_min"]),
        ginv=_f32(1.0 / g_range if g_range else 1.0),
        use_gradient=g_range != 0.0,
        sf=_f32(tf.get("sampling_factor", 1.0)),
        vaf=_f32(tf.get("voxel_alpha_factor", 1.0)))


def gradient_map(vol: torch.Tensor, dtype=torch.float32,
                 slab: int = 64) -> torch.Tensor:
    """R8-unorm gradient magnitude of a (D, H, W) u8 volume, taps clamped
    to the volume, ``slab`` planes at a time."""
    d, h, w = vol.shape
    out = torch.empty_like(vol)
    for z0 in range(0, d, slab):
        z1 = min(d, z0 + slab)
        zi = torch.arange(z0 - 1, z1 + 1, device=vol.device).clamp(0, d - 1)
        sub = F.pad(vol[zi].to(torch.float32)[None], (1, 1, 1, 1),
                    mode="replicate")[0].to(torch.int32)
        acc = [torch.zeros((z1 - z0, h, w), dtype=torch.int32,
                           device=vol.device) for _ in range(3)]
        for ox, oy, oz in _TAPS:
            v = sub[1 + oz:1 + oz + z1 - z0, 1 + oy:1 + oy + h,
                    1 + ox:1 + ox + w]
            for a, o in zip(acc, (ox, oy, oz)):
                a += o * v
        sumsq = sum(a * a for a in acc)
        if dtype == torch.float32:
            mag = torch.sqrt(sumsq.to(torch.float64)).to(torch.float32)
        else:
            mag = torch.sqrt(sumsq.to(dtype))
        g = (mag * (0.25 / 255.0)).clamp(0.0, 1.0)
        out[z0:z1] = torch.round(g * 255.0).to(torch.uint8)
    return out


def _alpha_positive(u8: torch.Tensor, lo: float, inv: float,
                    dtype) -> torch.Tensor:
    a = u8.to(dtype)
    a = a * _f32(1.0 / 255.0)
    a = a - lo
    a = a * inv
    return a.clamp(0.0, 1.0) > 0.0


def map_shape(extent_zyx, block: int) -> tuple:
    return tuple(-(-e // block) for e in extent_zyx)


def occupancy(vol: torch.Tensor, grad: torch.Tensor | None, tf: dict,
              block: int, dtype=torch.float32) -> torch.Tensor:
    """u8 occupancy map, ceil(extent / block) cells per axis; a cell's
    voxels are those of the effective block size ceil(extent / cells)."""
    t = tf_terms(tf)
    d, h, w = vol.shape
    mz, my, mx = map_shape((d, h, w), block)
    bz, by, bx = -(-d // mz), -(-h // my), -(-w // mx)
    out = torch.empty((mz, my, mx), dtype=torch.uint8, device=vol.device)
    step = max(1, 64 // bz)
    for k0 in range(0, mz, step):
        k1 = min(mz, k0 + step)
        z0, z1 = k0 * bz, min(d, k1 * bz)
        occ = _alpha_positive(vol[z0:z1], t["imin"], t["iinv"], dtype)
        if t["use_gradient"]:
            occ &= _alpha_positive(grad[z0:z1], t["gmin"], t["ginv"], dtype)
        occ = F.pad(occ.to(torch.uint8),
                    (0, mx * bx - w, 0, my * by - h,
                     0, (k1 - k0) * bz - (z1 - z0)))
        occ = occ.reshape(k1 - k0, bz, my, by, mx, bx).amax((1, 3, 5))
        out[k0:k1] = torch.where(occ > 0, OCCUPIED, EMPTY).to(torch.uint8)
    return out


def axis_scan(occ: torch.Tensor, axis: int, direction: int) -> torch.Tensor:
    """1-D distance scan along ``axis`` (int32): +1: min over x' >= x of
    occ[x'] + (x' - x); -1: over x' <= x; 0: both."""
    occ = occ.to(torch.int32)
    shape = [1] * occ.ndim
    shape[axis] = occ.shape[axis]
    idx = torch.arange(occ.shape[axis], dtype=torch.int32,
                       device=occ.device).reshape(shape)
    g = None
    if direction >= 0:
        g = torch.cummin((occ + idx).flip(axis), dim=axis).values.flip(
            axis) - idx
    if direction <= 0:
        bwd = torch.cummin(occ - idx, dim=axis).values + idx
        g = bwd if g is None else torch.minimum(g, bwd)
    return g


def relax(D: torch.Tensor, axis: int, direction: int) -> torch.Tensor:
    """A[y] = min over n >= 0 in bounds of max(n, D[y + s n]), s the
    direction or both senses (int32)."""
    src = D.to(torch.int32)
    A = src.clone()
    L = A.shape[axis]
    n = 1
    while n < L and n < int(A.max()):
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


def isotropic_distance(occ: torch.Tensor) -> torch.Tensor:
    """(1, mz, my, mx) u8: the Chebyshev distance, uncapped at 255."""
    g = axis_scan(occ, 2, 0).clamp(max=255)
    return relax(relax(g, 1, 0), 0, 0).to(torch.uint8)[None]


def anisotropic_distance(occ: torch.Tensor,
                         cap: int = ANISO_CAP) -> torch.Tensor:
    """(8, mz, my, mx) u8: map 4 i_x + 2 i_y + i_z looks only along x, y,
    z in the senses i = 0 (+) or 1 (-), capped at ``cap``
    (volume_render.frag:209)."""
    maps = []
    for sx in (1, -1):
        g = axis_scan(occ, 2, sx).clamp(max=cap)
        for sy in (1, -1):
            gy = relax(g, 1, sy)
            for sz in (1, -1):
                maps.append(relax(gy, 0, sz).to(torch.uint8))
    return torch.stack(maps)


def distance_maps(vol, grad, tf: dict, block: int, skipmode: int,
                  dtype=torch.float32) -> torch.Tensor:
    """The maps a TF edit builds at ``skipmode`` (2: isotropic, 3: the 8
    octant maps; 0 and 1: the occupancy map)."""
    occ = occupancy(vol, grad, tf, block, dtype)
    if skipmode == 3:
        return anisotropic_distance(occ)
    if skipmode == 2:
        return isotropic_distance(occ)
    return occ[None]


def _trilinear(vol: torch.Tensor, pos: torch.Tensor, dtype) -> torch.Tensor:
    d, h, w = vol.shape
    dims = torch.tensor([w, h, d], dtype=dtype, device=pos.device)
    p = pos * dims - 0.5
    i0f = torch.floor(p)
    frac = p - i0f
    i0 = i0f.to(torch.int64)
    hi = torch.tensor([w - 1, h - 1, d - 1], dtype=torch.int64,
                      device=pos.device)
    i1 = torch.minimum(torch.clamp(i0 + 1, min=0), hi)
    i0 = torch.minimum(torch.clamp(i0, min=0), hi)
    z = torch.stack([i0[:, 2], i1[:, 2]], -1)
    y = torch.stack([i0[:, 1], i1[:, 1]], -1)
    x = torch.stack([i0[:, 0], i1[:, 0]], -1)
    idx = (z[:, :, None, None] * h + y[:, None, :, None]) * w \
        + x[:, None, None, :]
    c = vol.reshape(-1)[idx].to(dtype)
    fx, fy, fz = frac[:, 0:1], frac[:, 1:2], frac[:, 2]
    cx = c[..., 0] + (c[..., 1] - c[..., 0]) * fx[..., None]
    cy = cx[..., 0] + (cx[..., 1] - cx[..., 0]) * fy
    return (cy[:, 0] + (cy[:, 1] - cy[:, 0]) * fz) * _f32(1.0 / 255.0)


def _uniforms(view, proj, model, clip_distance: float) -> dict:
    """The host's camera and clip-plane uniforms
    (src/volume_render_subpass.cpp:221-249), float64."""
    view = np.asarray(view, np.float64)
    proj = np.asarray(proj, np.float64)
    model = np.asarray(model, np.float64)
    model_inv = np.linalg.inv(model)
    to_tex = np.eye(4)
    to_tex[:3, 3] = 0.5
    global_to_tex = to_tex @ model_inv
    view_inv = np.linalg.inv(view)
    cam = view_inv[:3, 3]
    cam_dir = -view_inv[:3, 2]
    plane = np.append(cam_dir, -clip_distance - float(np.dot(cam, cam_dir)))
    return dict(view_proj_inv=np.linalg.inv(proj @ view),
                global_to_tex=global_to_tex,
                cam_tex=(model_inv @ np.append(cam, 1.0))[:3] + 0.5,
                plane_tex=np.linalg.inv(global_to_tex).T @ plane)


def rays(view, proj, model, width: int, height: int, clip_distance: float,
         device, dtype=torch.float32):
    """Per pixel (flattened, row-major): the ray's texture-space entry,
    direction, length and coverage."""
    u = _uniforms(view, proj, model, clip_distance)
    m = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                  device=device).to(dtype)
    py, px = torch.meshgrid(torch.arange(height, device=device),
                            torch.arange(width, device=device),
                            indexing="ij")
    ndc_x = (px.to(dtype) + 0.5) / width * 2.0 - 1.0
    ndc_y = (py.to(dtype) + 0.5) / height * 2.0 - 1.0
    clip = torch.stack([ndc_x, ndc_y, torch.zeros_like(ndc_x),
                        torch.ones_like(ndc_x)], -1).reshape(-1, 4)
    world = clip @ m(u["view_proj_inv"]).T
    world = world[:, :3] / world[:, 3:4]
    pt = (torch.cat([world, torch.ones_like(world[:, :1])], -1)
          @ m(u["global_to_tex"]).T)[:, :3]
    o = m(u["cam_tex"])
    d = pt - o
    d = d / torch.sqrt((d * d).sum(-1, keepdim=True))
    t0 = (0.0 - o) / d
    t1 = (1.0 - o) / d
    t_near = torch.minimum(t0, t1).amax(-1)
    t_far = torch.maximum(t0, t1).amin(-1)
    plane = m(u["plane_tex"])
    s_o = (plane[:3] * o).sum() + plane[3]
    s_d = (d * plane[:3]).sum(-1)
    t_plane = torch.where(s_d != 0.0, -s_o / s_d,
                          torch.full_like(s_d, float("inf")))
    t_entry = torch.where(s_d > 0.0, torch.maximum(t_near, t_plane), t_near)
    valid = (t_entry < t_far) & (t_far > 0.0)
    entry = o + t_entry[:, None] * d
    # The exit recomputed from the entry (volume_render.frag:71-83).
    tb = torch.maximum(-entry / d, (1.0 - entry) / d).amin(-1)
    exit_ = tb[:, None] * d + entry
    span = exit_ - entry
    return entry, d, torch.sqrt((span * span).sum(-1)), valid


def render(vol: torch.Tensor, grad: torch.Tensor | None, tf: dict, view,
           proj, model, width: int, height: int, *, clip_distance: float,
           ert: bool = True, dtype=torch.float32) -> torch.Tensor:
    """The (height, width, 4) premultiplied RGBA frame, float32."""
    t = tf_terms(tf)
    dev = vol.device
    d, h, w = vol.shape
    entry, direction, dist, valid = rays(view, proj, model, width, height,
                                         clip_distance, dev, dtype)
    n_steps = torch.ceil(float(max(w, h, d)) * dist.float() * t["sf"]).to(
        torch.int64)
    step = direction * dist[:, None] / (n_steps[:, None].to(dtype) - 1.0)
    eet = entry + step
    early_out = (eet <= 0.0).any(-1) | (eet >= 1.0).any(-1)
    live = (valid & ~early_out & (n_steps > 0)).nonzero()[:, 0]
    frame = torch.zeros((height * width, 4), dtype=dtype, device=dev)
    e, s, n = entry[live], step[live], n_steps[live]
    color = torch.zeros((live.numel(), 4), dtype=dtype, device=dev)
    done = torch.zeros(live.numel(), dtype=torch.bool, device=dev)
    inv_sf = _f32(1.0 / t["sf"])
    i = 0
    while live.numel():
        pos = e + torch.full((), float(i), dtype=dtype, device=dev) * s
        a = ((_trilinear(vol, pos, dtype) - t["imin"]) * t["iinv"]).clamp(
            0.0, 1.0)
        if t["use_gradient"]:
            a = a * ((_trilinear(grad, pos, dtype) - t["gmin"])
                     * t["ginv"]).clamp(0.0, 1.0)
        a_corr = (t["vaf"] * (1.0 - torch.pow(1.0 - a, inv_sf))).clamp(
            0.0, 1.0)
        blend = (a > 0.0) & ~done
        src = torch.stack([a * a_corr, a * a_corr, a * a_corr, a_corr], -1)
        color = torch.where(blend[:, None],
                            color + (1.0 - color[:, 3:4]) * src, color)
        if ert:
            stop = blend & (color[:, 3] > 0.99)
            color[:, 3] = torch.where(stop, 1.0, color[:, 3])
            done = done | stop
        i += 1
        done = done | (i >= n)
        if i % _CHECK == 0:
            fin = done.nonzero()[:, 0]
            if fin.numel() * 8 >= live.numel():
                frame[live[fin]] = color[fin]
                keep = (~done).nonzero()[:, 0]
                live, e, s, n = live[keep], e[keep], s[keep], n[keep]
                color, done = color[keep], done[keep]
    return frame.reshape(height, width, 4).to(torch.float32)
