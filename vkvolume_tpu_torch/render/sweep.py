"""The XLA plane sweep — port of ``vkvolume_tpu/render/sweep.py``.

Rays advance through slabs perpendicular to the view's principal axis, one
slab per step, every ray at once: per slab, the trilinear sample of each
ray from the slab's two voxel planes (the four-corner bilerp of each plane
and a lerp between them), the closed-form or texture TF, the per-ray
opacity exponent κ = dim_max·Δs/|d_p| (the reference's correction law,
volume_render.frag:283, on the slab geometry), front-to-back compositing,
the first-hit plane for the depth, and ERT at alpha > 0.99.

The JAX package runs it through XLA, not Pallas, so the port's counterpart
is plain PyTorch on every device; it renders the frames the w-grid frame
cannot take (texture-TF views without a brick rect or with fewer slabs
than voxel planes, views with no plan, ``renderer="sweep"``) and the ray
entry / exit ``Test`` frames. Two changes of form give the same image as
the JAX loop:

* the per-slab ``lax.cond`` on the slab's occupancy becomes the list of
  occupied slabs, read on the host once per frame (one sync): a skipped
  slab changes no pixel;
* the chunked ERT loop runs the list in chunks of 16 slabs over the rays
  that can still take a sample in the chunk (covered, not saturated, the
  chunk's planes inside their [s_lo, s_hi]), gathered before the chunk and
  scattered back after it, and stops when no covered ray is left (ERT): a
  ray left out of a chunk would take no sample in it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..options import Test
from ..tf.transfer_function import TFParams, sample_texture
from .ray_setup import (_SLICE_AXES, FrameUniforms, RaySetup, RenderOutput,
                        transpose_for_axis)
from .sweep_slabs import n_steps_max

__all__ = ["entry_exit_frame", "sweep", "transpose_for_axis"]

_INV255 = float(np.float32(1.0 / 255.0))
_CHUNK = 16             # slabs per ERT check


def entry_exit_frame(rays: RaySetup, test: Test) -> RenderOutput:
    """The ray entry / exit position image (volume_render.frag:168-173)."""
    pt = rays.entry if test == Test.RAY_ENTRY else rays.exit
    color = torch.cat([pt, torch.ones_like(pt[..., :1])], -1)
    color = torch.where(rays.valid[..., None], color, 0.0)
    zi = torch.zeros(rays.valid.shape, dtype=torch.int32,
                     device=pt.device)
    return RenderOutput(color, rays.depth_init, zi, zi, zi, 0)


def _slab_order(n_slabs: int, Np: int, sgn: float,
                occupancy_t: torch.Tensor | None) -> list:
    """Front-to-back slab indices whose planes hold an occupied map cell
    (every slab without a map): [(k, s_k, k0, fp)], the scalars in
    float32 as the JAX sweep computes them. Its zp = s_k·Np − 0.5 is taken
    as XLA compiles it: the constant factors folded, ds·Np rounded to
    float32, and one fused multiply-add (exact in float64, rounded once);
    two separate roundings would move k0 at some slabs, and with it their
    occupancy test."""
    f32 = np.float32
    ks = np.arange(n_slabs)
    kh = ks.astype(f32) + f32(0.5)
    ds = f32(1.0 / n_slabs)
    s = kh * ds
    zp = (kh.astype(np.float64) * np.float64(ds * f32(Np)) - 0.5).astype(f32)
    k0 = np.clip(np.floor(zp), 0, Np - 2).astype(np.int64)
    fp = np.clip(zp - k0.astype(f32), f32(0.0), f32(1.0))
    keep = np.ones(n_slabs, bool)
    if occupancy_t is not None:
        mp = occupancy_t.shape[0]
        plane_occ = (occupancy_t == 0).any(dim=2).any(dim=1).cpu().numpy()
        bp = -(-Np // mp)
        keep = (plane_occ[np.clip(k0 // bp, 0, mp - 1)]
                | plane_occ[np.clip((k0 + 1) // bp, 0, mp - 1)])
    order = ks if sgn > 0 else ks[::-1]
    return [(int(k), float(s[k]), int(k0[k]), float(fp[k]))
            for k in order if keep[k]]


def sweep(vol_t: torch.Tensor, grad_t: torch.Tensor | None,
          occupancy_t: torch.Tensor | None, tf: TFParams, rays: RaySetup,
          uniforms: FrameUniforms, proj_view_model,
          tf_texture: torch.Tensor | None = None, *, p_axis: int = 2,
          early_ray_termination: bool = True, test: Test = Test.NONE,
          oversample: float = 1.0) -> RenderOutput:
    """One frame of the plane sweep. ``vol_t`` (Np, Sv, Su) u8 and
    ``grad_t`` (the same layout, or None) are principal-axis-major
    (``transpose_for_axis``), ``occupancy_t`` the (mp, mv, mu) skip map
    (0 = occupied) in the same permutation, or None to sample every slab
    (the JAX sweep's ``skipping=False``), ``rays`` a RaySetup
    with entry and exit (``frustum.rays_from_dirs``), ``proj_view_model`` the host
    (4, 4) float32 matrix of the first-hit depth and ``tf_texture`` the
    (256, 256, 4) u8 baked texture (None: the closed form)."""
    f = torch.float32
    H, W = rays.valid.shape
    dev = vol_t.device
    if test in (Test.RAY_ENTRY, Test.RAY_EXIT):
        return entry_exit_frame(rays, test)
    Np, Sv, Su = vol_t.shape
    v_ax, u_ax = _SLICE_AXES[p_axis]
    dim_max = max(Np, Sv, Su)
    o = [float(c) for c in np.asarray(uniforms.cam_pos_tex, np.float32)]
    o_p, o_u, o_v = o[p_axis], o[u_ax], o[v_ax]

    d = rays.ray_dir
    d_p, d_u, d_v = d[..., p_axis], d[..., u_ax], d[..., v_ax]
    total = float(torch.where(rays.valid, d_p, 0.0).sum())
    sgn = -1.0 if total < 0.0 else 1.0
    safe_dp = torch.where(d_p.abs() < 1e-6,
                          torch.where(d_p < 0, -1e-6, 1e-6), d_p)
    w_u = d_u / safe_dp
    w_v = d_v / safe_dp
    covered = (rays.valid & (d_p.abs() > 1e-6)
               & (torch.sign(d_p) == sgn))

    n_slabs = int(max(2, round(Np * oversample)))
    f32 = np.float32
    kappa_c = float(f32(dim_max) * f32(1.0 / n_slabs))

    # The covered rays, flattened: the sweep's state lives only there (an
    # uncovered ray takes no sample).
    cov_ix = covered.reshape(-1).nonzero()[:, 0]
    n = cov_ix.numel()
    ray = {name: a.reshape(-1)[cov_ix] for name, a in (
        ("w_u", w_u), ("w_v", w_v),
        ("s_lo", torch.minimum(rays.entry[..., p_axis],
                               rays.exit[..., p_axis])),
        ("s_hi", torch.maximum(rays.entry[..., p_axis],
                               rays.exit[..., p_axis])),
        ("kappa", kappa_c / safe_dp.abs()))}
    color = torch.zeros((n, 4), dtype=f, device=dev)
    first_s = torch.full((n,), 2.0, dtype=f, device=dev)  # > 1.5: no hit
    n_samp = torch.zeros((n,), dtype=torch.int32, device=dev)
    done = torch.zeros((n,), dtype=torch.bool, device=dev)

    flat = vol_t.reshape(-1)
    gflat = (grad_t.reshape(-1) if tf.use_gradient and grad_t is not None
             else None)
    plane = Sv * Su

    def trilinear(src, base, r, fp):
        """The four-corner bilerp of planes k0 and k0 + 1, lerped by fp."""
        c = src[base + r["idx"]].to(f)              # (m, 2, 4)
        fu, fv = r["fu"][:, None], r["fv"][:, None]
        c0 = c[..., 0] + (c[..., 1] - c[..., 0]) * fu
        c1 = c[..., 2] + (c[..., 3] - c[..., 2]) * fu
        b = c0 + (c1 - c0) * fv                     # (m, 2)
        return (b[:, 0] + (b[:, 1] - b[:, 0]) * fp) * _INV255

    def tf_color(intensity, gradient):
        if tf_texture is not None:
            rgba = sample_texture(tf_texture, intensity, gradient)
            return rgba[:, :3], rgba[:, 3]
        a = ((intensity - tf.intensity_min)
             * tf.intensity_range_inv).clamp(0.0, 1.0)
        if tf.use_gradient:
            a = a * ((gradient - tf.gradient_min)
                     * tf.gradient_range_inv).clamp(0.0, 1.0)
        return a[:, None].expand(-1, 3), a

    def composite(state, r, k, s_k, k0, fp):
        c, fs, ns, dn = state
        t = float(f32(s_k) - f32(o_p))
        qu = (o_u + r["w_u"] * t) * float(Su) - 0.5
        qv = (o_v + r["w_v"] * t) * float(Sv) - 0.5
        fqu, fqv = torch.floor(qu), torch.floor(qv)
        iu0 = fqu.clamp(0, Su - 1).to(torch.int64)
        iv0 = fqv.clamp(0, Sv - 1).to(torch.int64)
        iu1 = (iu0 + 1).clamp(max=Su - 1)
        iv1 = (iv0 + 1).clamp(max=Sv - 1)
        quad = torch.stack([iv0 * Su + iu0, iv0 * Su + iu1,
                            iv1 * Su + iu0, iv1 * Su + iu1], -1)
        r = dict(r, idx=torch.stack([quad, quad + plane], 1),
                 fu=(qu - fqu).clamp(0.0, 1.0), fv=(qv - fqv).clamp(0.0, 1.0))
        base = k0 * plane
        intensity = trilinear(flat, base, r, fp)
        gradient = (trilinear(gflat, base, r, fp) if gflat is not None
                    else torch.ones_like(intensity))
        rgb, a = tf_color(intensity, gradient)
        in_range = (s_k >= r["s_lo"]) & (s_k <= r["s_hi"]) & ~dn
        a_corr = (tf.voxel_alpha_factor
                  * (1.0 - torch.pow(1.0 - a, r["kappa"]))).clamp(0.0, 1.0)
        contrib = in_range & (a > 0.0)
        src = torch.cat([rgb * a_corr[:, None], a_corr[:, None]], -1)
        c = torch.where(contrib[:, None], c + (1.0 - c[:, 3:4]) * src, c)
        hit = contrib & (a_corr > 0.0) & (fs > 1.5)
        fs = torch.where(hit, s_k, fs)
        if early_ray_termination:
            sat = contrib & (c[:, 3] > 0.99)
            dn = dn | sat
            c = torch.cat([c[:, :3], torch.where(sat, 1.0, c[:, 3])[:, None]],
                          -1)
        return c, fs, ns + in_range.to(torch.int32), dn

    order = _slab_order(n_slabs, Np, sgn, occupancy_t)
    for c0 in range(0, len(order), _CHUNK):
        slabs = order[c0:c0 + _CHUNK]
        if early_ray_termination and not bool((~done).any()):
            break
        s_min = min(sl[1] for sl in slabs)
        s_max = max(sl[1] for sl in slabs)
        sel = (~done & (ray["s_hi"] >= s_min)
               & (ray["s_lo"] <= s_max)).nonzero()[:, 0]
        if sel.numel() == 0:
            continue
        r = {name: a[sel] for name, a in ray.items()}
        state = (color[sel], first_s[sel], n_samp[sel], done[sel])
        for sl in slabs:
            state = composite(state, r, *sl)
        color[sel], first_s[sel], n_samp[sel], done[sel] = state

    # Back to the image; the depth from the first contributing slab
    # (reverse-Z, like the marcher).
    def image(a, fill):
        out = torch.full((H * W,) + a.shape[1:], fill, dtype=a.dtype,
                         device=dev)
        out[cov_ix] = a
        return out.reshape((H, W) + a.shape[1:])

    color, first_s, n_samp = (image(color, 0.0), image(first_s, 2.0),
                              image(n_samp, 0))
    hit = (color[..., 3] > 0.0) & (first_s < 1.5)
    t_hit = first_s - o_p
    pen_xyz = [None, None, None]
    pen_xyz[p_axis] = first_s
    pen_xyz[u_ax] = o_u + w_u * t_hit
    pen_xyz[v_ax] = o_v + w_v * t_hit
    pen = torch.stack(pen_xyz, -1) - 0.5
    pen_h = torch.cat([pen, torch.ones_like(pen[..., :1])], -1)
    pvm = torch.as_tensor(np.asarray(proj_view_model, np.float32), device=dev)
    pen_clip = pen_h @ pvm.T
    w = pen_clip[..., 3]
    pen_depth = pen_clip[..., 2] / torch.where(w == 0, 1.0, w)
    depth = torch.where(hit, pen_depth, rays.depth_init)

    if test == Test.NUM_TEXTURE_SAMPLES:
        val = n_samp.to(f) / n_steps_max(dim_max, tf.sampling_factor)
        color = torch.stack([val, val, val, torch.ones_like(val)], -1)
        color = torch.where(covered[..., None], color, 0.0)

    zi = torch.zeros((H, W), dtype=torch.int32, device=dev)
    return RenderOutput(color=color, depth=depth, num_volume_samples=n_samp,
                        num_distance_samples=zi, num_empty_samples=zi,
                        iterations=n_slabs)
