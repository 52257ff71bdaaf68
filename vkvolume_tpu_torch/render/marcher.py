"""The reference-exact per-ray marcher — port of
``vkvolume_tpu/render/marcher_xla.py``.

The semantic twin of the reference's hot loop
(``shaders/volume_render.frag:117-336``): per pixel, a state machine over
the step index ``i`` with

* empty-space skipping: when the previous sample was transparent and the
  ray has moved into a new distance-map cell, fetch the Chebyshev distance
  and leap ``i`` forward by the GLSL formula (:242-244), or by one block in
  BLOCK mode (:239); on entering an occupied cell, step back by
  ``ceil(sampling_factor)``, floored at ``i_min`` (:253-261);
* trilinear sampling, the closed-form or texture TF, opacity correction
  ``1-(1-a)^(1/sf)`` and front-to-back compositing (:272-287);
* early ray termination at accumulated alpha > 0.99 (:293-299);
* the first-hit depth (:315-321) and the RayEntry / RayExit /
  NumTextureSamples diagnostics (:168-173, 323-335).

Every ray advances one event per loop body, all rays in lock step with
per-ray masks, until every ray is done. The JAX package runs this loop as
an XLA ``while_loop``, so the port's counterpart is plain PyTorch on every
device. Two changes of form give the same image and counters:

* the state lives only on the rays still marching: the loop tests for
  finished rays on the host every ``_CHECK`` bodies (one sync each) and,
  once at least an eighth of them have finished, writes those out and
  drops them. A finished ray's body is a masked no-op, so running it up
  to the next test changes nothing;
* ``iterations``, JAX's trip count (the bodies in which some ray was
  active), is the most bodies any ray was active in, which each ray
  counts; ``max_iterations`` stops the loop after exactly that many
  bodies.

JAX's row banding of large marches (``vkvolume_tpu/engine/engine.py:
623-652``) is a TPU watchdog workaround and is not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from ..options import SkippingType, Test
from ..tf.transfer_function import TFParams, sample_texture
from . import sampling
from .ray_setup import RaySetup, RenderOutput
from .sweep import entry_exit_frame
from .sweep_bricks import n_steps_max

_BIG = 1e30
_CHECK = 8              # loop bodies between the host's tests for done rays


def march(
    volume_u8: torch.Tensor,               # (D, H, W) uint8
    gradient_u8: torch.Tensor | None,      # (D, H, W) uint8 or None
    dist_maps_u8: torch.Tensor | None,     # (N, mz, my, mx) uint8
    tf: TFParams,
    rays: RaySetup,                        # the full setup (make_rays full)
    block_size_xyz,                        # (3,) effective block size
    proj_view_model,                       # (4, 4) proj@view@model, host
    tf_texture: torch.Tensor | None = None,  # (256, 256, 4) u8
    vol_origin_z=None,                     # slab's first global plane
    *,
    skipping_type: SkippingType = SkippingType.DISTANCE,
    early_ray_termination: bool = True,
    precomputed_gradient: bool = True,
    test: Test = Test.NONE,
    count_samples: bool = False,
    max_iterations: int = 0,               # 0 = until every ray is done
    global_depth: int | None = None,       # volume-sharded: the full depth
) -> RenderOutput:
    """March every ray of ``rays`` ((H, W) lanes) through the volume.
    ``dist_maps_u8`` holds one map (isotropic distance, or the occupancy
    map for BLOCK) or the 8 octant maps (ANISOTROPIC_DISTANCE), on the
    volume's device; None with SkippingType.NONE."""
    f = torch.float32
    f32 = np.float32
    H, W = rays.valid.shape
    dev = rays.ray_dir.device
    d, h, w = volume_u8.shape
    if global_depth is not None:
        # Volume-sharded mode: the arrays are z-slabs; every coordinate
        # uses the global extent and the taps rebase into the slab.
        d = global_depth
    dims = torch.tensor([w, h, d], dtype=f, device=dev)
    dim_max = max(w, h, d)
    skip = skipping_type != SkippingType.NONE
    count = count_samples or test == Test.NUM_TEXTURE_SAMPLES

    if test in (Test.RAY_ENTRY, Test.RAY_EXIT):
        return entry_exit_frame(rays, test)

    # --- Per-ray constants (volume_render.frag:176-210) ---
    sf = float(f32(tf.sampling_factor))
    n_steps = torch.ceil(float(f32(dim_max)) * rays.ray_distance * sf).to(
        torch.int32)
    step_volume = (rays.ray_dir * rays.ray_distance[..., None]
                   / (n_steps[..., None].to(f) - 1.0))
    sf_inv = float(f32(1.0) / f32(sf))
    entry = rays.entry
    # Performance guard for edge-on views (frag:182-187).
    eet = entry + step_volume
    early_out = (eet <= 0.0).any(-1) | (eet >= 1.0).any(-1)
    active0 = rays.valid & ~early_out & (n_steps > 0)

    N = H * W
    lanes = active0.reshape(-1).nonzero()[:, 0]
    c = {"entry": entry.reshape(N, 3)[lanes],
         "step": step_volume.reshape(N, 3)[lanes],
         "n_steps": n_steps.reshape(N)[lanes]}
    if skip:
        n_maps, mz, my, mx = dist_maps_u8.shape
        # The maps stacked along z; a ray reads its own map at z offset
        # map_idx * mz.
        maps = dist_maps_u8.reshape(n_maps * mz, my, mx)
        map_hi = torch.tensor([mx - 1, my - 1, mz - 1], dtype=torch.int32,
                              device=dev)
        bs = torch.as_tensor(np.asarray(block_size_xyz, np.float32),
                             device=dev)
        vol_to_map = dims / bs
        c["inv"] = 1.0 / (c["step"] * dims / bs)
        if skipping_type == SkippingType.ANISOTROPIC_DISTANCE:
            # Octant select (volume_render.frag:209).
            rd = rays.ray_dir.reshape(N, 3)[lanes]
            map_idx = ((rd[:, 2] < 0).to(torch.int64)
                       + 2 * (rd[:, 1] < 0).to(torch.int64)
                       + 4 * (rd[:, 0] < 0).to(torch.int64))
            c["map_off"] = torch.stack([torch.zeros_like(map_idx),
                                        torch.zeros_like(map_idx),
                                        map_idx * mz], -1)
        else:
            c["map_off"] = torch.zeros((lanes.numel(), 3), dtype=torch.int64,
                                       device=dev)
        back_step = int(np.ceil(f32(sf)))

    def sample_color(pos):
        intensity = sampling.trilinear(volume_u8, pos, global_depth,
                                       vol_origin_z)
        if tf.use_gradient:
            if precomputed_gradient:
                gradient = sampling.trilinear(gradient_u8, pos,
                                              global_depth, vol_origin_z)
            else:
                gradient = sampling.gradient_on_the_fly(
                    volume_u8, pos, tf.grad_magnitude_modifier,
                    global_depth, vol_origin_z)
        else:
            gradient = torch.ones_like(intensity)
        if tf_texture is not None:
            rgba = sample_texture(tf_texture, intensity, gradient)
            return rgba[:, :3], rgba[:, 3]
        a = ((intensity - tf.intensity_min)
             * tf.intensity_range_inv).clamp(0.0, 1.0)
        if tf.use_gradient:
            a = a * ((gradient - tf.gradient_min)
                     * tf.gradient_range_inv).clamp(0.0, 1.0)
        return a[:, None].expand(-1, 3), a

    m = lanes.numel()
    zi = lambda n: torch.zeros(n, dtype=torch.int32, device=dev)
    s = {"i": zi(m), "i_min": zi(m), "i_first_hit": c["n_steps"].clone(),
         "u_last": torch.zeros((m, 3), dtype=torch.int32, device=dev),
         "occupied": torch.ones(m, dtype=torch.bool, device=dev),
         "color": torch.zeros((m, 4), dtype=f, device=dev),
         "done": torch.zeros(m, dtype=torch.bool, device=dev),
         "n_vol": zi(m), "n_dist": zi(m), "n_empty": zi(m), "n_act": zi(m)}
    # Results over all N lanes; a ray writes its own when it is dropped.
    res = {"color": torch.zeros((N, 4), dtype=f, device=dev),
           "i_first_hit": n_steps.reshape(N).clone(),
           "n_vol": zi(N), "n_dist": zi(N), "n_empty": zi(N),
           "n_act": zi(N)}

    def body(s):
        active = ~s["done"]
        i = s["i"]
        pos = c["entry"] + i.to(f)[:, None] * c["step"]
        if skip:
            u = vol_to_map * pos
            u_i = torch.minimum(u.to(torch.int32).clamp(min=0), map_hi)
            changed = (u_i != s["u_last"]).any(-1)
            do_skip = active & ~s["occupied"] & changed
            # ---- Skip branch (volume_render.frag:224-263) ----
            dist = sampling.texel_fetch(maps, u_i + c["map_off"]).to(f)
            r = (u_i.to(f) - u).clamp(-1.0, 0.0)
            inv = c["inv"]
            if skipping_type == SkippingType.BLOCK:
                delta = ((inv >= 0.0).to(f) + r) * inv
            else:
                delta = ((-inv >= 0.0).to(f) + torch.sign(inv) * dist[:, None]
                         + r) * inv
            # GLSL min() ignores NaN operands; 0 * inf is NaN here.
            delta = torch.where(torch.isnan(delta), _BIG, delta)
            i_delta = torch.ceil(delta.amin(-1)).clamp(1.0, float(2 ** 30))
            empty = dist > 0.0
            new_i_sk = torch.where(
                empty, i + i_delta.to(torch.int32),
                torch.maximum(i - back_step, s["i_min"]))
            occ_sk = s["occupied"] | ~empty
            u_last_sk = torch.where((do_skip & ~empty)[:, None], u_i,
                                    s["u_last"])
            do_sample = active & ~do_skip
        else:
            do_sample = active

        # ---- Sample branch (volume_render.frag:266-310) ----
        rgb, a = sample_color(pos)
        occ_now = a > 0.0
        a_corr = (tf.voxel_alpha_factor
                  * (1.0 - torch.pow(1.0 - a, sf_inv))).clamp(0.0, 1.0)
        src = torch.cat([rgb * a_corr[:, None], a_corr[:, None]], -1)
        blend = do_sample & occ_now
        color = s["color"]
        color = torch.where(blend[:, None],
                            color + (1.0 - color[:, 3:4]) * src, color)
        s["i_first_hit"] = torch.where(blend & (a_corr > 0.0), i,
                                       s["i_first_hit"])
        done = s["done"]
        if early_ray_termination:
            ert_now = blend & (color[:, 3] > 0.99)
            color = torch.cat([color[:, :3],
                               torch.where(ert_now, 1.0, color[:, 3])[:, None]],
                              -1)
            done = done | ert_now
        s["color"] = color

        i1 = i + 1
        if skip:
            u_last = torch.where(blend[:, None], u_i, u_last_sk)
            s["u_last"] = torch.where(active[:, None], u_last, s["u_last"])
            s["occupied"] = torch.where(
                active, torch.where(do_sample, occ_now, occ_sk),
                s["occupied"])
            i_next = torch.where(do_sample, i1, new_i_sk)
            s["i_min"] = torch.where(do_sample, i1, s["i_min"])
        else:
            s["occupied"] = torch.where(active, occ_now, s["occupied"])
            i_next = i1
        s["done"] = done | (i_next >= c["n_steps"])
        s["i"] = torch.where(active, i_next, i)
        if count:
            s["n_vol"] = s["n_vol"] + do_sample.to(torch.int32)
            if skip:
                s["n_dist"] = s["n_dist"] + do_skip.to(torch.int32)
            s["n_empty"] = s["n_empty"] + (do_sample & ~occ_now).to(
                torch.int32)
        s["n_act"] = s["n_act"] + active.to(torch.int32)

    def write_out(sel):
        """Write the results of the lanes ``sel`` (indices into the live
        set) to their pixels."""
        px = lanes[sel]
        for k in res:
            res[k][px] = s[k][sel]

    it = 0
    while lanes.numel() and (not max_iterations or it < max_iterations):
        n = _CHECK if not max_iterations else min(_CHECK,
                                                  max_iterations - it)
        for _ in range(n):
            body(s)
        it += n
        done = s["done"]
        n_done = int(done.sum())
        if n_done == lanes.numel():
            break
        if n_done * 8 >= lanes.numel():
            write_out(done.nonzero()[:, 0])
            keep = (~done).nonzero()[:, 0]
            lanes = lanes[keep]
            s = {k: v[keep] for k, v in s.items()}
            c = {k: v[keep] for k, v in c.items()}
    write_out(slice(None))
    iterations = int(res["n_act"].max()) if N else 0

    # ---- Depth write (volume_render.frag:315-321) ----
    color = res["color"].reshape(H, W, 4)
    i_first_hit = res["i_first_hit"].reshape(H, W)
    hit = (color[..., 3] > 0.0) & (i_first_hit < n_steps)
    pen_tex = entry + step_volume * i_first_hit[..., None].to(f)
    pen_h = torch.cat([pen_tex - 0.5, torch.ones_like(pen_tex[..., :1])], -1)
    pvm = torch.tensor(np.asarray(proj_view_model, np.float32), device=dev)
    pen_clip = pen_h @ pvm.T
    depth = torch.where(hit, pen_clip[..., 2] / pen_clip[..., 3],
                        rays.depth_init)

    n_vol = res["n_vol"].reshape(H, W)
    n_dist = res["n_dist"].reshape(H, W)
    if test == Test.NUM_TEXTURE_SAMPLES:
        # n_steps_max (volume_render.frag:324).
        val = (n_vol + n_dist).to(f) / n_steps_max(dim_max, sf)
        color = torch.stack([val, val, val, torch.ones_like(val)], -1)
        color = torch.where((rays.valid & ~early_out)[..., None], color, 0.0)
    return RenderOutput(color=color, depth=depth, num_volume_samples=n_vol,
                        num_distance_samples=n_dist,
                        num_empty_samples=res["n_empty"].reshape(H, W),
                        iterations=iterations)
