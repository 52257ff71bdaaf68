"""Engine — the application orchestrator, port of
``vkvolume_tpu/engine/engine.py`` restricted to the main path.

Owns the volumes and their acceleration maps, rebakes the TF texture and
rebuilds the occupancy and distance maps on every transfer-function edit
(src/volume_render.cpp:392-445) and renders frames through the w-grid
frame (``render/sweep_frame.py``): the brick sweep (K1) or the per-slab
sweep (K7), then the two-pass warp (K2), the single-pass warp (K8) or the
gather warp, as the view's plan says. The frames the w-grid frame cannot
take go to the XLA sweep (``render/sweep.py``), as in the JAX engine:
views with no plan (or whose narrow re-plan fails), texture-TF views whose
plan has no brick rect or fewer slabs than voxel planes, every frame of
``renderer="sweep"``, and the ray entry / exit ``Test`` frames. All work
runs on the engine's ``device``, by default the CUDA card (no card: it
raises); the kernels run on "cuda", their plain PyTorch versions on
"cpu". A kernel that fails raises: nothing falls back on an exception.

Not ported yet (each raises NotImplementedError naming its ROADMAP item):
the per-ray marcher (mixed-sign views, ``renderer="marcher"``), depth
attachments, edge repair, the scene pass and the accel cache. The TPU
workarounds (compile retries and their re-plan chain, the XLA sweep rung
after a failed compile, watchdog banding, prewarm, frozen plan tiers, A/B
environment knobs) are left out by design.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..accel.distance_cuda import (anisotropic_distance_cuda,
                                   isotropic_distance_cuda)
from ..accel.gradient import gradient_map
from ..accel.occupancy import (_occupancy_u8, _tf_thresholds,
                               occupied_voxel_count)
from ..options import RenderOptions, SkippingType, Test
from ..render import sweep as sweep_mod
from ..render import sweep_frame
from ..render.frustum import rays_from_dirs
from ..render.ray_setup import (RenderOutput, make_rays, make_uniforms,
                                transpose_for_axis)
from ..tf.transfer_function import bake_texture, tf_params
from .volume import Volume, resolve_device


def _octant_composite(maps: torch.Tensor, kz: float, ky: float,
                      kx: float) -> torch.Tensor:
    """Per-cell octant-selected skip map for a pinhole camera.

    The reference picks the distance map per ray by the ray's direction
    octant (volume_render.frag:209). For a pinhole camera that octant is a
    function of which side of the camera's three axis planes a cell lies on
    (idx = (z<kz) + 2*(y<ky) + 4*(x<kx)), so stitching the 8 maps along
    those planes reproduces the per-ray selection for every ray at once.
    ``kz/ky/kx``: the camera position in map-cell coordinates. A cell that
    straddles a camera plane takes the elementwise min of its two sides."""
    def combine(a, b, n, k, axis):
        # a = map for coord < plane (d<0 bit set), b = for coord >= plane.
        shape = [1, 1, 1]
        shape[axis] = n
        c = torch.arange(n, device=a.device).reshape(shape)
        kc = int(np.floor(np.float32(k)))
        out = torch.where(c < kc, a, b)
        return torch.where(c == kc, torch.minimum(a, b), out)

    mz, my, mx = maps.shape[1:]
    # idx = 4*bx + 2*by + bz; combine z pairs, then y, then x.
    z = [combine(maps[i + 1], maps[i], mz, kz, 0) for i in (0, 2, 4, 6)]
    y = [combine(z[2 * j + 1], z[2 * j], my, ky, 1) for j in (0, 1)]
    return combine(y[1], y[0], mx, kx, 2)


def _build_maps_fused(density, gradient, ti: int, tg: int, *, map_shape_zyx,
                      st: SkippingType, use_gradient: bool) -> torch.Tensor:
    """Occupancy + distance transform of one TF edit: (N, mz, my, mx) u8,
    N = 8 for the anisotropic maps, 1 for the isotropic map (DISTANCE) and
    the occupancy map (BLOCK/NONE)."""
    occ = _occupancy_u8(density, gradient if use_gradient else None,
                        map_shape_zyx, ti, tg)
    if st == SkippingType.ANISOTROPIC_DISTANCE:
        return anisotropic_distance_cuda(occ)
    if st == SkippingType.DISTANCE:
        return isotropic_distance_cuda(occ)
    return occ[None]


@dataclasses.dataclass
class UpdateStats:
    """The reference log lines' metrics (src/volume_render.cpp:418, 430).
    In benchmark mode ``map_update_ms`` is the synced per-build time."""

    occupied_voxel_percent: float | None = None
    count_ms: float | None = None
    map_update_ms: float | None = None
    gradient_ms: float | None = None


class Engine:
    def __init__(self, options: RenderOptions | None = None,
                 benchmark_mode: bool = False, renderer: str = "pallas",
                 device: str | torch.device = "cuda"):
        """``renderer``: "pallas" (the w-grid frame through the kernels,
        the XLA sweep for the frames it cannot take) or "sweep" (every
        frame through the XLA sweep); the marcher is not ported.
        ``device``: where volumes, maps and frames live; "cuda" (the
        default) raises when there is no CUDA device."""
        if renderer not in ("pallas", "sweep"):
            raise NotImplementedError(
                f"renderer {renderer!r} (the per-ray marcher): ROADMAP "
                "queue A, item 10")
        self.options = options or RenderOptions()
        self.benchmark_mode = benchmark_mode
        self.renderer = renderer
        self.device = resolve_device(device)
        if benchmark_mode:
            # Benchmark mode forces (src/volume_render.cpp:177-183).
            self.options.clip_distance = 1.0
            self.options.early_ray_termination = False
            self.options.test = Test.NUM_TEXTURE_SAMPLES
        self.volumes: list[Volume] = []
        self.renderer_counts = {"pallas": 0, "sweep": 0, "marcher": 0}
        self.last_renderer = None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---- setup ----------------------------------------------------------

    def add_volume(self, volume: Volume) -> UpdateStats:
        """Load path: gradient map, then the first TF update
        (src/volume_render.cpp:186-242)."""
        if volume.device != self.device:
            raise ValueError(f"volume on {volume.device}, engine on "
                             f"{self.device}")
        self.volumes.append(volume)
        stats = UpdateStats()
        if volume.options.use_precomputed_gradient:
            t0 = time.perf_counter()
            volume.gradient = gradient_map(
                volume.density, 1.0, use_gradient=volume.options.use_gradient)
            self._sync()
            stats.gradient_ms = (time.perf_counter() - t0) * 1e3
        tf_stats = self.update_transfer_function(volume)
        stats.occupied_voxel_percent = tf_stats.occupied_voxel_percent
        stats.count_ms = tf_stats.count_ms
        stats.map_update_ms = tf_stats.map_update_ms
        return stats

    def _tf(self, volume: Volume):
        o = volume.options
        return tf_params(
            intensity_min=o.intensity_min, intensity_max=o.intensity_max,
            gradient_min=o.gradient_min, gradient_max=o.gradient_max,
            sampling_factor=o.sampling_factor,
            voxel_alpha_factor=o.voxel_alpha_factor)

    def _slab_oversample(self, volume: Volume, vol_t_shape, tf) -> float:
        """Slabs per principal-axis voxel plane (RenderOptions.slab_density):
        "ref" matches the reference's per-ray step density 1/(dim_max·sf);
        "auto" pays that (× grad_density_mult) only for gradient TFs."""
        sf = float(volume.options.sampling_factor)
        mode = self.options.slab_density
        mult = 1.0
        if mode == "auto":
            if tf.use_gradient:
                mode = "ref"
                mult = float(self.options.grad_density_mult)
            else:
                mode = "axis"
        if mode == "ref":
            return sf * max(vol_t_shape) / vol_t_shape[0] * mult
        return sf

    def update_transfer_function(self, volume: Volume,
                                 timed_runs: int = 5) -> UpdateStats:
        """TF-edit recompute path (src/volume_render.cpp:392-445): bake the
        TF texture, count occupied voxels (benchmark mode), rebuild the
        occupancy map and the distance maps of the active skipping type.
        Benchmark mode times 4 × ``timed_runs`` queued builds after one
        warm build, with one sync at the end; interactive edits build once
        and stay queued."""
        o = volume.options
        tf = self._tf(volume)
        stats = UpdateStats()
        volume.tf_texture = bake_texture(
            intensity_min=o.intensity_min, intensity_max=o.intensity_max,
            gradient_min=o.gradient_min, gradient_max=o.gradient_max)
        gradient = volume.gradient if o.use_precomputed_gradient else None
        if tf.use_gradient and gradient is None:
            raise NotImplementedError(
                "on-the-fly gradients in the map build: ROADMAP queue A, "
                "item 5")
        tf_host = (o.intensity_min, o.intensity_max,
                   o.gradient_min, o.gradient_max)
        if self.benchmark_mode:
            t0 = time.perf_counter()
            n_occ = occupied_voxel_count(volume.density, gradient, tf,
                                         tf_host)
            stats.count_ms = (time.perf_counter() - t0) * 1e3
            stats.occupied_voxel_percent = (
                100.0 * n_occ / int(np.prod(volume.density.shape)))
        thr = _tf_thresholds(tf_host)
        if thr is None:
            raise NotImplementedError(
                "non-monotone TF ranges (general float occupancy path): "
                "ROADMAP queue A, item 5")
        ti, tg = thr

        def build_maps():
            return _build_maps_fused(
                volume.density, gradient, ti, tg,
                map_shape_zyx=volume.map_shape_zyx,
                st=self.options.skipping_type, use_gradient=tf.use_gradient)

        runs = timed_runs * 4 if self.benchmark_mode else 1
        if self.benchmark_mode:
            build_maps()
            self._sync()
        t0 = time.perf_counter()
        for _ in range(runs):
            maps = build_maps()
        if self.benchmark_mode:
            self._sync()
        stats.map_update_ms = (time.perf_counter() - t0) * 1e3 / runs
        volume.dist_maps = maps
        volume._maps_version = getattr(volume, "_maps_version", 0) + 1
        return stats

    # ---- per-frame ------------------------------------------------------

    def render(self, camera, width: int, height: int) -> RenderOutput:
        """One frame: per volume, blended front-to-back in draw order
        (src/volume_render_subpass.cpp:159-293)."""
        out = None
        for volume in self.volumes:
            result = self.render_volume(volume, camera, width, height)
            if out is None:
                out = result
            else:
                # Blend state ONE, ONE_MINUS_SRC_ALPHA; reverse-Z depth.
                c = result.color + (1.0 - result.color[..., 3:4]) * out.color
                out = dataclasses.replace(
                    result, color=c,
                    depth=torch.maximum(result.depth, out.depth),
                    num_volume_samples=(result.num_volume_samples
                                        + out.num_volume_samples),
                    num_distance_samples=(result.num_distance_samples
                                          + out.num_distance_samples),
                    num_empty_samples=(result.num_empty_samples
                                       + out.num_empty_samples))
        return out

    def render_volume(self, volume: Volume, camera, width: int,
                      height: int) -> RenderOutput:
        out = self._render_sweep(volume, camera, width, height)
        if out is None:
            raise NotImplementedError(
                "mixed principal-axis views need the per-ray marcher: "
                "ROADMAP queue A, item 10")
        return out

    def _tf_texture(self, volume: Volume) -> torch.Tensor | None:
        """The baked TF texture on the device when the texture-TF variant
        is active (RenderOptions.texture_tf), else None (closed form)."""
        if not self.options.texture_tf:
            return None
        return volume.texture_on_device()

    def _full_rays(self, uniforms, height: int, width: int):
        """The pixel rays with their entry and exit (the XLA sweep's and
        the entry / exit frames' RaySetup)."""
        return rays_from_dirs(
            uniforms, make_rays(uniforms, height, width, self.device).ray_dir)

    def _render_sweep(self, volume: Volume, camera, width: int,
                      height: int) -> RenderOutput | None:
        """The w-grid frame or the XLA sweep's, or None when the view needs
        the marcher (mixed principal-axis signs, no coverage)."""
        if self.options.depth_attachment or self.options.edge_repair:
            raise NotImplementedError(
                "depth attachment / edge repair: ROADMAP queue A, items 4 "
                "and 11")
        if self.renderer == "pallas" and (height % 8 or width % 128):
            # Render a tile-aligned padded viewport whose top-left window
            # has pixel-identical rays, then crop.
            from ..camera import pad_viewport

            hp = -(-height // 8) * 8
            wp = -(-width // 128) * 128
            out = self._render_sweep(
                volume, pad_viewport(camera, width, height, wp, hp), wp, hp)
            if out is None:
                return None
            crop = lambda a: a[:height, :width]
            return dataclasses.replace(
                out, color=crop(out.color), depth=crop(out.depth),
                num_volume_samples=crop(out.num_volume_samples),
                num_distance_samples=crop(out.num_distance_samples),
                num_empty_samples=crop(out.num_empty_samples))

        cache = getattr(volume, "_sweep_cache", None)
        if cache is None:
            cache = volume._sweep_cache = {}

        # Per-camera-pose cache: a static camera renders with no host
        # analysis; a moving one pays the host plan only.
        cam_key = (camera.view.tobytes(), camera.proj.tobytes(),
                   float(self.options.clip_distance), height, width,
                   np.asarray(volume.model_matrix).tobytes())
        pose = cache.get(("pose", cam_key))
        dsh = tuple(volume.density.shape)
        if pose is None:
            uniforms = make_uniforms(
                camera, volume.node_transform, volume.image_transform,
                self.options.clip_distance,
                np.asarray(volume.effective_block_size_xyz, np.float32))

            def shape_for(q):
                return {2: dsh, 1: (dsh[1], dsh[0], dsh[2]),
                        0: (dsh[2], dsh[0], dsh[1])}[q]

            view, plan = sweep_frame.select_view_plan(uniforms, height, width,
                                                      shape_for)
            pose = dict(uniforms=uniforms, view=view, plan=plan)
            keys = [k for k in cache if isinstance(k, tuple)
                    and k[0] == "pose"]
            if len(keys) > 64:
                for k in keys:
                    del cache[k]
            cache[("pose", cam_key)] = pose
        uniforms, view, plan = pose["uniforms"], pose["view"], pose["plan"]
        if self.options.test in (Test.RAY_ENTRY, Test.RAY_EXIT):
            # No march: the entry / exit position images come straight
            # from the ray setup (the JAX engine's route, any view).
            self.last_renderer = "sweep"
            self.renderer_counts["sweep"] += 1
            return sweep_mod.entry_exit_frame(
                self._full_rays(uniforms, height, width), self.options.test)
        if view is None or view["mixed"]:
            return None
        p = view["p_axis"]
        if p not in cache:
            cache[p] = transpose_for_axis(volume.density, p)
        vol_t = cache[p]
        tf = self._tf(volume)
        grad_t = None
        if tf.use_gradient:
            # The gradient map (update_transfer_function refused the TF
            # without one), transposed and cached beside vol_t.
            if ("grad", p) not in cache:
                cache[("grad", p)] = transpose_for_axis(volume.gradient, p)
            grad_t = cache[("grad", p)]

        # Skip map: 0 ⇔ occupied for every map kind; distance maps also
        # drive the leap (dist_leap). The 8 octant maps are stitched per
        # cell for this camera (exact per-ray selection, see
        # _octant_composite); the stitch depends on the camera only through
        # the map cell holding it, which keys the cache.
        st = self.options.skipping_type
        dist_leap = st in (SkippingType.DISTANCE,
                           SkippingType.ANISOTROPIC_DISTANCE)
        occ_t = None
        if volume.dist_maps is not None and st != SkippingType.NONE:
            maps = volume.dist_maps
            ver = getattr(volume, "_maps_version", 0)
            if maps.shape[0] == 8:
                bs = np.asarray(volume.effective_block_size_xyz, np.float64)
                cam = np.asarray(uniforms.cam_pos_tex, np.float64)
                ks = (cam[2] * dsh[0] / bs[2], cam[1] * dsh[1] / bs[1],
                      cam[0] * dsh[2] / bs[0])
                sel = tuple(int(np.floor(k)) for k in ks)
            else:
                ks = None
                sel = tuple(range(maps.shape[0]))
            occ_key = ("occ", p, ver, sel)
            occ_t = cache.get(occ_key)
            if occ_t is None:
                stale = [k for k in cache if isinstance(k, tuple)
                         and k[0] == "occ" and k[2] != ver]
                live = [k for k in cache if isinstance(k, tuple)
                        and k[0] == "occ" and k[2] == ver]
                for k in stale + (live if len(live) > 16 else []):
                    del cache[k]
                if ks is not None:
                    src = _octant_composite(maps, *ks)
                else:
                    src = maps[0]
                    for i in sel[1:]:
                        src = torch.minimum(src, maps[i])
                occ_t = transpose_for_axis(src, p)
                cache[occ_key] = occ_t
        oversample = self._slab_oversample(volume, vol_t.shape, tf)
        n_slabs = int(max(2, round(vol_t.shape[0] * oversample)))
        if self.renderer != "pallas" or min(vol_t.shape[1:]) < 2:
            plan = None
        elif self.options.texture_tf and (
                plan is None or plan.get("R_brick") is None
                or n_slabs < vol_t.shape[0]
                or plan["Hi"] % plan.get("tile_h", 8)):
            # The texture-TF variant exists only in the brick sweep, which
            # needs a brick rect, a slab per voxel plane and a grid that
            # tiles by tile_h (the frame's test for K1); checked before the
            # narrow re-plan below, as the JAX engine does.
            plan = None
        elif plan is not None and plan.get("rect_w", 256) > 256 \
                and n_slabs < vol_t.shape[0]:
            # Wide-rect plans exist only for the brick sweep, which needs a
            # slab per voxel plane; fewer slabs (sampling_factor < 1) run
            # the per-slab sweep on a 256-rect re-plan of the same view.
            narrow = pose.get("plan_narrow")
            if narrow is None:
                narrow = sweep_frame.plan_from_stats(
                    view, uniforms, p, vol_t.shape, height, width,
                    max_rect=256)
                pose["plan_narrow"] = narrow if narrow is not None else False
            plan = narrow or None
        if plan is None:
            self.last_renderer = "sweep"
            self.renderer_counts["sweep"] += 1
            return sweep_mod.sweep(
                vol_t, grad_t, occ_t, tf,
                self._full_rays(uniforms, height, width), uniforms,
                self._pvm(camera, volume), self._tf_texture(volume), p_axis=p,
                early_ray_termination=self.options.early_ray_termination,
                test=self.options.test, oversample=oversample)
        if occ_t is None:
            occ_t = torch.zeros((1, 1, 1), dtype=torch.uint8,
                                device=self.device)
            dist_leap = False
        gp = (plan["wu0"], plan["dwu"], plan.get("cu", 0.0),
              plan["wv0"], plan["dwv"], plan.get("cv", 0.0))
        # Keyed by the plan's grid: a TF or sampling edit can switch a
        # cached pose between its plan and its narrow re-plan.
        if pose.get("packed_gp") != gp:
            pose["packed"] = sweep_frame.pack_frame_scalars(
                uniforms, self._pvm(camera, volume), list(gp),
                plan.get("hcoef"))
            pose["packed_gp"] = gp
        packed = pose["packed"]
        out = sweep_frame._frame_body(
            vol_t, occ_t, tf, packed, p_axis=p, Hi=plan["Hi"], Wi=plan["Wi"],
            R_warp=plan["R_warp"], ert=self.options.early_ray_termination,
            n_slabs=n_slabs,
            sgn_p=plan["sgn_p"], dist_leap=dist_leap, RECT_A=plan["RECT_A"],
            tile_h=plan.get("tile_h", 8), R_brick=plan.get("R_brick"),
            height=height, width=width,
            warp_variant=plan.get("warp_variant", "A"),
            rect_w=plan.get("rect_w", 256), grad_t=grad_t,
            test=self.options.test, texture_tf=self.options.texture_tf)
        self.last_renderer = "pallas"
        self.renderer_counts["pallas"] += 1
        if plan.get("warp_xla"):
            # The sweep ran on its kernel, the warp by gather: reported so
            # that an orbit's counts show how many frames took that tier.
            self.renderer_counts["pallas_xla_warp"] = (
                self.renderer_counts.get("pallas_xla_warp", 0) + 1)
        return out

    @staticmethod
    def _pvm(camera, volume: Volume) -> np.ndarray:
        """Host proj·view·model (float64 product, float32 result)."""
        return (camera.proj.astype(np.float64)
                @ camera.view.astype(np.float64)
                @ volume.model_matrix).astype(np.float32)

    def render_image(self, camera, width: int, height: int,
                     background=(0.0, 0.0, 0.0)) -> np.ndarray:
        """Render and composite over a background: uint8 (H, W, 3)."""
        rgba = self.render(camera, width, height).color.cpu().numpy()
        bg = np.asarray(background, np.float32)
        rgb = rgba[..., :3] + (1.0 - rgba[..., 3:4]) * bg
        return np.clip(np.round(rgb * 255.0), 0, 255).astype(np.uint8)
