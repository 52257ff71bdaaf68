"""Engine — the application orchestrator, port of
``vkvolume_tpu/engine/engine.py`` restricted to the main path.

Owns the volumes and their acceleration maps, rebakes the TF texture and
rebuilds the occupancy and distance maps on every transfer-function edit
(src/volume_render.cpp:392-445) and renders frames. As in the JAX engine,
the default renderer is ``"marcher"``: every frame goes to the per-ray
marcher (``render/marcher.py``), the reference-exact oracle. With
``renderer="pallas"`` (what the CLI, the bench harness and the viewer
pass) frames go through the w-grid frame (``render/sweep_frame.py``): the
brick sweep (K1) or the per-slab sweep (K7), then the two-pass warp (K2),
the single-pass warp (K8) or the gather warp, as the view's plan says.
The frames the w-grid frame cannot take go to the XLA sweep
(``render/sweep.py``), as in the JAX engine: views with no plan (or whose
narrow re-plan fails), texture-TF views whose plan has no brick rect or
fewer slabs than voxel planes, every frame of ``renderer="sweep"``, frames
clipped by a depth attachment, and the ray entry / exit ``Test`` frames.
Views whose rays straddle the principal axis (a wide-FOV camera inside
the volume) go to the marcher, which also re-marches the suspect pixels
of edge repair. All work runs on
the engine's ``device``, by default the CUDA card (no card: it raises);
the kernels run on "cuda", their plain PyTorch versions on "cpu". A
kernel that fails raises: nothing falls back on an exception.

A TF whose range is not monotone (``imin > imax``) builds its occupancy
map by the float path, and volumes without a precomputed gradient map
(``use_precomputed_gradient`` off, the CLI's ``--gradient_test``) compute
the gradients inside every map build; their gradient-TF frames take the
XLA sweep, with gradient 1.0, as in the JAX engine. With
``accel_cache_dir`` the maps are saved per volume, TF, block size and
skipping type, and restored instead of rebuilt (``accel_cache.py``).

The TPU workarounds (compile retries and their re-plan chain, the XLA
sweep rung after a failed compile, watchdog banding of the marcher, the
XLA sweep and the repair march, prewarm, frozen plan tiers, A/B
environment knobs) are left out by design.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..accel.distance_cuda import (anisotropic_distance_cuda,
                                   isotropic_distance_cuda)
from ..accel.gradient import gradient_map
from ..accel.occupancy import (_occupancy, _tf_thresholds,
                               occupied_voxel_count)
from ..options import RenderOptions, SkippingType, Test
from ..render import sweep as sweep_mod
from ..render import sweep_frame
from ..render.marcher import march
from ..render.ray_setup import (RaySetup, RenderOutput, axis_shape,
                                make_rays, make_uniforms, transpose_for_axis)
from ..tf.transfer_function import bake_texture, tf_params
from ..utils.timing import span
from . import accel_cache
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


def _build_maps_fused(density, gradient, tf, thr, *, map_shape_zyx,
                      st: SkippingType) -> torch.Tensor:
    """Occupancy + distance transform of one TF edit: (N, mz, my, mx) u8,
    N = 8 for the anisotropic maps, 1 for the isotropic map (DISTANCE) and
    the occupancy map (BLOCK/NONE). ``thr``: the integer path's (ti, tg),
    or None for the float path; ``gradient=None`` with a gradient TF: the
    gradients are computed here from the density."""
    with span("vkv.tf_update.occupancy"):
        occ = _occupancy(density, gradient, tf, map_shape_zyx, thr)
    if st == SkippingType.ANISOTROPIC_DISTANCE:
        with span("vkv.tf_update.distance"):
            return anisotropic_distance_cuda(occ)
    if st == SkippingType.DISTANCE:
        with span("vkv.tf_update.distance"):
            return isotropic_distance_cuda(occ)
    return occ[None]


def suspect_mask(color: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """Edge repair's suspects in a frame ((H, W, 4) colour, (H, W) depth):
    the pixels whose 3×3 range of alpha exceeds 0.04, of depth 0.01 or of
    any colour channel 0.08 (silhouettes, depth steps, and colour edges at
    flat alpha, which the warp's bilinear mixing shifts too), dilated
    once. (H, W) bool."""
    def max3(x):        # (C, H, W) -> 3×3 max, padded with -inf
        return F.max_pool2d(x, 3, stride=1, padding=1)

    def rng3(x):
        return max3(x) + max3(-x)

    c = color.permute(2, 0, 1)
    mask = ((rng3(c[3:4])[0] > 0.04) | (rng3(depth[None])[0] > 0.01)
            | (rng3(c[:3]).amax(0) > 0.08))
    return max3(mask[None].to(torch.float32))[0] > 0.5


@dataclasses.dataclass
class UpdateStats:
    """The reference log lines' metrics (src/volume_render.cpp:418, 430).
    ``map_update_ms`` is the synced per-build time in benchmark mode, the
    build to a synchronise on the load path (``add_volume``), and the host
    time to queue the build for an interactive edit."""

    occupied_voxel_percent: float | None = None
    count_ms: float | None = None
    map_update_ms: float | None = None
    gradient_ms: float | None = None


class Engine:
    def __init__(self, options: RenderOptions | None = None,
                 benchmark_mode: bool = False, renderer: str = "marcher",
                 device: str | torch.device = "cuda",
                 accel_cache_dir: str | None = None):
        """``renderer``: "marcher" (the default, as in the JAX engine:
        every frame through the per-ray marcher, the reference-exact
        oracle), "pallas" (the w-grid frame through the kernels, the XLA
        sweep for the frames it cannot take; the CLI, the bench harness
        and the viewer pass it) or "sweep" (every frame through the XLA
        sweep).
        ``device``: where volumes, maps and frames live; "cuda" (the
        default) raises when there is no CUDA device.
        ``accel_cache_dir``: a directory where ``add_volume`` saves each
        volume's maps and from which it restores them."""
        if renderer not in ("pallas", "sweep", "marcher"):
            raise ValueError(f"unknown renderer {renderer!r}")
        self.options = options or RenderOptions()
        self.benchmark_mode = benchmark_mode
        self.renderer = renderer
        self.device = resolve_device(device)
        self.accel_cache_dir = accel_cache_dir
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
        (src/volume_render.cpp:186-242). With ``accel_cache_dir`` the maps
        are restored from the cache when it holds them (the stats then stay
        empty), else built and saved."""
        if volume.device != self.device:
            raise ValueError(f"volume on {volume.device}, engine on "
                             f"{self.device}")
        self.volumes.append(volume)
        stats = UpdateStats()
        if self.accel_cache_dir is not None:
            if accel_cache.load(self.accel_cache_dir, volume,
                                self.options.skipping_type):
                self._bake(volume)
                return stats
        if volume.options.use_precomputed_gradient:
            t0 = time.perf_counter()
            volume.gradient = gradient_map(
                volume.density, 1.0, use_gradient=volume.options.use_gradient)
            self._sync()
            stats.gradient_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        tf_stats = self.update_transfer_function(volume)
        stats.occupied_voxel_percent = tf_stats.occupied_voxel_percent
        stats.count_ms = tf_stats.count_ms
        stats.map_update_ms = tf_stats.map_update_ms
        if not self.benchmark_mode:
            # An interactive edit returns with its build queued: the load
            # times its build to a synchronise, as the gradient map above.
            self._sync()
            stats.map_update_ms = (time.perf_counter() - t0) * 1e3
        if self.accel_cache_dir is not None:
            accel_cache.save(self.accel_cache_dir, volume,
                             self.options.skipping_type)
        return stats

    @staticmethod
    def _bake(volume: Volume) -> None:
        """Rebake the volume's TF texture from its slider values."""
        o = volume.options
        volume.tf_texture = bake_texture(
            intensity_min=o.intensity_min, intensity_max=o.intensity_max,
            gradient_min=o.gradient_min, gradient_max=o.gradient_max)

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
        with span("vkv.tf_update"):
            o = volume.options
            tf = self._tf(volume)
            stats = UpdateStats()
            with span("vkv.tf_update.bake"):
                self._bake(volume)
            gradient = volume.gradient if o.use_precomputed_gradient else None
            tf_host = (o.intensity_min, o.intensity_max,
                       o.gradient_min, o.gradient_max)
            if self.benchmark_mode:
                t0 = time.perf_counter()
                with span("vkv.tf_update.count"):
                    n_occ = occupied_voxel_count(volume.density, gradient,
                                                 tf, tf_host=tf_host)
                stats.count_ms = (time.perf_counter() - t0) * 1e3
                stats.occupied_voxel_percent = (
                    100.0 * n_occ / int(np.prod(volume.density.shape)))
            thr = _tf_thresholds(tf, tf_host)

            def build_maps():
                return _build_maps_fused(
                    volume.density, gradient, tf, thr,
                    map_shape_zyx=volume.map_shape_zyx,
                    st=self.options.skipping_type)

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

    def set_skipping_type(self, st: SkippingType) -> None:
        """An ESS mode change rebuilds the maps of every volume
        (src/volume_render.cpp:512-518)."""
        if st != self.options.skipping_type:
            self.options.skipping_type = st
            for v in self.volumes:
                self.update_transfer_function(v, timed_runs=1)

    # ---- per-frame ------------------------------------------------------

    def render_with_scene(self, camera, width: int, height: int, mesh,
                          light_dir=(-0.4, -0.8, -0.45)) -> RenderOutput:
        """The scene pass, then the volume pass, composited as the
        reference's pipeline with ``render_sponza_scene`` on
        (src/volume_render.cpp:329-356): the mesh renders first
        (``render/forward.py``), its reverse-Z depth clips the volume's
        rays (DEPTH_ATTACHMENT, volume_render.frag:122-165), and the
        volume's premultiplied output composites over the scene's colour
        (src/volume_render_subpass.cpp:177-186)."""
        from ..render.forward import rasterize

        scene_rgb, scene_depth = rasterize(mesh, camera, height, width,
                                           light_dir=light_dir,
                                           device=self.device)
        prev = self.options.depth_attachment
        self.options.depth_attachment = True
        try:
            out = self.render(camera, width, height, depth_image=scene_depth)
        finally:
            self.options.depth_attachment = prev
        vol_a = out.color[..., 3:4]
        rgb = out.color[..., :3] + (1.0 - vol_a) * scene_rgb
        covered = (scene_depth > 0.0)[..., None].to(torch.float32)
        alpha = vol_a + (1.0 - vol_a) * covered
        return dataclasses.replace(
            out, color=torch.cat([rgb, alpha], -1),
            depth=torch.maximum(out.depth, scene_depth))

    def render(self, camera, width: int, height: int,
               depth_image: torch.Tensor | None = None) -> RenderOutput:
        """One frame: per volume, blended front-to-back in draw order
        (src/volume_render_subpass.cpp:159-293). ``depth_image`` (H, W),
        reverse-Z, clips the rays when ``options.depth_attachment``."""
        with span("vkv.render"):
            out = None
            for volume in self.volumes:
                result = self.render_volume(volume, camera, width, height,
                                            depth_image=depth_image)
                if out is None:
                    out = result
                else:
                    # Blend state ONE, ONE_MINUS_SRC_ALPHA; reverse-Z depth.
                    c = (result.color
                         + (1.0 - result.color[..., 3:4]) * out.color)
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
                      height: int, depth_image: torch.Tensor | None = None
                      ) -> RenderOutput:
        if self.renderer in ("sweep", "pallas"):
            out = self._render_sweep(volume, camera, width, height,
                                     depth_image)
            if out is not None:
                if (self.options.edge_repair
                        and self.options.test == Test.NONE):
                    with span("vkv.render.edge_repair"):
                        out = self._edge_repair(out, volume, camera, width,
                                                height, depth_image)
                return out
            # Mixed principal-axis signs (a wide-FOV camera inside the
            # volume): no one slab order composites every ray front to
            # back, so the per-ray marcher renders the frame.
        self.last_renderer = "marcher"
        self.renderer_counts["marcher"] += 1
        with span("vkv.render.march"):
            uniforms = self._uniforms(camera, volume)
            rays = make_rays(uniforms, height, width, self.device,
                             depth_image=depth_image,
                             use_depth=self.options.depth_attachment,
                             full=True)
            return self._march(volume, rays, uniforms, camera,
                               self.options.skipping_type)

    def _uniforms(self, camera, volume: Volume):
        return make_uniforms(
            camera, volume.node_transform, volume.image_transform,
            self.options.clip_distance,
            np.asarray(volume.effective_block_size_xyz, np.float32))

    def _march(self, volume: Volume, rays: RaySetup, uniforms, camera,
               st: SkippingType) -> RenderOutput:
        """The per-ray marcher over ``rays`` with skipping type ``st``."""
        return march(
            volume.density, volume.gradient,
            volume.dist_maps if st != SkippingType.NONE else None,
            self._tf(volume), rays, uniforms.block_size,
            self._pvm(camera, volume), self._tf_texture(volume),
            skipping_type=st,
            early_ray_termination=self.options.early_ray_termination,
            precomputed_gradient=volume.options.use_precomputed_gradient,
            test=self.options.test)

    def _edge_repair(self, out: RenderOutput, volume: Volume, camera,
                     width: int, height: int,
                     depth_image: torch.Tensor | None) -> RenderOutput:
        """Re-march the resampling-suspect pixels with the per-ray marcher
        (the quality mode).

        The w-grid sweep and warp resample a grid image at pixel centres;
        at silhouettes and colour edges some pixels land on the wrong side
        of the edge. Of the suspects (``suspect_mask``) at most ``K``, the
        budget (``repair_budget`` of the frame, 1024-aligned, at least
        2048), in raster order, are marched and spliced in; the rest keep
        the sweep's pixels.
        ``last_repair_px`` is (suspects found, K). The JAX engine marches
        K lanes, its padding lanes on pixel 0 (its shapes are static); the
        port marches the live lanes only, which gives the same pixels. Its
        chunking of the repair march (``_REPAIR_CHUNK``) is a TPU watchdog
        workaround and is not ported."""
        n_px = height * width
        idx = suspect_mask(out.color, out.depth).reshape(-1).nonzero()[:, 0]
        n_found = idx.numel()
        if self.options.repair_budget <= 0:
            # Probe mode: count the suspects only.
            self.last_repair_px = (n_found, 0)
            return out
        K = int(min(n_px, -(-max(
            2048, int(n_px * self.options.repair_budget)) // 1024) * 1024))
        self.last_repair_px = (n_found, K)
        idx = idx[:K]
        if idx.numel() == 0:
            return out

        uniforms = self._uniforms(camera, volume)
        rays = make_rays(uniforms, height, width, self.device,
                         depth_image=depth_image,
                         use_depth=self.options.depth_attachment, full=True)
        sub = RaySetup(**{
            k.name: getattr(rays, k.name).reshape(
                (n_px,) + getattr(rays, k.name).shape[2:])[idx][None]
            for k in dataclasses.fields(RaySetup)})
        # The marcher skips with whatever map exists: skipmode NONE builds
        # the occupancy map too, and BLOCK skipping over it is exact (a
        # skipped cell is empty under the same TF thresholds).
        st = self.options.skipping_type
        if st == SkippingType.NONE and volume.dist_maps is not None:
            st = SkippingType.BLOCK
        rep = self._march(volume, sub, uniforms, camera, st)

        def splice(old, new):
            flat = old.reshape((n_px,) + old.shape[2:]).clone()
            flat[idx] = new[0]
            return flat.reshape(old.shape)

        return dataclasses.replace(out, color=splice(out.color, rep.color),
                                   depth=splice(out.depth, rep.depth))

    def _tf_texture(self, volume: Volume) -> torch.Tensor | None:
        """The baked TF texture on the device when the texture-TF variant
        is active (RenderOptions.texture_tf), else None (closed form)."""
        if not self.options.texture_tf:
            return None
        return volume.texture_on_device()

    def _render_sweep(self, volume: Volume, camera, width: int,
                      height: int, depth_image: torch.Tensor | None = None
                      ) -> RenderOutput | None:
        """The w-grid frame or the XLA sweep's, or None when the view needs
        the marcher (mixed principal-axis signs, no coverage). Frames
        clipped by a depth attachment take the XLA sweep: the w-grid frame
        would honour the scene's entry test through the pixel mask but not
        its exit clamp (volume_render.frag:152-164)."""
        if not self.options.depth_attachment:
            depth_image = None
        if self.renderer == "pallas" and (height % 8 or width % 128):
            # Render a tile-aligned padded viewport whose top-left window
            # has pixel-identical rays, then crop. The depth pads with 0,
            # the reverse-Z far plane, which clips nothing.
            from ..camera import pad_viewport

            hp = -(-height // 8) * 8
            wp = -(-width // 128) * 128
            if depth_image is not None:
                depth_image = F.pad(depth_image,
                                    (0, wp - width, 0, hp - height))
            out = self._render_sweep(
                volume, pad_viewport(camera, width, height, wp, hp), wp, hp,
                depth_image)
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
        # Depth-clipped frames are never pose-cached: their depth image
        # changes from frame to frame.
        pose = None if depth_image is not None else cache.get(
            ("pose", cam_key))
        dsh = tuple(volume.density.shape)
        if pose is None:
            with span("vkv.render.plan"):
                uniforms = self._uniforms(camera, volume)
                view, plan = sweep_frame.select_view_plan(
                    uniforms, height, width, lambda q: axis_shape(dsh, q))
            pose = dict(uniforms=uniforms, view=view, plan=plan)
            if depth_image is None:
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
            with span("vkv.render.sweep_xla"):
                return sweep_mod.entry_exit_frame(
                    make_rays(uniforms, height, width, self.device,
                              depth_image=depth_image, use_depth=True,
                              full=True),
                    self.options.test)
        if view is None or view["mixed"]:
            return None
        p = view["p_axis"]
        if p not in cache:
            with span("vkv.render.skip_map"):
                cache[p] = transpose_for_axis(volume.density, p)
        vol_t = cache[p]
        tf = self._tf(volume)
        grad_t = None
        if tf.use_gradient and volume.gradient is not None:
            # The gradient map, transposed and cached beside vol_t. Without
            # one (on-the-fly gradients) the frame takes the XLA sweep with
            # gradient 1.0, as the JAX engine's does.
            if ("grad", p) not in cache:
                with span("vkv.render.skip_map"):
                    cache[("grad", p)] = transpose_for_axis(volume.gradient,
                                                            p)
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
                with span("vkv.render.skip_map"):
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
        if (self.renderer != "pallas" or min(vol_t.shape[1:]) < 2
                or depth_image is not None
                or (tf.use_gradient and grad_t is None)):
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
                with span("vkv.render.plan"):
                    narrow = sweep_frame.plan_from_stats(
                        view, uniforms, p, vol_t.shape, height, width,
                        max_rect=256)
                pose["plan_narrow"] = narrow if narrow is not None else False
            plan = narrow or None
        if plan is None:
            self.last_renderer = "sweep"
            self.renderer_counts["sweep"] += 1
            with span("vkv.render.sweep_xla"):
                return sweep_mod.sweep(
                    vol_t, grad_t, occ_t, tf,
                    make_rays(uniforms, height, width, self.device,
                              depth_image=depth_image, use_depth=True,
                              full=True),
                    uniforms, self._pvm(camera, volume),
                    self._tf_texture(volume), p_axis=p,
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
                     background=(0.0, 0.0, 0.0),
                     scene_mesh=None) -> np.ndarray:
        """Render and composite over a background: uint8 (H, W, 3).
        ``scene_mesh`` renders through the scene pass
        (``render_with_scene``)."""
        if scene_mesh is not None:
            out = self.render_with_scene(camera, width, height, scene_mesh)
        else:
            out = self.render(camera, width, height)
        rgba = out.color.cpu().numpy()
        bg = np.asarray(background, np.float32)
        rgb = rgba[..., :3] + (1.0 - rgba[..., 3:4]) * bg
        return np.clip(np.round(rgb * 255.0), 0, 255).astype(np.uint8)
