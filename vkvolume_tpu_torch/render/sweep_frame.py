"""The frame of the production path: host plan → w-grid sweep → warp to
pixels — port of ``vkvolume_tpu/render/sweep_pallas.py``.

* The host planners (``select_view_plan``, ``plan_from_stats``,
  ``_plan_cost``, ``_mobius_grid_params``) are the JAX package's, numpy
  only, so the port plans the same w-grid, tiles and warp rects cell for
  cell. Left out: the frozen-envelope ``force`` tiers, the ``no_brick``
  re-plan (both serve the TPU compile cache and its retry chain) and the
  environment A/B knobs (their defaults are kept).
* ``pack_frame_scalars`` / ``unpack_frame_scalars`` carry every per-pose
  float through one float32 array, as in the JAX package: the frame sees
  exactly the float32 values the JAX frame sees.
* ``_frame_body`` routes the sweep as the JAX frame does: the brick sweep
  (K1, ``sweep_bricks.py``) when the plan sized a brick rect, every voxel
  plane gets a slab and the grid tiles by ``tile_h``; otherwise the
  per-slab sweep (K7, ``sweep_slabs.py``) over the w-grid's rays.
* ``_pixel_stage`` warps the grid channels to pixels by the plan's warp:
  the two-pass warp (K2 twice, ``warp_cuda.py``) when the plan has
  ``RECT_A``, else the single-pass warp (K8) when it has ``R_warp``, else
  (a ``warp_xla`` plan) the gather warp in plain PyTorch, as the JAX
  package leaves it to XLA on every device.
* The glue around the kernels (the w-grid, its fields, the pixel rays and
  the warp's positions, the channel stack) is plain PyTorch (``w_grid``,
  ``sweep_bricks.grid_fields``, ``make_rays``, ``pixel_grid_coords``,
  ``warp_positions``), except on a CUDA frame of the brick sweep with a
  two-pass or single-pass warp and its own pixel rays: there it is three
  launches of ``frame_cuda``'s kernels (``glue_geometry``).

The closed-form intensity or gradient TF and the
``Test.NUM_TEXTURE_SAMPLES`` diagnostic (the benchmark mode's frame) run
through every route; the texture TF only through the brick sweep, as in
the JAX package (the engine sends a texture frame K1 cannot take to the
XLA sweep, ``render/sweep.py``).

For callers with their own pixel rays, as in the JAX package:
``render_frame`` (the w-grid frame, planned by ``plan_frame``, which
falls back to device statistics of the rays, ``plan_stats``, when the
host analysis has no view or picks another axis) and ``sweep_pallas``
(the per-slab sweep K7 over the pixel rays themselves). Both raise
``PallasUnsupported`` for views the kernels cannot take. Left out: the
TPU kernels' rect heights and window widths, which the CUDA kernels do not
have (``supports`` keeps the JAX feasibility test, so callers fall back on
the same views), and the frozen-tier plan selection.
"""

from __future__ import annotations

import dataclasses
import math
import warnings

import numpy as np
import torch

from ..options import Test
from ..utils import timing
from . import frame_cuda
from . import plan as plan_mod
from . import sweep_bricks, sweep_slabs, warp_cuda
from .ray_setup import (_SLICE_AXES, FrameUniforms, RaySetup, RenderOutput,
                        make_rays, rays_from_dirs)

TILE_H = 8
TILE_W = 128
RECT_W = 256           # the per-slab TPU kernel's lane window
_WARP_RECT_W = 640     # the single-pass warp's rect (warp_pallas.RECT_W)


class PallasUnsupported(ValueError):
    """The view or volume lies outside what the w-grid kernels take; the
    caller falls back to the XLA sweep."""


def supports(rays: RaySetup, uniforms: FrameUniforms, vol_t_shape,
             height: int, width: int, p_axis: int, R: int = 16) -> bool:
    """Host feasibility test of the JAX per-slab kernel: every 8×128 pixel
    tile's source footprint fits a (R-1)×254 texel window for every slab
    in [0, 1]."""
    Np, Sv, Su = vol_t_shape
    if height % TILE_H or width % TILE_W:
        return False
    if Np < 2 or Sv < 2 or Su < 2:
        return False

    v_ax, u_ax = _SLICE_AXES[p_axis]
    d = rays.ray_dir.cpu().numpy()
    valid = rays.valid.cpu().numpy()
    if not valid.any():
        return True
    d_p = d[..., p_axis]
    ok = np.abs(d_p) > 1e-6
    safe = np.where(ok, d_p, 1.0)
    wu = np.where(valid & ok, d[..., u_ax] / safe, np.nan)
    wv = np.where(valid & ok, d[..., v_ax] / safe, np.nan)
    o_p = float(np.asarray(uniforms.cam_pos_tex)[p_axis])
    t_max = max(abs(0.0 - o_p), abs(1.0 - o_p))

    def tile_span(w, th, tw):
        a = w.reshape(height // th, th, width // tw, tw)
        a = np.transpose(a, (0, 2, 1, 3)).reshape(-1, th * tw)
        with np.errstate(invalid="ignore"), warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            span = np.nanmax(a, axis=1) - np.nanmin(a, axis=1)
        return np.nanmax(np.where(np.isnan(span), 0.0, span))

    # The 128-aligned rect base can waste up to 127 leading texels, the
    # 8-aligned base up to 7 rows; the tent filter needs one extra row.
    span_u = tile_span(wu, TILE_H, TILE_W) * t_max * Su
    span_v = tile_span(wv, TILE_H, TILE_W) * t_max * Sv
    return bool(span_u <= RECT_W - 132 and span_v <= R - 10)


def sweep_pallas(vol_t: torch.Tensor, occupancy_t: torch.Tensor | None, tf,
                 rays: RaySetup, uniforms: FrameUniforms, proj_view_model,
                 grad_t: torch.Tensor | None = None, *, p_axis: int,
                 ert: bool = True, test: Test = Test.NONE,
                 count_samples: bool = False, oversample: float = 1.0,
                 dist_leap: bool = False) -> RenderOutput:
    """The per-slab sweep (K7) over the caller's pixel rays. ``vol_t`` /
    ``occupancy_t`` are transposed for ``p_axis``; ``occupancy_t`` None
    samples every slab, a Chebyshev distance map with ``dist_leap``.
    Raises PallasUnsupported where the JAX entry does: a view whose tile
    footprints fit no rect height of the TPU kernel (the CUDA kernel has
    no such window; the test keeps the fallbacks the same), or a volume
    thinner than two planes. Entry / exit ``Test`` frames are the
    caller's."""
    H, W = rays.valid.shape
    # The JAX entry tries rect heights 16, 24, 32 and 48; the test passes
    # for one of them exactly when it passes for the tallest.
    if not supports(rays, uniforms, vol_t.shape, H, W, p_axis, R=48):
        raise PallasUnsupported(
            f"vol_t shape {tuple(vol_t.shape)} image {H}x{W} violates "
            "kernel limits")
    n_slabs = int(max(2, round(vol_t.shape[0] * oversample)))
    if occupancy_t is None:
        occupancy_t = torch.zeros((1, 1, 1), dtype=torch.uint8,
                                  device=vol_t.device)
        dist_leap = False
    if rays.entry is None or rays.exit is None:
        rays = dataclasses.replace(rays_from_dirs(uniforms, rays.ray_dir),
                                   valid=rays.valid,
                                   depth_init=rays.depth_init)
    return sweep_slabs.sweep_slabs(
        vol_t, occupancy_t, tf, rays, uniforms, proj_view_model, grad_t,
        p_axis=p_axis, ert=ert, test=test, count_samples=count_samples,
        n_slabs=n_slabs, separable=False, dist_leap=dist_leap)


def principal_axis_from_uniforms(uniforms: FrameUniforms) -> int:
    """Dominant view-direction axis of the central ray (host numpy)."""
    vpi = np.asarray(uniforms.view_proj_inv, np.float64)
    g2t = np.asarray(uniforms.global_to_tex, np.float64)
    o = np.asarray(uniforms.cam_pos_tex, np.float64)
    world = vpi @ np.array([0.0, 0.0, 0.0, 1.0])
    world = world[:3] / world[3]
    pt = (g2t @ np.append(world, 1.0))[:3]
    return int(np.argmax(np.abs(pt - o)))


def _count_valid(x: torch.Tensor) -> torch.Tensor:
    return (~torch.isnan(x)).sum()


def _nanmin(x: torch.Tensor) -> torch.Tensor:
    m = torch.where(torch.isnan(x), float("inf"), x).amin()
    return torch.where(_count_valid(x) > 0, m, float("nan"))


def _nanmax(x: torch.Tensor) -> torch.Tensor:
    m = torch.where(torch.isnan(x), float("-inf"), x).amax()
    return torch.where(_count_valid(x) > 0, m, float("nan"))


def _nanmedian(x: torch.Tensor) -> torch.Tensor:
    """numpy's and JAX's nanmedian: the mean of the two middle values of an
    even count (``torch.nanmedian`` takes the lower one), with no host
    sync. Sorting puts NaN last."""
    x = x.reshape(-1)
    s = torch.sort(x).values
    n = _count_valid(x)
    lo = ((n - 1) // 2).clamp(min=0)
    hi = (n // 2).clamp(min=0)
    return (s[lo] + s[hi]) * 0.5


def plan_stats(rays: RaySetup, p_axis: int) -> torch.Tensor:
    """The view statistics of the device-stats plan, from the pixel rays on
    their device: a (10,) float32 tensor (``stats_to_dict``'s keys), the
    reductions of the JAX ``_plan_stats_jit``. The medians use a stride-8
    subsample, as there."""
    nan = float("nan")
    v_ax, u_ax = _SLICE_AXES[p_axis]
    d = rays.ray_dir
    d_p = d[..., p_axis]
    ok = d_p.abs() > 1e-6
    sel = rays.valid & ok
    safe = torch.where(ok, d_p, 1.0)
    wu = torch.where(sel, d[..., u_ax] / safe, nan)
    wv = torch.where(sel, d[..., v_ax] / safe, nan)
    H, W = d_p.shape

    def tile_span_max(a):
        t = a.reshape(H // TILE_H, TILE_H, W // TILE_W, TILE_W)
        t = t.permute(0, 2, 1, 3).reshape(-1, TILE_H * TILE_W)
        n = (~torch.isnan(t)).sum(1)
        hi = torch.where(torch.isnan(t), float("-inf"), t).amax(1)
        lo = torch.where(torch.isnan(t), float("inf"), t).amin(1)
        sp = torch.where(n > 0, hi - lo, 0.0)
        return _nanmax(sp)

    du = torch.fmax((wu[:, 1:] - wu[:, :-1]).abs()[:-1, :],
                    (wu[1:, :] - wu[:-1, :]).abs()[:, :-1])
    dv = torch.fmax((wv[:, 1:] - wv[:, :-1]).abs()[:-1, :],
                    (wv[1:, :] - wv[:-1, :]).abs()[:, :-1])
    du_s, dv_s = du[::8, ::8], dv[::8, ::8]
    dp_s, sel_s = d_p[::8, ::8], sel[::8, ::8]
    return torch.stack([
        sel.any().to(torch.float32),
        _nanmin(wu), _nanmax(wu), _nanmin(wv), _nanmax(wv),
        _nanmedian(torch.where(du_s > 0, du_s, nan)),
        _nanmedian(torch.where(dv_s > 0, dv_s, nan)),
        tile_span_max(wu), tile_span_max(wv),
        _nanmedian(torch.where(sel_s, dp_s, nan)),
    ])


_STAT_KEYS = ("any_sel", "wu_lo", "wu_hi", "wv_lo", "wv_hi", "du_q", "dv_q",
              "span_wu", "span_wv", "sgn")


def stats_to_dict(stats_vec) -> dict:
    """``plan_stats``' vector as the planner's dict: one device-to-host
    copy."""
    vals = stats_vec.cpu().numpy().astype(np.float64)
    return dict(zip(_STAT_KEYS, vals.tolist()))


def select_view_plan(uniforms: FrameUniforms, height: int, width: int,
                     shape_for, max_oversample: float = 2.5, axes=None):
    """Cost-based principal-axis selection: plan every single-signed
    candidate axis (``analyze_view``'s ``unmixed_axes``) and keep the
    cheapest (near the axis handover the largest-|mean| axis can cost
    5-30× the runner-up). ``shape_for(p)`` returns the p-transposed volume
    shape; ``axes`` (optional) restricts the candidates, for a caller
    whose volume is already transposed for one axis. Returns (view,
    plan): (None, None) when no ray hits; (view, None) with view["mixed"]
    when no axis is single-signed."""
    view0 = plan_mod.analyze_view(uniforms, height, width)
    if view0 is None or view0.get("mixed"):
        return view0, None

    cost = _plan_cost

    def plan_axis(view, ax):
        # Uniform grid first; the projective (Möbius) grid rescues poses
        # whose uniform grid explodes, and the cheaper of the two is kept.
        pl_u = plan_from_stats(view, uniforms, ax, shape_for(ax), height,
                               width, max_oversample, mobius=False)
        if pl_u is not None and cost(pl_u) < 24e6 and not pl_u.get("warp_xla"):
            return pl_u
        pl_m = plan_from_stats(view, uniforms, ax, shape_for(ax), height,
                               width, max_oversample, mobius=True)
        if pl_u is None:
            return pl_m
        if pl_m is None:
            return pl_u
        return pl_m if cost(pl_m) < cost(pl_u) else pl_u

    def proxy(view, ax):
        # Grid-cell estimate from the view stats alone: orders candidates
        # without planning them.
        est = plan_from_stats(view, uniforms, ax, shape_for(ax), height,
                              width, max_oversample, size_only=True)
        return float("inf") if est is None else est

    cands = []
    for ax, sgn_ax in view0.get("unmixed_axes") or [(view0["p_axis"],
                                                     view0["sgn"])]:
        if axes is not None and ax not in axes:
            continue
        view = (view0 if ax == view0["p_axis"]
                else plan_mod.analyze_view(uniforms, height, width,
                                           restrict=(ax, sgn_ax)))
        if view is None or view.get("mixed"):
            continue
        cands.append((proxy(view, ax), ax, view))
    cands.sort(key=lambda t: t[0])

    best = None
    for _, ax, view in cands:
        pl = plan_axis(view, ax)
        if pl is None:
            continue
        if best is None or cost(pl) < cost(best[1]):
            best = (view, pl)
        # A bricked two-pass-warp plan in this cost class is near the
        # frame-cost floor: skip the runner-up axes.
        if cost(best[1]) < 24e6 and not best[1].get("warp_xla"):
            break
    if best is None:
        return view0, None
    return best


def plan_frame(uniforms: FrameUniforms, rays: RaySetup, p_axis: int,
               vol_shape_t, height: int, width: int,
               max_oversample: float = 2.5, max_rect: int = 512):
    """The frame plan of the caller's axis (``plan_from_stats``): from the
    host analysis when it picks ``p_axis``, else from the device statistics
    of ``rays`` (``plan_stats``). None for views whose rays disagree on the
    principal axis's sign (the device statistics cannot see that) and for
    views no plan fits."""
    view = plan_mod.analyze_view(uniforms, height, width)
    if view is not None and view["mixed"]:
        return None
    if view is not None and view["p_axis"] == p_axis:
        return plan_from_stats(view, uniforms, p_axis, vol_shape_t, height,
                               width, max_oversample, max_rect=max_rect)
    st = stats_to_dict(plan_stats(rays, p_axis))
    return plan_from_stats(st, uniforms, p_axis, vol_shape_t, height, width,
                           max_oversample, max_rect=max_rect)


def _mobius_grid_params(rng: float, f_lo: float, f_hi: float, N: float):
    """Per-axis Möbius grid parameters: N cells over w-range ``rng`` with
    end footprints (f_lo, f_hi) scaled uniformly to fit exactly —
    s = rng/(N·√(f_lo·f_hi)), w(ξ) = w_lo + s·f_lo·ξ/(1 − c·ξ).
    Returns (dw, c, dw_max): the ξ=0 footprint, the Möbius coefficient and
    the max footprint over the grid. c·N < 1, so 1 − c·ξ stays positive
    over the whole grid."""
    gm = math.sqrt(f_lo * f_hi)
    s = rng / (N * gm)
    return s * f_lo, s * (gm - f_lo) / rng, s * max(f_lo, f_hi)


def plan_from_stats(st, uniforms: FrameUniforms, p_axis: int, vol_shape_t,
                    height: int, width: int, max_oversample: float = 2.5,
                    mobius: bool = True, size_only: bool = False,
                    max_rect: int = 512):
    """Grid sizing + static kernel parameters from the view statistics
    (``vkvolume_tpu/render/sweep_pallas.py:plan_from_stats`` without the
    frozen-envelope ``force`` tiers). Searches over a grid-coarsening
    factor; returns None when no factor satisfies the kernel limits.
    ``max_rect`` caps the brick rect's width: 256 re-plans a view whose
    plan took a wider rect for the per-slab sweep, which has none."""
    Np, Sv, Su = vol_shape_t
    if not st["any_sel"]:
        return None
    wu_lo, wu_hi = st["wu_lo"], st["wu_hi"]
    wv_lo, wv_hi = st["wv_lo"], st["wv_hi"]
    mu = max(1e-6, (wu_hi - wu_lo) * 0.02)
    mv = max(1e-6, (wv_hi - wv_lo) * 0.02)
    wu_lo -= mu; wu_hi += mu; wv_lo -= mv; wv_hi += mv

    o_p = float(np.asarray(uniforms.cam_pos_tex)[p_axis])
    t_max = max(abs(0.0 - o_p), abs(1.0 - o_p))

    # Quality sizing (median pixel footprint) and the sweep kernels' LOWER
    # bounds on grid resolution (per-tile source footprint limits). The u
    # bound reserves the brick kernel's per-brick footprint drift.
    Np_s = vol_shape_t[0]
    wmax_u = max(abs(wu_lo), abs(wu_hi))
    wmax_v = max(abs(wv_lo), abs(wv_hi))
    drift_bu = wmax_u * (8.0 / max(Np_s, 1)) * Su
    drift_bv = wmax_v * (8.0 / max(Np_s, 1)) * Sv

    def u_caps(rect_w_c):
        """(brick_wanted, cap_fp_u) under brick-rect width ``rect_w_c``."""
        bw = drift_bu <= (60.0 if rect_w_c == 256 else 240.0)
        denom = (min(rect_w_c - 136.0, rect_w_c - 132.0 - drift_bu)
                 if bw else 120.0)
        return bw, denom / (Su * t_max * TILE_W)

    brick_wanted, cap_fp_u = u_caps(256)
    # End-band footprints drive the projective grid fit; missing → uniform.
    q_u = max(st["du_q"], 1e-9)
    q_v = max(st["dv_q"], 1e-9)
    f_lo_u = (st.get("du_lo_q") or q_u) if mobius else q_u
    f_hi_u = (st.get("du_hi_q") or q_u) if mobius else q_u
    f_lo_v = (st.get("dv_lo_q") or q_v) if mobius else q_v
    f_hi_v = (st.get("dv_hi_q") or q_v) if mobius else q_v
    rng_u = wu_hi - wu_lo
    rng_v = wv_hi - wv_lo
    # Kernel footprint caps bind on the grid's MAX per-cell footprint
    # (extremal at the range ends of a Möbius grid).
    cap_fp_v = 38.0 / (8.0 * Sv * t_max)
    Wi_q = rng_u / math.sqrt(f_lo_u * f_hi_u)
    Hi_q = rng_v / math.sqrt(f_lo_v * f_hi_v)
    if not all(np.isfinite(v) and v > 0
               for v in (Wi_q, Hi_q, cap_fp_u, cap_fp_v)):
        return None
    if size_only:
        return (max(Wi_q, rng_u / cap_fp_u)
                * max(Hi_q, rng_v / cap_fp_v))

    def _capped_ends(rng, f_lo, f_hi, fs, cap):
        """End footprints scaled by coarsening ``fs`` and clamped at the
        kernel cap; None when the grid cannot exist (rng non-finite)."""
        fl = min(f_lo * fs, cap)
        fh = min(f_hi * fs, cap)
        n = rng / math.sqrt(fl * fh)
        return (fl, fh, n) if np.isfinite(n) else None

    sgn_p = 1.0 if st["sgn"] >= 0 else -1.0

    # Grid-size allowance: proportional for big images, with an absolute
    # floor; the final tier (f = inf) is uncapped at the kernel minimum.
    cap_w = max(width * max_oversample, 2304.0)
    cap_h = max(height * max_oversample, 1536.0)

    def _attempt(rect_w_c, brick_wanted, cap_fp_u):
      for f in (1.0, 1.3, 1.7, 2.2, float("inf")):
        fs = 1e12 if f == float("inf") else f
        eu = _capped_ends(rng_u, f_lo_u, f_hi_u, fs, cap_fp_u)
        ev = _capped_ends(rng_v, f_lo_v, f_hi_v, fs, cap_fp_v)
        if eu is None or ev is None:
            return None
        fl_u_t, fh_u_t, Wi = eu
        # v-cap preference: try tile-32/16-friendly caps first and keep the
        # tallest whose grid stays within 25 % of the free-cap height.
        fl_v_t, fh_v_t, Hi = ev
        if brick_wanted:
            span_cap = min(47.0, 53.0 - drift_bv)
            for th_pref, grow in ((32, 1.25), (16, 1.25), (8, 1.6)):
                cap_th = span_cap / (th_pref * Sv * t_max)
                if cap_th <= 0:
                    continue
                ev_t = _capped_ends(rng_v, f_lo_v, f_hi_v, fs,
                                    min(cap_fp_v, cap_th))
                if ev_t is not None and ev_t[2] <= grow * ev[2] + 1e-6:
                    fl_v_t, fh_v_t, Hi = ev_t
                    break
        Wi = max(Wi, 128.0)
        Hi = max(Hi, 8.0)
        if f != float("inf") and (Wi > cap_w or Hi > cap_h):
            continue
        # Coarse quantisation of the grid dims.
        Wi = -(-int(Wi) // 256) * 256
        Hi = -(-int(Hi) // 64) * 64
        dwu, cu_g, dwu_max = _mobius_grid_params(rng_u, fl_u_t, fh_u_t, Wi)
        dwv, cv_g, dwv_max = _mobius_grid_params(rng_v, fl_v_t, fh_v_t, Hi)

        # Per-slab sweep rect height (the grid's max footprint).
        span_v = 8.0 * dwv_max * Sv * t_max
        R_sweep = None
        for cand in (16, 24, 32, 48):
            if span_v <= cand - 10:
                R_sweep = cand
                break
        if R_sweep is None:
            continue

        plan = dict(Hi=Hi, Wi=Wi, R_sweep=R_sweep, R_warp=None,
                    wu0=wu_lo, dwu=dwu, wv0=wv_lo, dwv=dwv,
                    cu=cu_g, cv=cv_g, sgn_p=sgn_p,
                    tile_h=8, R_brick=None, span_blks=2, rect_w=rect_w_c,
                    RECT_A=None, RECT_B=None, hcoef=None)

        # Single-pass warp rect height from per-tile pixel→grid spans.
        gus = plan_mod.grid_unit_spans(st, plan)
        if gus is not None:
            span_gx, span_gy, _ = gus
        else:
            span_gx = st["span_wu"] / dwu
            span_gy = st["span_wv"] / dwv
        R_warp = None
        if span_gx <= _WARP_RECT_W - 132 and Wi >= _WARP_RECT_W:
            for cand in (16, 24, 32, 48, 64, 96, 128, 192):
                if span_gy <= cand - 10:
                    R_warp = cand
                    break
        plan["R_warp"] = R_warp

        # Brick-kernel feasibility: the rect must also cover the footprint
        # drift across one 8-slab brick. Prefer the tallest tile.
        tile_h, R_brick, span_blks = 8, None, 2
        if brick_wanted \
                and 128.0 * dwu_max * Su * t_max + drift_bu \
                <= rect_w_c - 132:
            r_cands = tuple(
                c for c in (16, 24, 32, 48, 64, 96)
                if c <= 64 or rect_w_c <= 384)
            for th in (32, 16, 8):
                span = th * dwv_max * Sv * t_max
                sb = -(-int(span + 10.0) // 8)   # per-slab tent window blocks
                need = max(8 * sb, int(span + drift_bv + 11.0))
                fit = [c for c in r_cands if need <= c]
                if fit and Hi % th == 0:
                    tile_h, R_brick, span_blks = th, fit[0], sb
                    break
        plan["tile_h"], plan["R_brick"], plan["span_blks"] = \
            tile_h, R_brick, span_blks

        # Two-pass projective warp (render/plan.py), preferred over the
        # single-pass warp when feasible.
        if uniforms is not None and "span_wv_t" in st:
            tp = plan_mod.two_pass_warp_plan(uniforms, p_axis, height,
                                             width, plan, st)
            if tp is not None:
                plan.update(tp)
        if plan["RECT_A"] is not None or R_warp is not None:
            return plan
        if f >= 2.0:
            # Last tier: keep the sweep, warp by gather.
            plan["warp_xla"] = True
            return plan
      return None

    plan = _attempt(256, brick_wanted, cap_fp_u)
    # Cap-relief rescue (rect_w = 384/512) for grids the 256-lane rect cap
    # inflated well past the pixel-matched quality size.
    if Su >= 384 and f_hi_u * 1.05 > cap_fp_u:
        for rect_c in (384, 512):
            if Su < rect_c or rect_c > max_rect:
                continue
            bw_c, cap_c = u_caps(rect_c)
            if not bw_c:
                continue
            p_c = _attempt(rect_c, bw_c, cap_c)
            if p_c is not None and p_c.get("R_brick") is not None and (
                    plan is None or _plan_cost(p_c) < _plan_cost(plan)):
                plan = p_c
    return plan


def _plan_cost(pl):
    """Relative frame cost of a plan (the JAX package's TPU-calibrated
    model, kept so that the port picks the same plan): grid cells × a
    kernel factor."""
    if pl.get("R_brick"):
        c = pl["Hi"] * pl["Wi"] * (1.0 + 6.0 / pl["tile_h"])
    else:
        c = 4.0 * pl["Hi"] * pl["Wi"]
    c *= 1.0 + 0.35 * (pl.get("rect_w", 256) / 256.0 - 1.0)
    if pl.get("warp_xla"):
        c += 16e6
    return c


# Every per-pose float the frame consumes (uniform leaves + proj_view_model
# + grid params + homography coefficients) in one flat float32 array.
_UNIFORM_FIELDS = (
    ("view", 16), ("proj", 16), ("view_proj_inv", 16), ("model", 16),
    ("model_inv", 16), ("global_to_tex", 16), ("plane", 4),
    ("plane_tex", 4), ("cam_pos_tex", 3), ("block_size", 3),
    ("front_index", 1),
)
_N_UNIFORM = sum(n for _, n in _UNIFORM_FIELDS)            # 111
N_PACKED = _N_UNIFORM + 16 + 6 + 9                          # + pvm, gp, hcoef


def pack_frame_scalars(uniforms: FrameUniforms, pvm, gp,
                       hcoef=None) -> np.ndarray:
    """Flatten (uniforms, proj_view_model, grid_params, hcoef) into one
    (N_PACKED,) float32 array (hcoef None → zeros)."""
    parts = [np.asarray(getattr(uniforms, name), np.float32).ravel()
             for name, _ in _UNIFORM_FIELDS]
    parts.append(np.asarray(pvm, np.float32).ravel())
    parts.append(np.asarray(gp, np.float32).ravel())
    parts.append(np.zeros(9, np.float32) if hcoef is None
                 else np.asarray(hcoef, np.float32).ravel())
    out = np.concatenate(parts)
    assert out.shape == (N_PACKED,), out.shape
    return out


def unpack_frame_scalars(arr: np.ndarray):
    """Inverse of pack_frame_scalars: (uniforms, pvm, gp, hcoef), host
    float32 numpy."""
    vals = {}
    off = 0
    for name, n in _UNIFORM_FIELDS:
        v = arr[off:off + n]
        off += n
        vals[name] = v.reshape(4, 4) if n == 16 else v
    vals["front_index"] = np.int32(vals["front_index"][0])
    u = FrameUniforms(**vals)
    pvm = arr[off:off + 16].reshape(4, 4)
    off += 16
    gp = arr[off:off + 6]
    off += 6
    hcoef = arr[off:off + 9]
    return u, pvm, gp, hcoef


def _mob_fwd(w0, dw, c, x):
    """Möbius grid forward map w(ξ) (denominator positive over the grid)."""
    return w0 + dw * x / (1.0 - c * x)


def _guard(den: torch.Tensor) -> torch.Tensor:
    """Sign-preserving clamp of a denominator away from 0 (±1e-20)."""
    return torch.where(den.abs() < 1e-20,
                       torch.where(den < 0, -1e-20, 1e-20), den)


def _mob_inv(w0, dw, c, w):
    """Möbius grid inverse map ξ(w); out-of-range w of invalid pixels are
    masked later."""
    return (w - w0) / _guard(dw + c * (w - w0))


def w_grid(gp, Hi: int, Wi: int, device,
           row0: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """(wu, wv) of the w-grid cell centres of grid rows [row0, row0 + Hi),
    (Hi, Wi) each (``row0``: a shard's first row)."""
    wu0, dwu, cu_g, wv0, dwv, cv_g = (float(v) for v in gp)
    f = torch.float32
    gyi = torch.arange(row0, row0 + Hi, dtype=torch.int32,
                       device=device).to(f)[:, None]
    gxi = torch.arange(Wi, dtype=torch.int32, device=device).to(f)[None, :]
    wu_g = _mob_fwd(wu0, dwu, cu_g, gxi + 0.5).expand(Hi, Wi).contiguous()
    wv_g = _mob_fwd(wv0, dwv, cv_g, gyi + 0.5).expand(Hi, Wi).contiguous()
    return wu_g, wv_g


def grid_rays(uniforms: FrameUniforms, wu_g: torch.Tensor,
              wv_g: torch.Tensor, p_axis: int, sgn_p: float) -> RaySetup:
    """The per-slab sweep's rays: one per w-grid cell, from the camera along
    ``(w_u, w_v, 1)·sgn_p`` in (u, v, p) texture axes, normalised."""
    v_ax, u_ax = _SLICE_AXES[p_axis]
    dir_xyz = [None, None, None]
    dir_xyz[p_axis] = torch.full(wu_g.shape, float(sgn_p), device=wu_g.device)
    dir_xyz[u_ax] = wu_g * float(sgn_p)
    dir_xyz[v_ax] = wv_g * float(sgn_p)
    dirs = torch.stack(dir_xyz, -1)
    dirs = dirs / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)
    return rays_from_dirs(uniforms, dirs)


def pixel_grid_coords(rays: RaySetup, gp, p_axis: int):
    """(gx, gy): each pixel's position in the w-grid image, -10 where the
    pixel's ray misses."""
    wu0, dwu, cu_g, wv0, dwv, cv_g = (float(v) for v in gp)
    v_ax, u_ax = _SLICE_AXES[p_axis]
    d = rays.ray_dir
    d_p = d[..., p_axis]
    okp = d_p.abs() > 1e-6
    safe = torch.where(okp, d_p, 1.0)
    gx = _mob_inv(wu0, dwu, cu_g, d[..., u_ax] / safe) - 0.5
    gy = _mob_inv(wv0, dwv, cv_g, d[..., v_ax] / safe) - 0.5
    pix_ok = rays.valid & okp
    return torch.where(pix_ok, gx, -10.0), torch.where(pix_ok, gy, -10.0)


def warp_positions(gx: torch.Tensor, gy: torch.Tensor, gp, hcoef, *,
                   Hi: int, Wi: int, warp_variant: str,
                   H_total: int | None = None, row0: int = 0):
    """The two passes' positions: variant "A" (row-first) → (xa (Hi, W),
    gy_t (W, Hp)); variant "B" (column-first) → (yb (Wi, Hp), gx_p (Hp, W)).
    First-pass positions whose solved pixel coordinate lies outside the
    image (+ margin) are masked to -10 — the plan's feasibility window.
    ``gx``/``gy`` may be a shard's image rows: ``H_total`` is the whole
    image's height (the window) and ``row0`` the shard's first row, the
    image row at which variant B solves its first local row."""
    wu0, dwu, cu_g, wv0, dwv, cv_g = (float(v) for v in gp)
    au, bu, cu_, av, bv, cv_, ap, bp_, cp_ = (float(v) for v in hcoef)
    H, W = gx.shape
    H_img = H if H_total is None else H_total
    Hp = -(-H // 128) * 128
    f = torch.float32
    dev = gx.device
    if warp_variant == "B":
        xgi = torch.arange(Wi, dtype=torch.int32, device=dev).to(f)[:, None]
        iir = torch.arange(row0, row0 + Hp, dtype=torch.int32,
                           device=dev).to(f)[None, :]
        wu_c = _mob_fwd(wu0, dwu, cu_g, xgi + 0.5)
        den = _guard(bu - wu_c * bp_)
        jhat = (wu_c * cp_ - cu_ - (au - wu_c * ap) * iir) / den
        dd = _guard(ap * iir + bp_ * jhat + cp_)
        wv_b = (av * iir + bv * jhat + cv_) / dd
        yb = _mob_inv(wv0, dwv, cv_g, wv_b) - 0.5
        ok_b = (torch.isfinite(yb) & (jhat >= -16.0)
                & (jhat <= float(W) + 15.0) & (iir < float(H_img)))
        yb = torch.where(ok_b, yb, -10.0).contiguous()
        gx_p = torch.nn.functional.pad(gx, (0, 0, 0, Hp - H), value=-10.0)
        return yb, gx_p.contiguous()
    ygi = torch.arange(Hi, dtype=torch.int32, device=dev).to(f)[:, None]
    jj = torch.arange(W, dtype=torch.int32, device=dev).to(f)[None, :]
    wv_t = _mob_fwd(wv0, dwv, cv_g, ygi + 0.5)
    den = _guard(av - wv_t * ap)
    ihat = (wv_t * (bp_ * jj + cp_) - (bv * jj + cv_)) / den
    dd = _guard(ap * ihat + bp_ * jj + cp_)
    wu_a = (au * ihat + bu * jj + cu_) / dd
    xa = _mob_inv(wu0, dwu, cu_g, wu_a) - 0.5
    ok_a = (torch.isfinite(xa) & (ihat >= -16.0)
            & (ihat <= float(H_img) + 15.0))
    xa = torch.where(ok_a, xa, -10.0).contiguous()
    gy_t = torch.nn.functional.pad(gy.T, (0, Hp - H), value=-10.0)
    return xa, gy_t.contiguous()


def _pixel_stage(chans: torch.Tensor, rays: RaySetup | None, gp, hcoef, tf,
                 *, p_axis: int, Hi: int, RECT_A, R_warp, warp_variant: str,
                 iterations: int, test: Test = Test.NONE,
                 dim_max: int, H_total: int | None = None,
                 row0: int = 0,
                 positions: frame_cuda.Positions | None = None
                 ) -> RenderOutput:
    """Warp of the (C, Hi, Wi) grid channels (lum, alpha, depth, and the
    sample count under ``Test.NUM_TEXTURE_SAMPLES``) to pixels by the
    plan's warp — two-pass (``RECT_A``), single-pass K8 (``R_warp``) or the
    gather warp (neither: a ``warp_xla`` plan) — then the pixel-space
    outputs. ``rays`` may be a shard's image rows, from ``row0`` of an
    ``H_total``-row image (``warp_positions``). ``positions``: the warp's
    positions made by ``frame_cuda.frame_positions`` from the pose (then
    ``rays`` is None, and the initial depth 0)."""
    with timing.span("vkv.frame.warp"):
        if positions is None:
            gx, gy = pixel_grid_coords(rays, gp, p_axis)
            if RECT_A is not None:
                pos1, pos2 = warp_positions(gx, gy, gp, hcoef, Hi=Hi,
                                            Wi=chans.shape[2],
                                            warp_variant=warp_variant,
                                            H_total=H_total, row0=row0)
        else:
            gx, gy, pos1, pos2 = positions
        H, W = gx.shape
        if RECT_A is not None:
            # u16-encoded warp: lum/alpha/depth live in [0, 1] (depth is
            # reverse-Z clip depth; no-hit pixels are overwritten below); the
            # sample count is an integer far below 65535 (at most n_slabs),
            # warped at scale 1.
            scales = ([65535.0] * 3 + [1.0])[:chans.shape[0]]
            warp = (warp_cuda.warp_two_pass_b if warp_variant == "B"
                    else warp_cuda.warp_two_pass)
            warped = warp(chans, pos1, pos2, scales=scales)[:, :H, :]
        elif R_warp is not None:
            warped = warp_cuda.warp_to_pixels(chans, gx.contiguous(),
                                              gy.contiguous())
        else:
            warped = warp_cuda.warp_to_pixels_plain(chans, gx, gy)
    with timing.span("vkv.frame.pixels"):
        lum, alpha, depth = warped[0], warped[1], warped[2]
        covered = gx > -5.0
        depth = torch.where(covered & (alpha > 0.0), depth,
                            0.0 if rays is None else rays.depth_init)
        color = torch.stack([lum, lum, lum, alpha], -1)
        zi = torch.zeros((H, W), dtype=torch.int32, device=chans.device)
        nsamp = zi
        if test == Test.NUM_TEXTURE_SAMPLES:
            nsamp = warped[3].to(torch.int32)
            val = warped[3] / sweep_slabs.n_steps_max(dim_max,
                                                      tf.sampling_factor)
            color = torch.stack([val, val, val, torch.ones_like(val)], -1)
            color = torch.where(covered[..., None], color, 0.0)
        return RenderOutput(color=color, depth=depth, num_volume_samples=nsamp,
                            num_distance_samples=zi, num_empty_samples=zi,
                            iterations=iterations)


def glue_geometry(packed: np.ndarray, *, p_axis: int, sgn_p: float, Hi: int,
                  Wi: int, height: int, width: int, RECT_A,
                  warp_variant: str, vol_shape, n_slabs: int
                  ) -> frame_cuda.FrameGeometry:
    """What ``frame_cuda``'s kernels compute a frame's glue from: the
    pose's ``packed`` scalars and the plan's integers, as
    ``_frame_body`` passes them."""
    return frame_cuda.FrameGeometry(
        packed, p_axis=p_axis, sgn=1 if sgn_p > 0 else -1, Hi=Hi, Wi=Wi,
        height=height, width=width,
        warp=warp_variant if RECT_A is not None else "K8",
        dim_max=max(vol_shape), n_slabs=n_slabs)


def _frame_body(vol_t: torch.Tensor, occupancy_t: torch.Tensor, tf,
                packed: np.ndarray, *, p_axis: int, Hi: int, Wi: int,
                R_warp, ert: bool, n_slabs: int, sgn_p: float,
                dist_leap: bool, RECT_A, tile_h: int, R_brick, height: int,
                width: int, warp_variant: str = "A", rect_w: int = 256,
                grad_t: torch.Tensor | None = None,
                test: Test = Test.NONE,
                texture_tf: bool = False, return_chans: bool = False,
                rays: RaySetup | None = None, shard=None):
    """One frame: pixel rays → w-grid fields → sweep (K1, or K7) → channel
    stack → warp (K2 twice, K8, or the gather warp) → pixel outputs.
    ``packed`` is pack_frame_scalars' array; ``grad_t`` the gradient map
    transposed like ``vol_t`` (gradient TFs); ``texture_tf`` the TF
    through the baked texture (K1 only). ``return_chans``: stop before the
    pixel stage and return its inputs (channel stack, pixel rays, sweep
    iterations), as the JAX frame's ``return_chans`` does for
    ``stage_breakdown``. ``rays``: the pixel rays of the warp (the
    caller's, ``render_frame``), by default this pose's (``make_rays``).

    ``shard`` (``parallel.Mesh``; ``render_frame_sharded``): this rank
    sweeps its ``Hi / size`` contiguous grid rows, one all-gather rebuilds
    the grid, and the warp runs on the rank's pixel rows, which ``rays``
    then holds (of a ``height``-row image).

    A CUDA frame of the brick sweep with a two-pass or single-pass warp
    makes its own pixel rays: there the glue around K1 and K2 is
    ``frame_cuda``'s three kernels, from ``packed`` by value, with no copy
    to the card and no wait. The other routes (the per-slab sweep, the
    gather warp, a shard, the caller's rays, ``return_chans``, the sample
    count test) and the CPU run the plain glue, the kernels' twins."""
    uniforms, pvm, gp, hcoef = unpack_frame_scalars(packed)
    dev = vol_t.device
    n, r = (1, 0) if shard is None else (shard.size, shard.rank)
    Hi_loc = Hi // n
    brick = (R_brick is not None and n_slabs >= vol_t.shape[0]
             and Hi_loc % tile_h == 0)
    if (dev.type == "cuda" and brick
            and (RECT_A is not None or R_warp is not None)
            and shard is None and rays is None and not return_chans
            and test == Test.NONE):
        geom = glue_geometry(packed, p_axis=p_axis, sgn_p=sgn_p, Hi=Hi,
                             Wi=Wi, height=height, width=width,
                             RECT_A=RECT_A, warp_variant=warp_variant,
                             vol_shape=vol_t.shape, n_slabs=n_slabs)
        with timing.span("vkv.frame.rays"):
            positions = frame_cuda.frame_positions(geom, dev)
        with timing.span("vkv.frame.grid_fields"):
            grid = frame_cuda.frame_grid(geom, dev)
        with timing.span("vkv.frame.brick_inputs"):
            inp = sweep_bricks.brick_inputs(
                vol_t, occupancy_t, tf, uniforms, grid, p_axis=p_axis,
                ert=ert, count_samples=False, n_slabs=n_slabs, sgn=geom.sgn,
                tile_h=tile_h, dist_leap=dist_leap, grad_t=grad_t,
                texture_tf=texture_tf)
        lum, alpha, firsts, _ = sweep_bricks.sweep_bricks_kernel(inp)
        with timing.span("vkv.frame.epilogue"):
            chans = frame_cuda.frame_epilogue(geom, lum, alpha, firsts)
        return _pixel_stage(chans, None, gp, hcoef, tf, p_axis=p_axis, Hi=Hi,
                            RECT_A=RECT_A, R_warp=R_warp,
                            warp_variant=warp_variant, iterations=n_slabs,
                            dim_max=max(vol_t.shape), positions=positions)
    with timing.span("vkv.frame.rays"):
        if rays is None:
            rays = make_rays(uniforms, height, width, dev)
        wu_g, wv_g = w_grid(gp, Hi_loc, Wi, dev, row0=r * Hi_loc)
    sgn = 1 if sgn_p > 0 else -1
    num_test = test == Test.NUM_TEXTURE_SAMPLES
    # The brick sweep whenever the plan proved its rect feasible and every
    # voxel plane gets a slab (the plan's drift margins assume it);
    # otherwise the per-slab sweep.
    if brick:
        with timing.span("vkv.frame.grid_fields"):
            s_lo, s_hi, cov, kappa = sweep_bricks.grid_fields(
                uniforms, wu_g, wv_g, sgn, p_axis, max(vol_t.shape), n_slabs)
        grid_out = sweep_bricks.sweep_bricks(
            vol_t, occupancy_t, tf, uniforms, pvm,
            (wu_g, wv_g, s_lo, s_hi, kappa, cov), p_axis=p_axis, ert=ert,
            count_samples=num_test, n_slabs=n_slabs, sgn=sgn, tile_h=tile_h,
            dist_leap=dist_leap, grad_t=grad_t, texture_tf=texture_tf,
            test=test)
    else:
        if rect_w > 256:
            # The grid was sized for a wide brick rect; the per-slab
            # sweep's footprint limits assume 256 lanes.
            raise PallasUnsupported("a wide-rect plan needs the brick sweep")
        if texture_tf:
            # Only the brick sweep has the texture-TF variant; the engine
            # sends texture frames here only when its plan takes K1.
            raise PallasUnsupported("the texture TF needs the brick sweep")
        with timing.span("vkv.frame.grid_fields"):
            g_rays = grid_rays(uniforms, wu_g, wv_g, p_axis, sgn_p)
        grid_out = sweep_slabs.sweep_slabs(
            vol_t, occupancy_t, tf, g_rays, uniforms, pvm,
            grad_t, p_axis=p_axis, ert=ert, test=test,
            count_samples=num_test, n_slabs=n_slabs, separable=True,
            dist_leap=dist_leap)
    with timing.span("vkv.frame.epilogue"):
        chans = [grid_out.color[..., 0], grid_out.color[..., 3],
                 grid_out.depth]
        if num_test:
            chans.append(grid_out.num_volume_samples.to(torch.float32))
        chans = torch.stack(chans)
    if shard is not None:
        # The frame's one collective: the full grid from every rank's rows.
        chans = shard.all_gather(chans, dim=1)
    if return_chans:
        return chans, rays, grid_out.iterations
    return _pixel_stage(chans, rays, gp, hcoef, tf,
                        p_axis=p_axis, Hi=Hi, RECT_A=RECT_A, R_warp=R_warp,
                        warp_variant=warp_variant,
                        iterations=grid_out.iterations, test=test,
                        dim_max=max(vol_t.shape), H_total=height,
                        row0=r * rays.valid.shape[0])


def render_frame(vol_t: torch.Tensor, occupancy_t: torch.Tensor | None, tf,
                 rays: RaySetup, uniforms: FrameUniforms, proj_view_model,
                 grad_t: torch.Tensor | None = None, *, p_axis: int,
                 ert: bool = True, test: Test = Test.NONE,
                 oversample: float = 1.0, dist_leap: bool = False,
                 texture_tf: bool = False) -> RenderOutput:
    """The w-grid frame for the caller's pixel rays (an H×W ``RaySetup``
    with at least ``ray_dir``, ``valid`` and ``depth_init``): the plan
    (``plan_frame``), then the sweep and the warp as ``_frame_body`` runs
    them for the engine. ``vol_t`` / ``occupancy_t`` / ``grad_t`` are
    transposed for ``p_axis``; ``occupancy_t`` None samples every slab, a
    Chebyshev distance map with ``dist_leap``. Raises PallasUnsupported
    for images that do not tile by 8×128 and views no plan fits."""
    H, W = rays.valid.shape
    if H % TILE_H or W % TILE_W:
        raise PallasUnsupported(f"image {H}x{W} not tile-aligned")
    plan = plan_frame(uniforms, rays, p_axis, tuple(vol_t.shape), H, W)
    if plan is None:
        raise PallasUnsupported("view exceeds w-grid kernel limits")
    return render_planned(vol_t, occupancy_t, tf, rays, uniforms,
                          proj_view_model, grad_t, plan, p_axis=p_axis,
                          ert=ert, test=test, oversample=oversample,
                          dist_leap=dist_leap, texture_tf=texture_tf)


def render_planned(vol_t: torch.Tensor, occupancy_t: torch.Tensor | None, tf,
                   rays: RaySetup, uniforms: FrameUniforms, proj_view_model,
                   grad_t: torch.Tensor | None, plan: dict, *, p_axis: int,
                   ert: bool = True, test: Test = Test.NONE,
                   oversample: float = 1.0, dist_leap: bool = False,
                   texture_tf: bool = False, height: int | None = None,
                   shard=None) -> RenderOutput:
    """``render_frame`` after its plan: the frame of ``plan`` (``plan_frame``'s
    dict, or one with another warp variant from
    ``plan.two_pass_warp_plan``) for the pixel rays ``rays`` — a shard's
    rows of a ``height``-row image with ``shard`` (``_frame_body``)."""
    if height is None:
        height = rays.valid.shape[0]
    if occupancy_t is None:
        occupancy_t = torch.zeros((1, 1, 1), dtype=torch.uint8,
                                  device=vol_t.device)
        dist_leap = False
    gp = [plan["wu0"], plan["dwu"], plan.get("cu", 0.0),
          plan["wv0"], plan["dwv"], plan.get("cv", 0.0)]
    packed = pack_frame_scalars(uniforms, proj_view_model, gp,
                                plan.get("hcoef"))
    return _frame_body(
        vol_t, occupancy_t, tf, packed, p_axis=p_axis, Hi=plan["Hi"],
        Wi=plan["Wi"], R_warp=plan["R_warp"], ert=ert,
        n_slabs=int(max(2, round(vol_t.shape[0] * oversample))),
        sgn_p=plan["sgn_p"], dist_leap=dist_leap, RECT_A=plan["RECT_A"],
        tile_h=plan.get("tile_h", 8), R_brick=plan.get("R_brick"),
        height=height, width=rays.valid.shape[1],
        warp_variant=plan.get("warp_variant", "A"),
        rect_w=plan.get("rect_w", 256), grad_t=grad_t, test=test,
        texture_tf=texture_tf, rays=rays, shard=shard)
