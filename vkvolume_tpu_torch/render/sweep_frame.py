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

The closed-form intensity or gradient TF and the
``Test.NUM_TEXTURE_SAMPLES`` diagnostic (the benchmark mode's frame) run
through every route; the texture TF only through the brick sweep, as in
the JAX package (the engine sends a texture frame K1 cannot take to the
XLA sweep, ``render/sweep.py``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..options import Test
from . import plan as plan_mod
from . import sweep_bricks, sweep_slabs, warp_cuda
from .frustum import rays_from_dirs
from .ray_setup import (_SLICE_AXES, FrameUniforms, RaySetup, RenderOutput,
                        make_rays)

TILE_W = 128
_WARP_RECT_W = 640     # the single-pass warp's rect (warp_pallas.RECT_W)


def select_view_plan(uniforms: FrameUniforms, height: int, width: int,
                     shape_for, max_oversample: float = 2.5):
    """Cost-based principal-axis selection: plan every single-signed
    candidate axis (``analyze_view``'s ``unmixed_axes``) and keep the
    cheapest (near the axis handover the largest-|mean| axis can cost
    5-30× the runner-up). ``shape_for(p)`` returns the p-transposed volume
    shape. Returns (view, plan): (None, None) when no ray hits; (view, None)
    with view["mixed"] when no axis is single-signed."""
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


def w_grid(gp, Hi: int, Wi: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(wu, wv) of every w-grid cell centre, (Hi, Wi) each."""
    wu0, dwu, cu_g, wv0, dwv, cv_g = (float(v) for v in gp)
    f = torch.float32
    gyi = torch.arange(Hi, dtype=torch.int32, device=device).to(f)[:, None]
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
                   Hi: int, Wi: int, warp_variant: str):
    """The two passes' positions: variant "A" (row-first) → (xa (Hi, W),
    gy_t (W, Hp)); variant "B" (column-first) → (yb (Wi, Hp), gx_p (Hp, W)).
    First-pass positions whose solved pixel coordinate lies outside the
    image (+ margin) are masked to -10 — the plan's feasibility window."""
    wu0, dwu, cu_g, wv0, dwv, cv_g = (float(v) for v in gp)
    au, bu, cu_, av, bv, cv_, ap, bp_, cp_ = (float(v) for v in hcoef)
    H, W = gx.shape
    Hp = -(-H // 128) * 128
    f = torch.float32
    dev = gx.device
    if warp_variant == "B":
        xgi = torch.arange(Wi, dtype=torch.int32, device=dev).to(f)[:, None]
        iir = torch.arange(Hp, dtype=torch.int32, device=dev).to(f)[None, :]
        wu_c = _mob_fwd(wu0, dwu, cu_g, xgi + 0.5)
        den = _guard(bu - wu_c * bp_)
        jhat = (wu_c * cp_ - cu_ - (au - wu_c * ap) * iir) / den
        dd = _guard(ap * iir + bp_ * jhat + cp_)
        wv_b = (av * iir + bv * jhat + cv_) / dd
        yb = _mob_inv(wv0, dwv, cv_g, wv_b) - 0.5
        ok_b = (torch.isfinite(yb) & (jhat >= -16.0)
                & (jhat <= float(W) + 15.0) & (iir < float(H)))
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
            & (ihat <= float(H) + 15.0))
    xa = torch.where(ok_a, xa, -10.0).contiguous()
    gy_t = torch.nn.functional.pad(gy.T, (0, Hp - H), value=-10.0)
    return xa, gy_t.contiguous()


def _pixel_stage(chans: torch.Tensor, rays: RaySetup, gp, hcoef, tf, *,
                 p_axis: int, Hi: int, RECT_A, R_warp, warp_variant: str,
                 iterations: int, test: Test = Test.NONE,
                 dim_max: int) -> RenderOutput:
    """Warp of the (C, Hi, Wi) grid channels (lum, alpha, depth, and the
    sample count under ``Test.NUM_TEXTURE_SAMPLES``) to pixels by the
    plan's warp — two-pass (``RECT_A``), single-pass K8 (``R_warp``) or the
    gather warp (neither: a ``warp_xla`` plan) — then the pixel-space
    outputs."""
    H, W = rays.valid.shape
    gx, gy = pixel_grid_coords(rays, gp, p_axis)
    if RECT_A is not None:
        pos1, pos2 = warp_positions(gx, gy, gp, hcoef, Hi=Hi,
                                    Wi=chans.shape[2],
                                    warp_variant=warp_variant)
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
    lum, alpha, depth = warped[0], warped[1], warped[2]
    covered = gx > -5.0
    depth = torch.where(covered & (alpha > 0.0), depth, rays.depth_init)
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


def _frame_body(vol_t: torch.Tensor, occupancy_t: torch.Tensor, tf,
                packed: np.ndarray, *, p_axis: int, Hi: int, Wi: int,
                R_warp, ert: bool, n_slabs: int, sgn_p: float,
                dist_leap: bool, RECT_A, tile_h: int, R_brick, height: int,
                width: int, warp_variant: str = "A", rect_w: int = 256,
                grad_t: torch.Tensor | None = None,
                test: Test = Test.NONE,
                texture_tf: bool = False) -> RenderOutput:
    """One frame: pixel rays → w-grid fields → sweep (K1, or K7) → channel
    stack → warp (K2 twice, K8, or the gather warp) → pixel outputs.
    ``packed`` is pack_frame_scalars' array; ``grad_t`` the gradient map
    transposed like ``vol_t`` (gradient TFs); ``texture_tf`` the TF
    through the baked texture (K1 only)."""
    uniforms, pvm, gp, hcoef = unpack_frame_scalars(packed)
    dev = vol_t.device
    rays = make_rays(uniforms, height, width, dev)
    wu_g, wv_g = w_grid(gp, Hi, Wi, dev)
    sgn = 1 if sgn_p > 0 else -1
    num_test = test == Test.NUM_TEXTURE_SAMPLES
    # The brick sweep whenever the plan proved its rect feasible and every
    # voxel plane gets a slab (the plan's drift margins assume it);
    # otherwise the per-slab sweep.
    if R_brick is not None and n_slabs >= vol_t.shape[0] \
            and Hi % tile_h == 0:
        s_lo, s_hi, cov, kappa = sweep_bricks.grid_fields(
            uniforms, wu_g, wv_g, sgn, p_axis, max(vol_t.shape), n_slabs)
        grid_out = sweep_bricks.sweep_bricks(
            vol_t, occupancy_t, tf, uniforms, pvm,
            (wu_g, wv_g, s_lo, s_hi, kappa, cov), p_axis=p_axis, ert=ert,
            count_samples=num_test, n_slabs=n_slabs, sgn=sgn, tile_h=tile_h,
            dist_leap=dist_leap, grad_t=grad_t, texture_tf=texture_tf)
    else:
        if rect_w > 256:
            # The grid was sized for a wide brick rect; the per-slab
            # sweep's footprint limits assume 256 lanes.
            raise ValueError("a wide-rect plan needs the brick sweep")
        if texture_tf:
            # Only the brick sweep has the texture-TF variant; the engine
            # sends texture frames here only when its plan takes K1.
            raise ValueError("the texture TF needs the brick sweep")
        grid_out = sweep_slabs.sweep_slabs(
            vol_t, occupancy_t, tf,
            grid_rays(uniforms, wu_g, wv_g, p_axis, sgn_p), uniforms, pvm,
            grad_t, p_axis=p_axis, ert=ert, test=test,
            count_samples=num_test, n_slabs=n_slabs, separable=True,
            dist_leap=dist_leap)
    chans = [grid_out.color[..., 0], grid_out.color[..., 3], grid_out.depth]
    if num_test:
        chans.append(grid_out.num_volume_samples.to(torch.float32))
    return _pixel_stage(torch.stack(chans), rays, gp, hcoef, tf,
                        p_axis=p_axis, Hi=Hi, RECT_A=RECT_A, R_warp=R_warp,
                        warp_variant=warp_variant,
                        iterations=grid_out.iterations, test=test,
                        dim_max=max(vol_t.shape))
