"""Host-only view analysis for the production frame plan.

Everything the plan needs is a smooth projective function of the camera,
so this module computes it analytically on the host, with no device
reduction and no synced device→host transfer per camera pose:

* ``wu = d_u / d_p`` over the image is a ratio of bilinear functions of the
  pixel coordinates, so its extrema over the (convex) image rectangle lie on
  the boundary, and over the set of cube-hitting rays they lie at the cube's
  corners (a linear-fractional function on a convex polytope attains extrema
  at vertices while the denominator keeps one sign). The valid-ray range is
  therefore the intersection of the cube-corner range with a densely sampled
  image-boundary range — exact up to the conservative intersection.
* Medians/derivative bounds come from a coarse host grid (the plan only uses
  them to size the w-grid; the kernel footprint limits get explicit safety
  margins re-checked by ``plan_from_stats``).

Numpy only, microseconds per pose. A copy of ``vkvolume_tpu/render/plan.py``
with two changes: ``_SLICE_AXES`` comes from ``ray_setup``, and the
grid-sizing footprint quantile is the constant ``FOOTPRINT_Q`` (the JAX
package's default) instead of an environment variable.
"""

from __future__ import annotations

import numpy as np

from .ray_setup import _SLICE_AXES

# Grid-sizing footprint quantile: 0.5 = median pixel footprint. Lower
# quantiles build a denser w-grid (more sweep work, fewer warp interpolation
# errors at content silhouettes).
FOOTPRINT_Q = 0.5


def _pixel_dirs(u, height: int, width: int, py: np.ndarray, px: np.ndarray):
    """Unnormalized texture-space ray directions for pixel centers (py, px)
    — the numpy twin of make_rays' unprojection.
    Normalization cancels in every ratio the plan uses."""
    vpi = np.asarray(u.view_proj_inv, np.float64)
    g2t = np.asarray(u.global_to_tex, np.float64)
    o = np.asarray(u.cam_pos_tex, np.float64)
    ndc_x = (px + 0.5) / width * 2.0 - 1.0
    ndc_y = (py + 0.5) / height * 2.0 - 1.0
    clip = np.stack(
        [ndc_x, ndc_y, np.zeros_like(ndc_x), np.ones_like(ndc_x)], -1)
    world = clip @ vpi.T
    world = world[..., :3] / world[..., 3:4]
    pt_tex = (
        np.concatenate([world, np.ones_like(world[..., :1])], -1) @ g2t.T
    )[..., :3]
    return pt_tex - o, o


def _valid_mask(u, d: np.ndarray, o: np.ndarray) -> np.ndarray:
    """Cube-interval + clip-plane validity (scale-invariant port of
    make_rays' test)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        dir_inv = 1.0 / d
        t0 = (0.0 - o) * dir_inv
        t1 = (1.0 - o) * dir_inv
        t_near = np.max(np.minimum(t0, t1), axis=-1)
        t_far = np.min(np.maximum(t0, t1), axis=-1)
        plane = np.asarray(u.plane_tex, np.float64)
        s_o = float(plane[:3] @ o + plane[3])
        s_d = d @ plane[:3]
        t_plane = np.where(s_d != 0.0, -s_o / np.where(s_d == 0, 1, s_d),
                           np.inf)
        t_entry = np.where(s_d > 0.0, np.maximum(t_near, t_plane), t_near)
    return (t_entry < t_far) & (t_far > 0.0)


def analyze_view(u, height: int, width: int, grid: int = 24,
                 restrict: tuple[int, float] | None = None) -> dict | None:
    """All host-side view statistics for one camera pose:

    Returns a dict with the `_plan_stats_jit` keys (any_sel, wu_lo/hi,
    wv_lo/hi, du_q, dv_q, span_wu, span_wv, sgn) plus ``p_axis`` and
    ``mixed`` (principal-axis direction sign disagreement among valid rays
    → caller must fall back to the per-ray marcher). None when no ray hits
    the volume.

    ``restrict = (axis, sign)`` analyses only the rays with
    sign·d[axis] > 0 and forces that axis as the principal axis —
    sweep_pallas.select_view_plan uses it to evaluate runner-up candidate
    axes near the principal-axis handover (where the largest-|mean| axis
    plans a far costlier grid than a runner-up). None when no restricted
    ray hits the volume.
    """
    # ONE pixel lattice serves extrema, medians, mixed-sign detection AND
    # the per-tile span bounds (this function runs per pose on the orbit's
    # host-plan path; the previous separate coarse grid doubled the
    # unprojection/validity work).
    # Step-16 lattices at HD sizes: analyze_view runs per fresh pose on the
    # orbit's host-plan path; the coarser lattice quarters the numpy work
    # (measured 13-16 → ~4 ms/pose at 1920×1080) while every consumer pads
    # by the LOCAL slope × step, so the bounds stay conservative.
    step_y = 16 if height >= 1024 else (8 if height >= 512 else 2)
    step_x = 16 if width >= 1024 else (8 if width >= 512 else 2)
    ys = np.arange(0.0, height + step_y - 1.0, float(step_y)) - 0.5
    xs = np.arange(0.0, width + step_x - 1.0, float(step_x)) - 0.5
    py, px = np.meshgrid(ys, xs, indexing="ij")
    d, o = _pixel_dirs(u, height, width, py, px)
    valid = _valid_mask(u, d, o)
    if restrict is not None:
        valid = valid & (d[..., restrict[0]] * restrict[1] > 0.0)
    if not valid.any():
        return None

    # Principal axis from the mean valid direction (normalize first so the
    # mean is direction-weighted like sweep.principal_axis). If the
    # preferred axis is sign-mixed over the valid rays (wide-FOV frames
    # near 45°+fov/2 off-axis), try the remaining axes by |mean| — an
    # oblique but single-signed sweep axis beats the seconds-per-frame
    # marcher fallback; only an all-axes-mixed frame (camera inside the
    # volume) truly needs the marcher.
    dn = d / np.linalg.norm(d, axis=-1, keepdims=True)
    mean = dn[valid].mean(axis=0)
    dnorm = np.linalg.norm(d, axis=-1)
    p_axis = sel = None
    mixed = True
    sgn = 1.0
    unmixed: list[tuple[int, float]] = []
    cand_axes = (np.argsort(-np.abs(mean)) if restrict is None
                 else np.asarray([restrict[0]]))
    for cand in cand_axes:
        d_p = d[..., cand]
        ok = np.abs(d_p) > 1e-9 * dnorm
        sel_c = valid & ok
        if not sel_c.any():
            continue
        dpv = d_p[sel_c]
        mixed_c = bool((dpv > 0).any() and (dpv < 0).any())
        sgn_c = 1.0 if np.median(dpv) >= 0 else -1.0
        if not mixed_c:
            # Every single-signed axis is a VIABLE sweep axis; the engine
            # scores a plan per candidate and keeps the cheapest
            # (sweep_pallas.select_view_plan) — near the principal-axis
            # handover the largest-|mean| axis can cost 5-30× the runner-up
            # (exploding wu = d_u/d_p as d_p → 0 at the frustum edge).
            unmixed.append((int(cand), sgn_c))
        if p_axis is None:
            p_axis = int(cand)
            sel = sel_c
            mixed = mixed_c
            sgn = sgn_c
        elif mixed and not mixed_c:
            p_axis = int(cand)
            sel = sel_c
            mixed = False
            sgn = sgn_c
    if p_axis is None:
        return None
    v_ax, u_ax = _SLICE_AXES[p_axis]
    d_p = d[..., p_axis]
    ok = np.abs(d_p) > 1e-9 * dnorm

    with np.errstate(divide="ignore", invalid="ignore"):
        wu = np.where(sel, d[..., u_ax] / np.where(ok, d_p, 1.0), np.nan)
        wv = np.where(sel, d[..., v_ax] / np.where(ok, d_p, 1.0), np.nan)

    # Exact extrema of wu/wv over cube-hitting rays: cube corners (see
    # module docstring), intersected with the sampled in-frustum range.
    if mixed:
        # Valid rays genuinely straddle the principal-axis sign: no global
        # slab order composites front-to-back — the caller must use the
        # per-ray marcher.
        return dict(any_sel=1.0, mixed=True, p_axis=p_axis, sgn=sgn,
                    wu_lo=np.nan, wu_hi=np.nan, wv_lo=np.nan, wv_hi=np.nan,
                    du_q=np.nan, dv_q=np.nan, span_wu=np.nan, span_wv=np.nan)
    corners = np.array(
        [[i, j, k] for i in (0.0, 1.0) for j in (0.0, 1.0) for k in (0.0, 1.0)]
    )
    cd = corners - o
    cd_p = cd[:, p_axis]
    if np.abs(cd_p).min() >= 1e-9 and (cd_p > 0).all() == (sgn > 0) \
            and ((cd_p > 0).all() or (cd_p < 0).all()):
        # Linear-fractional extremum argument holds: cube-corner ranges
        # clamp the sampled in-frustum ranges.
        cwu = cd[:, u_ax] / cd_p
        cwv = cd[:, v_ax] / cd_p
    else:
        # A cube corner sits near (or across) the p-perpendicular plane
        # through the camera: the corner clamp is unusable, but the VALID
        # rays still share one sign, so the padded sampled ranges alone
        # bound them (the sweep remains usable — previously this bailed to
        # the seconds-per-frame marcher for ~2 % of orbit poses).
        cwu = cwv = None

    # In-frustum range from the grid samples, padded by one local grid step
    # of slope (valid pixels between samples).
    def rng(a, corner_vals):
        lo_s, hi_s = np.nanmin(a), np.nanmax(a)
        da_x = np.abs(np.diff(a, axis=1))
        da_y = np.abs(np.diff(a, axis=0))
        pad = max(np.nanmax(da_x) if np.isfinite(da_x).any() else 0.0,
                  np.nanmax(da_y) if np.isfinite(da_y).any() else 0.0)
        if corner_vals is None:
            return lo_s - pad, hi_s + pad
        lo = max(lo_s - pad, corner_vals.min())
        hi = min(hi_s + pad, corner_vals.max())
        return lo, hi

    wu_lo, wu_hi = rng(wu, cwu)
    wv_lo, wv_hi = rng(wv, cwv)

    # Per-pixel footprint medians over the valid samples (grid → pixel
    # units). Direction-agnostic: wu can vary along either image axis
    # (depends on the camera roll relative to the texture axes), so the
    # footprint is the larger of the two derivative magnitudes.
    step_x = xs[1] - xs[0]
    step_y = ys[1] - ys[0]
    with np.errstate(invalid="ignore"):
        du_x = np.abs(np.diff(wu, axis=1)) / step_x     # |∂wu/∂j|
        du_y = np.abs(np.diff(wu, axis=0)) / step_y     # |∂wu/∂i|
        dv_x = np.abs(np.diff(wv, axis=1)) / step_x
        dv_y = np.abs(np.diff(wv, axis=0)) / step_y
        du = np.fmax(du_x[:-1, :], du_y[:, :-1])
        dv = np.fmax(dv_x[:-1, :], dv_y[:, :-1])
    fin = lambda a: a[np.isfinite(a) & (a > 0)]
    du_f, dv_f = fin(du), fin(dv)
    if du_f.size == 0 or dv_f.size == 0:
        return None
    du_q = float(np.quantile(du_f, FOOTPRINT_Q))
    dv_q = float(np.quantile(dv_f, FOOTPRINT_Q))

    # End footprints for the projective-grid fit (sweep_pallas.
    # plan_from_stats): for a projective view the pixel footprint as a
    # function of w is (a + b·w)² — quadratic with a double root at the
    # homography horizon — i.e. √footprint is AFFINE in w. Fit that line
    # robustly (median of √dw per w-bin, least squares over bin centers;
    # binning in w de-weights the dense low-footprint end, where most
    # PIXELS but few w-values live, so the projective tail is captured)
    # and evaluate it at the two range ends. A fit that crosses zero
    # inside the range (horizon inside the visible range — numerically
    # noisy) falls back to the uniform grid (None, None).
    def end_fit(dw, w_at, lo, hi):
        rng_w = hi - lo
        if not np.isfinite(rng_w) or rng_w <= 0:
            return None, None
        wa = w_at[: dw.shape[0], : dw.shape[1]]
        sel = np.isfinite(dw) & (dw > 0) & np.isfinite(wa)
        if sel.sum() < 32:
            return None, None
        wv_s = wa[sel]
        rt = np.sqrt(dw[sel])
        nb = 8
        idx = np.clip(((wv_s - lo) / rng_w * nb).astype(np.int64), 0, nb - 1)
        cs, ms = [], []
        for b in range(nb):
            in_b = idx == b
            if in_b.sum() >= 4:
                cs.append(lo + (b + 0.5) * rng_w / nb)
                ms.append(float(np.quantile(rt[in_b], FOOTPRINT_Q)))
        if len(cs) < 2:
            return None, None
        A = np.stack([np.ones(len(cs)), np.asarray(cs)], axis=1)
        coef, *_ = np.linalg.lstsq(A, np.asarray(ms), rcond=None)
        r_lo = float(coef[0] + coef[1] * lo)
        r_hi = float(coef[0] + coef[1] * hi)
        if r_lo <= 0.0 or r_hi <= 0.0:
            return None, None
        return r_lo * r_lo, r_hi * r_hi

    du_lo_q, du_hi_q = end_fit(du, wu, wu_lo, wu_hi)
    dv_lo_q, dv_hi_q = end_fit(dv, wv, wv_lo, wv_hi)

    # Per-tile span bounds on the same lattice: the slope of wu/wv varies
    # strongly across a wide-FOV image, so a global-max-slope bound would
    # be ~10× pessimistic; instead evaluate on every tile's actual corners
    # and take max-min per aligned tile (+15% curvature margin). Spans use
    # strictly valid samples: dilating into the invalid region reaches the
    # wu blow-up zone past the silhouette/clip boundary and inflates the
    # bound ~2-3× (measured), which forces the catastrophic non-Pallas
    # fallback. Valid pixels between lattice samples are covered by the
    # margin (an 8 px cell of a projective map is near-linear).
    th = max(1, int(round(8 / step_y)))
    tw = max(1, int(round(128 / step_x)))
    span_wu = 1.2 * tile_span_from_lattice(wu, th, tw)
    span_wv = 1.2 * tile_span_from_lattice(wv, th, tw)
    # Transposed tiles (128 px along i, 8 along j) for the two-pass warp.
    span_wv_t = 1.2 * tile_span_from_lattice(
        wv, max(1, int(round(128 / step_y))), max(1, int(round(8 / step_x))))

    return dict(
        any_sel=1.0, mixed=False, p_axis=p_axis, sgn=sgn,
        unmixed_axes=unmixed,
        wu_lo=float(wu_lo), wu_hi=float(wu_hi),
        wv_lo=float(wv_lo), wv_hi=float(wv_hi),
        du_q=du_q, dv_q=dv_q, span_wu=float(span_wu), span_wv=float(span_wv),
        span_wv_t=float(span_wv_t),
        du_lo_q=du_lo_q, du_hi_q=du_hi_q,
        dv_lo_q=dv_lo_q, dv_hi_q=dv_hi_q,
        # Raw analysis lattices (nan = invalid): plan_from_stats measures
        # per-tile pixel→grid spans EXACTLY under the (projective) grid map
        # instead of dividing w-spans by one footprint — see
        # grid_unit_spans. Underscored: absent on the device-stats path.
        _lat_wu=wu, _lat_wv=wv, _step_y=float(step_y), _step_x=float(step_x),
    )


def mobius_inverse_np(w, w0, dw, c):
    """Grid coordinate ξ of w-value ``w`` under the Möbius grid
    w(ξ) = w0 + dw·ξ/(1 − c·ξ)  ⇔  ξ(w) = (w−w0)/(dw + c·(w−w0)).
    c = 0 reduces to the uniform grid. The denominator is affine in w and
    positive over the grid's whole w-range by construction (its zero is the
    homography horizon, outside the padded range)."""
    return (w - w0) / (dw + c * (w - w0))


def grid_unit_spans(view: dict, plan: dict):
    """Per-tile pixel→grid spans (gx over 8×128 pixel tiles, gy over 8×128
    and transposed 128×8 tiles) measured on the analysis lattice under the
    plan's grid map. On a projective (Möbius) grid the old w-span/footprint
    division over-estimates by up to f_max/f_min; measuring ξ directly keeps
    warp-rect feasibility tight exactly where the projective grid wins
    (near-diagonal views). Same 1.2 curvature margin as analyze_view's
    w-spans. None when the lattices are unavailable (device-stats path)."""
    if "_lat_wu" not in view:
        return None
    wu, wv = view["_lat_wu"], view["_lat_wv"]
    sy, sx = view["_step_y"], view["_step_x"]
    cu = plan.get("cu", 0.0) or 0.0
    cv = plan.get("cv", 0.0) or 0.0
    if cu == 0.0 and cv == 0.0:
        # Uniform grid: ξ is affine in w, so the per-tile ξ-span is EXACTLY
        # the per-tile w-span (already windowed by analyze_view on this
        # same lattice, same margins) divided by the cell size — skip the
        # lattice windowing entirely (the host plan runs per fresh pose on
        # the orbit path; this is its hottest call).
        return (view["span_wu"] / plan["dwu"],
                view["span_wv"] / plan["dwv"],
                view["span_wv_t"] / plan["dwv"])
    with np.errstate(divide="ignore", invalid="ignore"):
        gxl = mobius_inverse_np(wu, plan["wu0"], plan["dwu"], cu)
        gyl = mobius_inverse_np(wv, plan["wv0"], plan["dwv"], cv)
    th = max(1, int(round(8 / sy)))
    tw = max(1, int(round(128 / sx)))
    span_gx = 1.2 * tile_span_from_lattice(gxl, th, tw)
    span_gy = 1.2 * tile_span_from_lattice(gyl, th, tw)
    span_gy_t = 1.2 * tile_span_from_lattice(
        gyl, max(1, int(round(128 / sy))), max(1, int(round(8 / sx))))
    return span_gx, span_gy, span_gy_t


def tile_span_from_lattice(a: np.ndarray, th: int, tw: int) -> float:
    """Max per-tile (max-min) of lattice samples; tiles are aligned (th×tw)
    windows of lattice CELLS, i.e. (th+1)×(tw+1) corner samples each.
    NaN marks invalid samples (ignored); fully-invalid tiles are skipped.

    Separable log-doubling sliding max/min (this runs per pose on the
    orbit's host-plan path — the windowed np.ix_ loop it replaces cost
    ~4 ms per call at full-image lattices)."""
    R, C = a.shape
    nr = max(1, -(-(R - 1) // th))
    nc = max(1, -(-(C - 1) // tw))
    # Edge-padding repeats the last sample, which matches the clamped
    # indices of the original windowed loop.
    ap = np.pad(a, ((0, nr * th + 1 - R), (0, nc * tw + 1 - C)),
                mode="edge")

    def tiled(fn):
        """Aligned (th+1)×(tw+1)-corner tile reduction in ONE pass per
        axis: block-reduce the th×tw core, then fold in the shared last
        row/column of each tile (np.fmax/fmin ignore NaN)."""
        rows = fn.reduce(
            ap[:, : nc * tw].reshape(-1, nc, tw), axis=2)
        rows = fn(rows, ap[:, tw:: tw][:, :nc])
        out = fn.reduce(
            rows[: nr * th].reshape(nr, th, nc), axis=1)
        return fn(out, rows[th:: th][:nr])

    sp = tiled(np.fmax) - tiled(np.fmin)
    sp = sp[np.isfinite(sp)]
    return float(sp.max()) if sp.size else 0.0


def homography_coeffs(u, p_axis: int, height: int, width: int) -> np.ndarray:
    """Exact projective coefficients of the pixel→(wu, wv) map.

    The unnormalized texture-space direction D(i, j) = pt_tex_h[:3] −
    o·pt_tex_h[3] is AFFINE in the pixel coordinates (the unprojection chain
    is linear in homogeneous clip coords; ndc is affine in pixels), so

        wu = (a_u·i + b_u·j + c_u) / (a_p·i + b_p·j + c_p)
        wv = (a_v·i + b_v·j + c_v) / (a_p·i + b_p·j + c_p)

    with a shared denominator. Returns the 9 coefficients
    [a_u, b_u, c_u, a_v, b_v, c_v, a_p, b_p, c_p] (float64)."""
    v_ax, u_ax = _SLICE_AXES[p_axis]
    vpi = np.asarray(u.view_proj_inv, np.float64)
    g2t = np.asarray(u.global_to_tex, np.float64)
    o = np.asarray(u.cam_pos_tex, np.float64)

    def D(py, px):
        ndc_x = (px + 0.5) / width * 2.0 - 1.0
        ndc_y = (py + 0.5) / height * 2.0 - 1.0
        clip = np.array([ndc_x, ndc_y, 0.0, 1.0])
        pt4 = g2t @ (vpi @ clip)
        return pt4[:3] - o * pt4[3]

    d00 = D(0.0, 0.0)
    di = D(1.0, 0.0) - d00
    dj = D(0.0, 1.0) - d00
    return np.array([
        di[u_ax], dj[u_ax], d00[u_ax],
        di[v_ax], dj[v_ax], d00[v_ax],
        di[p_axis], dj[p_axis], d00[p_axis],
    ], np.float64)


def pass_a_positions_np(hc: np.ndarray, plan: dict, yg: np.ndarray,
                        j: np.ndarray):
    """Numpy twin of the in-jit pass-A position math (plan feasibility +
    tests): XA[yg, j] = gx(Î(yg, j), j) where Î solves gy(Î, j) = yg.
    Returns (xa, ihat)."""
    au, bu, cu, av, bv, cv, ap, bp, cp = hc
    cug = plan.get("cu", 0.0) or 0.0
    cvg = plan.get("cv", 0.0) or 0.0
    with np.errstate(divide="ignore", invalid="ignore"):
        y = yg + 0.5
        wv_t = plan["wv0"] + plan["dwv"] * y / (1.0 - cvg * y)
        den = av - wv_t * ap
        num = wv_t * (bp * j + cp) - (bv * j + cv)
        ihat = num / den
        wu = (au * ihat + bu * j + cu) / (ap * ihat + bp * j + cp)
        xa = mobius_inverse_np(wu, plan["wu0"], plan["dwu"], cug) - 0.5
    return xa, ihat


def pass_b1_positions_np(hc: np.ndarray, plan: dict, xg: np.ndarray,
                         i: np.ndarray):
    """Variant-B first-pass positions (the TRANSPOSED Catmull-Smith
    factorisation, used when variant A's row solve degenerates — e.g.
    diagonal azimuths): YB[xg, i] = gy(i, Ĵ(xg, i)) where Ĵ solves
    gx(i, Ĵ) = wu(xg). Returns (yb, jhat)."""
    au, bu, cu, av, bv, cv, ap, bp, cp = hc
    cug = plan.get("cu", 0.0) or 0.0
    cvg = plan.get("cv", 0.0) or 0.0
    with np.errstate(divide="ignore", invalid="ignore"):
        x = xg + 0.5
        wu_c = plan["wu0"] + plan["dwu"] * x / (1.0 - cug * x)
        den = bu - wu_c * bp
        jhat = (wu_c * cp - cu - (au - wu_c * ap) * i) / den
        wv = ((av * i + bv * jhat + cv)
              / (ap * i + bp * jhat + cp))
        yb = mobius_inverse_np(wv, plan["wv0"], plan["dwv"], cvg) - 0.5
    return yb, jhat


def _pick_rect(span, src_width, quantum: int = 128,
               allow_full_src: bool = False):
    """Rect width covering ``span`` + alignment/tent margins, quantised at
    128 lanes. The two-pass warp is DMA-bound and the rect width directly
    scales its DMA bytes (warp_ms is ~9 of a ~22 ms skip-mode frame at the
    round-4 512-quantum, which rounded every headline pose up to 1024);
    tight rects halve that. Specialisation count stays bounded: static
    poses use one rect, and the orbit's frozen tiers take a per-tier MAX
    over poses anyway (freeze_statics), so orbit compile count is governed
    by the tier count, not the rect quantum. The row-aligned rect is
    (C, 8, RECT) in VMEM; the rect must never exceed the source row width
    (the DMA would read out of bounds — a device fault, not an error).

    ``allow_full_src``: when the rect covers the WHOLE source row (possible
    only when the width is lane-aligned), the aligned DMA base is pinned at
    0 and every source index lies inside the window — feasible for ANY
    span. Enabled only on the frozen-orbit (forced) path, where the tier's
    larger grid scales this pose's pass-A span past the cap (previously
    the ~100 ms XLA-warp band); the unforced per-pose search keeps the cap
    so plan costs (and hence tier banding) stay unchanged."""
    if not np.isfinite(span):
        return None
    src = int(src_width)
    cap = min(6144 if allow_full_src else 4096, (src // 128) * 128)
    rect = -(-int(span + 132.0) // quantum) * quantum
    rect = max(rect, 256)
    if rect > cap:
        # A cap-wide window still covers any span <= cap - 132 (the
        # aligned base wastes at most 127 + tent margin).
        rect = cap
        if span > cap - 132.0:
            if allow_full_src and cap == src:
                return cap
            return None
    return rect


def two_pass_warp_plan(u, p_axis: int, height: int, width: int,
                       plan: dict, view: dict,
                       only_variant: str | None = None,
                       allow_full_src: bool = False) -> dict | None:
    """Feasibility + rect widths for the two-pass projective warp; None →
    caller uses the single-pass warp.

    Evaluates BOTH Catmull-Smith factorisation orders and picks the one
    with the smaller total rect (the row-first order degenerates when
    image rows run near-parallel to the grid's wu axis — diagonal
    azimuths — exactly where the column-first order is well conditioned):

    * variant A (row-first): pass A resamples grid rows at XA(yg, j),
      pass B resamples columns at gy;
    * variant B (column-first): pass 1 resamples grid columns at
      YB(xg, i), pass 2 resamples rows at gx.

    First-pass positions are only meaningful where the solved pixel
    coordinate lies in (a margin around) the image — the kernel masks the
    rest (pos = -10) — so feasibility measures the per-tile span of the
    MASKED positions on a tile-corner lattice, with a wider validity
    margin than the kernel uses."""
    hc = homography_coeffs(u, p_axis, height, width)
    Hi, Wi = plan["Hi"], plan["Wi"]

    # Second-pass spans in GRID units: measured exactly under the plan's
    # (possibly projective) grid map when the analysis lattices are
    # available; the w-span/footprint division is the device-stats
    # fallback (exact for the uniform grid it implies).
    gus = grid_unit_spans(view, plan)
    if gus is not None:
        span_gx_g, _span_gy_g, span_gy_t_g = gus
    else:
        span_gx_g = view["span_wu"] / plan["dwu"]
        span_gy_t_g = view.get("span_wv_t", np.nan) / plan["dwv"]

    cands = []

    if only_variant in (None, "A"):
        yg, j = np.meshgrid(np.arange(0.0, Hi + 7.0, 8.0),
                            np.arange(0.0, width + 7.0, 8.0), indexing="ij")
        xa, ihat = pass_a_positions_np(hc, plan, yg, j)
        ok = np.isfinite(xa) & (ihat >= -16.0) & (ihat <= height + 15.0)
        if ok.any():
            xa = np.where(ok, xa, np.nan)
            span_a = 1.15 * tile_span_from_lattice(xa, 1, 16)
            ra = _pick_rect(span_a, Wi, allow_full_src=allow_full_src)
            rb = _pick_rect(span_gy_t_g, Hi, allow_full_src=allow_full_src)
            if ra is not None and rb is not None:
                cands.append(("A", ra, rb))

    if only_variant in (None, "B"):
        xg, ii = np.meshgrid(np.arange(0.0, Wi + 7.0, 8.0),
                             np.arange(0.0, height + 7.0, 8.0), indexing="ij")
        yb, jhat = pass_b1_positions_np(hc, plan, xg, ii)
        okb = np.isfinite(yb) & (jhat >= -16.0) & (jhat <= width + 15.0)
        if okb.any():
            yb = np.where(okb, yb, np.nan)
            span_1 = 1.15 * tile_span_from_lattice(yb, 1, 16)
            r1 = _pick_rect(span_1, Hi, allow_full_src=allow_full_src)
            r2 = _pick_rect(span_gx_g, Wi, allow_full_src=allow_full_src)
            if r1 is not None and r2 is not None:
                cands.append(("B", r1, r2))

    if not cands:
        return None
    variant, ra, rb = min(cands, key=lambda t: t[1] + t[2])
    return dict(hcoef=hc, RECT_A=ra, RECT_B=rb, warp_variant=variant)
