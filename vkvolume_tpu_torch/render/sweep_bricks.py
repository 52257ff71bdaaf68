"""Brick-batched plane sweep over separable w-grid rays — port of
``vkvolume_tpu/render/sweep_bricks.py``.

Per ``tile_h × 128`` tile of the w-grid image, front-to-back compositing
over 8-slab bricks: one tight ESS check (``cskip``) and one Chebyshev leap
(``coarse``) per brick, bilinear in-plane samples per slab, the closed-form
TF with the reference's opacity correction ``vaf·(1-(1-a)^κ)``, and ERT at
alpha > 0.99. The brick walk is a function of the TILE (its covered
pixels' ray bounds), so it is computed once per tile; that keeps the set of
sampled bricks, and with it the sample counts and first-hit planes, equal
to the TPU kernel's.

* ``grid_fields`` and ``brick_inputs`` (the coarse leap map, the tight
  skip map and the occupied brick range) are plain PyTorch, as the JAX
  package left them to XLA.
* ``sweep_bricks_kernel`` launches K1 (csrc/sweep_bricks.cu) for CUDA
  tensors and runs ``sweep_bricks_reference``, its plain version, for CPU
  tensors.
* ``sweep_bricks`` is the whole stage: inputs, K1, and the colour / depth
  epilogue.

The TPU kernel DMAs a (PLANES, R, rect_w) volume rect per brick and
samples it with lane gathers and a tent-weight matmul; the port reads the
two texel rows of each sample directly (the tent weights are non-zero on
at most two rows), so the rect geometry statics (R, span_blks, rect_w) have
no counterpart here. The plan sizes them so that every covered sample
lies inside the rect, which makes the two identical.

Two variants of the kernel, as in the JAX package:

* aligned (``n_slabs == Np``): slab k samples voxel plane k;
* plane-pair lerp (``n_slabs != Np``): slab k lies between planes kk0 and
  kk0 + 1; the two planes' rows are lerped and quantised to u8.8 fixed
  point (round half to even) before the in-plane lerp, exactly as the TPU
  kernel packs its lerped rows.

Either runs with the closed-form intensity TF or the gradient-modulated
one (``a_tf *= clip((gradient - gmin)·ginv, 0, 1)``, the gradient map
sampled by the same taps). The texture-TF variant is not ported.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..tf.transfer_function import TFParams
from ..utils import cuda_build
from .ray_setup import _SLICE_AXES, FrameUniforms, RenderOutput

TILE_W = 128
BRICK = 8          # slabs per brick
TILE_HS = (8, 16, 32)
_BIG = 1e30
_INV255 = float(np.float32(1.0 / 255.0))
_INV256 = 1.0 / 256.0

LAUNCHES = {"sweep_bricks": 0}


def _f32(x) -> float:
    return float(np.float32(x))


def grid_fields(u: FrameUniforms, wu_g: torch.Tensor, wv_g: torch.Tensor,
                sgn: int, p_axis: int, dim_max: int, n_slabs: int):
    """(s_lo, s_hi, covered, kappa) for w-grid rays, computed in w-space:
    make_rays' entry/exit semantics (AABB slab test, clip-plane entry clamp,
    frag-exact back-face recompute) on the unnormalised direction
    (wu, wv, 1)·sgn. Host scalars are combined in float32 (numpy) as the
    JAX package's traced float32 scalars are."""
    f32 = np.float32
    v_ax, u_ax = _SLICE_AXES[p_axis]
    o = [f32(c) for c in np.asarray(u.cam_pos_tex, np.float32)]
    d = [None, None, None]
    d[p_axis] = torch.full(wu_g.shape, float(sgn), device=wu_g.device)
    d[u_ax] = wu_g * float(sgn)
    d[v_ax] = wv_g * float(sgn)
    inv = [1.0 / d[a] for a in range(3)]
    t_near = t_far = None
    for a in range(3):
        t0 = float(f32(0.0) - o[a]) * inv[a]
        t1 = float(f32(1.0) - o[a]) * inv[a]
        lo = torch.minimum(t0, t1)
        hi = torch.maximum(t0, t1)
        t_near = lo if t_near is None else torch.maximum(t_near, lo)
        t_far = hi if t_far is None else torch.minimum(t_far, hi)
    plane = [f32(c) for c in np.asarray(u.plane_tex, np.float32)]
    s_o = float(plane[0] * o[0] + plane[1] * o[1] + plane[2] * o[2] + plane[3])
    s_d = (float(plane[0]) * d[0] + float(plane[1]) * d[1]
           + float(plane[2]) * d[2])
    t_plane = torch.where(s_d != 0.0,
                          -s_o / torch.where(s_d == 0.0, 1.0, s_d),
                          torch.full_like(s_d, float("inf")))
    t_entry = torch.where(s_d > 0.0, torch.maximum(t_near, t_plane), t_near)
    covered = (t_entry < t_far) & (t_far > 0.0)
    entry = [float(o[a]) + t_entry * d[a] for a in range(3)]
    t_back = None
    for a in range(3):
        t2 = torch.maximum(-entry[a] * inv[a], (1.0 - entry[a]) * inv[a])
        t_back = t2 if t_back is None else torch.minimum(t_back, t2)
    s_a = entry[p_axis]
    s_b = t_back * d[p_axis] + entry[p_axis]
    s_lo = torch.minimum(s_a, s_b)
    s_hi = torch.maximum(s_a, s_b)
    kappa = (float(f32(dim_max) / f32(n_slabs))
             * torch.sqrt(1.0 + wu_g * wu_g + wv_g * wv_g))
    return s_lo, s_hi, covered, kappa


@dataclasses.dataclass(frozen=True)
class BrickInputs:
    """Everything K1 reads: per-pixel w-grid fields (H, W), the two coarse
    maps (mp, CVp, 128) u8, the transposed volume (Np, Sv, Su) u8 and, for
    a gradient TF, the gradient map transposed alike (else None), the
    occupied brick range (2,) int32 and the launch scalars (the fields of
    ``BrickParams`` in csrc/sweep_bricks.cu)."""
    wu: torch.Tensor
    wv: torch.Tensor
    s_lo: torch.Tensor
    s_hi: torch.Tensor
    kappa: torch.Tensor
    cov: torch.Tensor          # bool
    coarse: torch.Tensor
    cskip: torch.Tensor
    vol: torch.Tensor
    grad: torch.Tensor | None
    kb_occ: torch.Tensor
    params: dict


def planes_per_brick(Np: int, n_slabs: int) -> int:
    """Voxel planes one brick's slabs touch (the TPU kernel's rect depth):
    BRICK + 1 when aligned, else ceil((BRICK-1)·Np/n_slabs) + 2."""
    if n_slabs == Np:
        return BRICK + 1
    return int(np.ceil((BRICK - 1) * (Np / n_slabs))) + 2


def brick_inputs(vol_t: torch.Tensor, occupancy_t: torch.Tensor,
                 tf: TFParams, uniforms: FrameUniforms, grid, *, p_axis: int,
                 ert: bool, count_samples: bool, n_slabs: int, sgn: int,
                 tile_h: int, dist_leap: bool,
                 grad_t: torch.Tensor | None = None) -> BrickInputs:
    """K1's inputs: the prologue of ``_sweep_bricks_jit`` (coarse leap map,
    tight skip map, occupied brick range, launch scalars). ``grad_t``: the
    gradient map transposed like ``vol_t``, required by a gradient TF."""
    wu, wv, s_lo, s_hi, kappa, covered = grid
    H, W = wu.shape
    Np, Sv, Su = vol_t.shape
    if tf.use_gradient and grad_t is None:
        raise ValueError("a gradient TF needs the transposed gradient map")
    use_gradient = bool(tf.use_gradient)
    if use_gradient and tuple(grad_t.shape) != (Np, Sv, Su):
        raise ValueError(f"grad_t {tuple(grad_t.shape)} != vol_t "
                         f"{(Np, Sv, Su)}")
    PLANES = planes_per_brick(Np, n_slabs)
    if Np < PLANES:
        raise ValueError(f"volume too shallow for the brick sweep: {Np}")
    if tile_h not in TILE_HS or H % tile_h or W % TILE_W:
        raise ValueError(f"grid {H}x{W} does not tile by {tile_h}x{TILE_W}")
    dev = vol_t.device
    v_ax, u_ax = _SLICE_AXES[p_axis]
    o = np.asarray(uniforms.cam_pos_tex, np.float32)

    # Coarse 2D maps (as _sweep_bricks_jit): map cells pooled so that one
    # (16, 128) window per brick covers the tile's footprint.
    mp, mv, mu = occupancy_t.shape
    bp_p = -(-Np // mp)
    bp_v = -(-Sv // mv)
    bp_u = -(-Su // mu)
    factor_v = max(1, -(-8 // bp_v))
    factor_u = max(-(-mu // 128), max(1, -(-8 // bp_u)))
    CV = -(-mv // factor_v)
    CU = -(-mu // factor_u)
    dmap = occupancy_t if dist_leap else torch.clamp(occupancy_t, max=1)
    dmap_pad = torch.nn.functional.pad(
        dmap, (0, CU * factor_u - mu, 0, CV * factor_v - mv), value=255)
    coarse = dmap_pad.reshape(mp, CV, factor_v, CU, factor_u).amin(dim=(2, 4))
    # Leap map: pre-min'd with the next plane (slab k reads planes k, k+1).
    coarse_pair = torch.minimum(coarse, torch.cat([coarse[1:], coarse[-1:]]))
    CVp = max(16, -(-CV // 8) * 8)

    def pad_map(a):
        return torch.nn.functional.pad(a, (0, 128 - CU, 0, CVp - CV),
                                       value=255).to(torch.uint8).contiguous()

    # Tight skip map: cskip[m] == 0 iff an occupied cell lies in map planes
    # [m, m + mp_span] (the plane span one brick covers).
    mp_span = -(-(PLANES - 1) // bp_p)
    cbin = torch.clamp(coarse, max=1)
    cskip = cbin
    for s in range(1, mp_span + 1):
        fill = torch.full((min(s, mp), CV, CU), 255, dtype=cbin.dtype,
                          device=dev)
        cskip = torch.minimum(cskip, torch.cat([cbin[s:], fill])[:mp])

    # Globally occupied brick range.
    ds = _f32(1.0 / n_slabs)
    n_bricks = -(-n_slabs // BRICK)
    nonempty_m = (occupancy_t == 0).any(dim=2).any(dim=1)
    ks = torch.arange(n_slabs, device=dev)
    zps = (ks.to(torch.float32) + 0.5) * ds * Np - 0.5
    k0s = torch.floor(zps).to(torch.int64).clamp(0, Np - 2)
    ne = (nonempty_m[(k0s // bp_p).clamp(0, mp - 1)]
          | nonempty_m[((k0s + 1) // bp_p).clamp(0, mp - 1)])
    kb_i = ks // BRICK
    kb_occ = torch.stack([
        torch.where(ne, kb_i, n_bricks).amin(),
        torch.where(ne, kb_i, -1).amax()]).to(torch.int32)

    params = dict(
        Np=Np, Sv=Sv, Su=Su, H=H, W=W, tile_h=tile_h, bp_p=bp_p, CV=CV,
        CU=CU, CVp=CVp, mp=mp, n_slabs=n_slabs, sgn=1 if sgn > 0 else -1,
        ert=int(bool(ert)), count_samples=int(bool(count_samples)),
        aligned=int(n_slabs == Np), use_gradient=int(use_gradient),
        o_u=float(o[u_ax]), o_v=float(o[v_ax]), o_p=float(o[p_axis]), ds=ds,
        imin=tf.intensity_min, iinv=tf.intensity_range_inv,
        vaf=tf.voxel_alpha_factor,
        inv_cvox_v=_f32(1.0 / (factor_v * bp_v)),
        inv_cvox_u=_f32(1.0 / (factor_u * bp_u)),
        drift_u=_f32(Su * bp_p / (Np * bp_u)),   # map cells per map plane
        drift_v=_f32(Sv * bp_p / (Np * bp_v)),
        gmin=tf.gradient_min, ginv=tf.gradient_range_inv)
    f = torch.float32
    return BrickInputs(
        wu=wu.to(f).contiguous(), wv=wv.to(f).contiguous(),
        s_lo=s_lo.to(f).contiguous(), s_hi=s_hi.to(f).contiguous(),
        kappa=kappa.to(f).contiguous(), cov=covered.contiguous(),
        coarse=pad_map(coarse_pair), cskip=pad_map(cskip),
        vol=vol_t.contiguous(),
        grad=grad_t.contiguous() if use_gradient else None, kb_occ=kb_occ,
        params=params)


def _f2i(x: torch.Tensor) -> torch.Tensor:
    """float → int64 of an already floored/ceiled value, clamped like the
    kernel's f2i (only absurd values are affected)."""
    return x.clamp(-1e9, 1e9).to(torch.int64)


def sweep_bricks_reference(inp: BrickInputs):
    """Plain PyTorch version of K1: (lum, alpha, firsts, nsamp), each
    (H, W). Runs every tile in lock-step, each with its own brick walk and
    masks; the arithmetic is the kernel's, operation for operation."""
    p = inp.params
    H, W, th = p["H"], p["W"], p["tile_h"]
    Np, Sv, Su, n_slabs = p["Np"], p["Sv"], p["Su"], p["n_slabs"]
    bp_p, CV, CU, CVp, mp = p["bp_p"], p["CV"], p["CU"], p["CVp"], p["mp"]
    sgn, ert = p["sgn"], bool(p["ert"])
    ds = p["ds"]
    f32 = np.float32
    dev = inp.vol.device
    nty, ntx = H // th, W // TILE_W
    T = nty * ntx

    def tiles(a):
        return (a.reshape(nty, th, ntx, TILE_W).permute(0, 2, 1, 3)
                .reshape(T, th, TILE_W))

    wu_t, wv_t = tiles(inp.wu), tiles(inp.wv)
    s_lo, s_hi, kap, cov = (tiles(inp.s_lo), tiles(inp.s_hi),
                            tiles(inp.kappa), tiles(inp.cov))
    wu_c = wu_t[:, 0, :]          # the u math uses tile row 0 (separable)
    wv_r = wv_t[:, :, 0]          # the v math uses tile column 0

    def cov_min(a):
        return torch.where(cov, a, _BIG).amin(dim=(1, 2))

    def cov_max(a):
        return torch.where(cov, a, -_BIG).amax(dim=(1, 2))

    s_lo_t, s_hi_t = cov_min(s_lo), cov_max(s_hi)
    wu_min, wu_max = cov_min(wu_t), cov_max(wu_t)
    wv_min, wv_max = cov_min(wv_t), cov_max(wv_t)
    any_cov = cov.reshape(T, -1).any(dim=1)

    n_bricks = -(-n_slabs // BRICK)
    kb_occ_lo, kb_occ_hi = (int(v) for v in inp.kb_occ.tolist())
    k_a = _f2i(torch.floor(s_lo_t / ds - 0.5))
    k_b = _f2i(torch.ceil(s_hi_t / ds - 0.5))
    kb_a = torch.clamp(torch.clamp(k_a // BRICK, min=kb_occ_lo), 0, n_bricks - 1)
    kb_b = torch.clamp(torch.clamp(k_b // BRICK, max=kb_occ_hi), 0, n_bricks - 1)
    if sgn > 0:
        kb_begin, kb_end = kb_a, kb_b + 1
        in_range = lambda kb: kb < kb_end
    else:
        kb_begin, kb_end = kb_b, kb_a - 1
        in_range = lambda kb: kb > kb_end

    slab_s = lambda k: (k.to(torch.float32) + 0.5) * ds
    aligned, use_gradient = bool(p["aligned"]), bool(p["use_gradient"])

    def k0_of(k):
        if aligned:
            return k.clamp(0, Np - 2)
        return _f2i(torch.floor(slab_s(k) * float(Np) - 0.5)).clamp(0, Np - 2)
    rate = torch.clamp(torch.maximum(
        torch.maximum(wu_min.abs(), wu_max.abs()) * p["drift_u"],
        torch.maximum(wv_min.abs(), wv_max.abs()) * p["drift_v"]), min=1.0)
    inv_dsNp = float(f32(1.0) / (f32(ds) * f32(Np)))
    d_pair = int(np.ceil(f32(2.0) * f32(bp_p) * f32(inv_dsNp)))

    def qu_bounds2(k1, k2):
        t1 = slab_s(k1) - p["o_p"]
        t2 = slab_s(k2) - p["o_p"]
        a1, b1, a2, b2 = wu_min * t1, wu_max * t1, wu_min * t2, wu_max * t2
        c1, e1, c2, e2 = wv_min * t1, wv_max * t1, wv_min * t2, wv_max * t2
        ulo = torch.minimum(torch.minimum(a1, b1), torch.minimum(a2, b2))
        uhi = torch.maximum(torch.maximum(a1, b1), torch.maximum(a2, b2))
        vlo = torch.minimum(torch.minimum(c1, e1), torch.minimum(c2, e2))
        vhi = torch.maximum(torch.maximum(c1, e1), torch.maximum(c2, e2))
        return ((p["o_u"] + ulo) * float(Su) - 0.5,
                (p["o_u"] + uhi) * float(Su) - 0.5,
                (p["o_v"] + vlo) * float(Sv) - 0.5,
                (p["o_v"] + vhi) * float(Sv) - 0.5)

    rows16 = torch.arange(16, device=dev)
    cols = torch.arange(TILE_W, device=dev)

    def win_min(ref, m, qu_lo, qu_hi, qv_lo, qv_hi):
        """Min of ref[m] over the dilated cell window of each tile; 0 when
        the window is taller than the 16-row view."""
        iv, iu = p["inv_cvox_v"], p["inv_cvox_u"]
        cv_lo = _f2i(torch.floor((qv_lo - 1.0) * iv)).clamp(0, CV - 1)
        cv_hi = _f2i(torch.floor((qv_hi + 2.0) * iv)).clamp(0, CV - 1)
        cu_lo = _f2i(torch.floor((qu_lo - 1.0) * iu)).clamp(0, CU - 1)
        cu_hi = _f2i(torch.floor((qu_hi + 2.0) * iu)).clamp(0, CU - 1)
        cv8 = ((cv_lo // 8) * 8).clamp(0, max(CVp - 16, 0))
        rows = cv8[:, None] + rows16[None, :]
        block = ref[m[:, None, None], rows[:, :, None], cols[None, None, :]]
        mask = (((rows >= cv_lo[:, None]) & (rows <= cv_hi[:, None]))[:, :, None]
                & ((cols[None, :] >= cu_lo[:, None])
                   & (cols[None, :] <= cu_hi[:, None]))[:, None, :])
        d = torch.where(mask, block.to(torch.int64), 255).amin(dim=(1, 2))
        return torch.where(cv_hi > cv8 + 15, 0, d)

    def brick_window(kb):
        k1 = kb * BRICK
        k2 = torch.clamp(k1 + BRICK - 1, max=n_slabs - 1)
        if sgn > 0:
            ka, kc, k_front = k1, (k2 + d_pair).clamp(0, n_slabs - 1), k1
        else:
            ka, kc, k_front = (k1 - d_pair).clamp(0, n_slabs - 1), k2, k2
        m_lo = (k0_of(k1) // bp_p).clamp(0, mp - 1)
        m0 = (k0_of(k_front) // bp_p).clamp(0, mp - 1)
        occupied = win_min(inp.cskip, m_lo, *qu_bounds2(k1, k2)) == 0
        d = win_min(inp.coarse, m0, *qu_bounds2(ka, kc))
        return occupied, d

    def leap_target(kb, d):
        P = _f2i(torch.floor((d.to(torch.float32) - 1.0) / rate))
        if sgn > 0:
            c0 = k0_of(kb * BRICK) // bp_p
            k_tgt = _f2i(torch.floor(
                (((c0 + P + 1) * bp_p - 2).to(torch.float32) + 1.5)
                * inv_dsNp - 0.5))
            return torch.maximum(kb + 1, k_tgt // BRICK)
        k2 = torch.clamp(kb * BRICK + BRICK - 1, max=n_slabs - 1)
        c0 = k0_of(k2) // bp_p
        k_tgt = _f2i(torch.ceil(
            (((c0 - P) * bp_p).to(torch.float32) + 0.5) * inv_dsNp - 0.5)) - 1
        return torch.minimum(kb - 1, k_tgt // BRICK)

    def next_valid(kb, todo):
        todo = todo & in_range(kb)
        while bool(todo.any()):
            occupied, d = brick_window(kb)
            kb = torch.where(todo & ~occupied, leap_target(kb, d), kb)
            todo = todo & ~occupied & in_range(kb)
        return kb

    f = torch.float32
    lum = torch.zeros((T, th, TILE_W), dtype=f, device=dev)
    alpha = torch.zeros_like(lum)
    firsts = torch.full_like(lum, 2.0)
    nsamp = torch.zeros((T, th, TILE_W), dtype=torch.int32, device=dev)
    vol = inp.vol.reshape(-1)
    grad = inp.grad.reshape(-1) if use_gradient else None

    def sample_brick(kb, sel, lum, alpha, firsts, nsamp):
        js = range(BRICK) if sgn > 0 else range(BRICK - 1, -1, -1)
        for j in js:
            k = kb * BRICK + j
            s = slab_s(k)
            t = s - p["o_p"]
            s3 = s[:, None, None]
            in_rng = (cov & (s3 >= s_lo) & (s3 <= s_hi)
                      & (sel & (k < n_slabs))[:, None, None])
            if ert:
                in_rng = in_rng & (alpha <= 0.99)
            qu = (p["o_u"] + wu_c * t[:, None]) * float(Su) - 0.5
            qv = torch.clamp((p["o_v"] + wv_r * t[:, None]) * float(Sv) - 0.5,
                             0.0, float(Sv) - 1.0)
            flu = torch.floor(qu)
            iu0 = _f2i(flu).clamp(0, Su - 1)
            iu1 = (iu0 + 1).clamp(max=Su - 1)
            fu = torch.clamp(qu - flu, 0.0, 1.0)
            fu = torch.where(iu1 > iu0, fu, 0.0)[:, None, :]
            r0 = _f2i(torch.floor(qv)).clamp(0, Sv - 1)
            r1 = (r0 + 1).clamp(max=Sv - 1)
            w0 = torch.clamp(1.0 - (qv - r0.to(f)).abs(), min=0.0)[:, :, None]
            w1 = torch.clamp(1.0 - (qv - (r0 + 1).to(f)).abs(),
                             min=0.0)[:, :, None]
            if aligned:
                kk0, fp = k0_of(k), None
            else:
                zp = s * float(Np) - 0.5
                kk0 = _f2i(torch.floor(zp)).clamp(0, Np - 2)
                fp = torch.clamp(zp - kk0.to(f), 0.0, 1.0)[:, None, None]
            base = (kk0 * (Sv * Su))[:, None, None]

            def tap(src, r, iu):
                idx = base + r[:, :, None] * Su + iu[:, None, :]
                if aligned:
                    return src[idx].to(f)
                # Plane-pair lerp, quantised to u8.8 fixed point.
                rowsf = (src[idx].to(f) * (1.0 - fp)
                         + src[idx + Sv * Su].to(f) * fp)
                return torch.round(rowsf * 256.0) * _INV256

            def bilinear(src):
                v00, v01 = tap(src, r0, iu0), tap(src, r0, iu1)
                v10, v11 = tap(src, r1, iu0), tap(src, r1, iu1)
                c0 = v00 + (v01 - v00) * fu
                c1 = v10 + (v11 - v10) * fu
                return (w0 * c0 + w1 * c1) * _INV255

            a_tf = torch.clamp((bilinear(vol) - p["imin"]) * p["iinv"],
                               0.0, 1.0)
            if use_gradient:
                a_tf = a_tf * torch.clamp(
                    (bilinear(grad) - p["gmin"]) * p["ginv"], 0.0, 1.0)
            a_corr = torch.clamp(
                p["vaf"] * (1.0 - torch.pow(1.0 - a_tf, kap)), 0.0, 1.0)
            contrib = in_rng & (a_tf > 0.0)
            one_m = 1.0 - alpha
            lum = torch.where(contrib, lum + one_m * a_tf * a_corr, lum)
            new_alpha = torch.where(contrib, alpha + one_m * a_corr, alpha)
            hit = contrib & (a_corr > 0.0) & (firsts > 1.5)
            firsts = torch.where(hit, s3.expand_as(firsts), firsts)
            if ert:
                new_alpha = torch.where(contrib & (new_alpha > 0.99), 1.0,
                                        new_alpha)
            alpha = new_alpha
            if p["count_samples"]:
                nsamp = nsamp + in_rng.to(torch.int32)
        return lum, alpha, firsts, nsamp

    kb = next_valid(kb_begin, any_cov)
    while True:
        active = any_cov & in_range(kb)
        if ert:
            active = active & (cov & (alpha <= 0.99)).reshape(T, -1).any(dim=1)
        if not bool(active.any()):
            break
        first = slab_s(kb * BRICK)
        last = slab_s(torch.clamp(kb * BRICK + BRICK - 1, max=n_slabs - 1))
        sb_lo = torch.minimum(first, last)[:, None, None]
        sb_hi = torch.maximum(first, last)[:, None, None]
        work = cov & (sb_hi >= s_lo) & (sb_lo <= s_hi)
        if ert:
            work = work & (alpha <= 0.99)
        sel = active & work.reshape(T, -1).any(dim=1)
        if bool(sel.any()):
            lum, alpha, firsts, nsamp = sample_brick(kb, sel, lum, alpha,
                                                     firsts, nsamp)
        kb = torch.where(active, next_valid(kb + sgn, active), kb)

    def untile(a):
        return (a.reshape(nty, ntx, th, TILE_W).permute(0, 2, 1, 3)
                .reshape(H, W))

    return untile(lum), untile(alpha), untile(firsts), untile(nsamp)


def sweep_bricks_kernel(inp: BrickInputs):
    """K1: (lum, alpha, firsts, nsamp). CPU tensors run the plain version;
    CUDA tensors launch the kernel (or raise)."""
    if inp.vol.device.type == "cpu":
        return sweep_bricks_reference(inp)
    p = inp.params
    H, W = p["H"], p["W"]
    for name in ("wu", "wv", "s_lo", "s_hi", "kappa"):
        cuda_build.require_cuda(name, getattr(inp, name), torch.float32,
                                (H, W))
    cuda_build.require_cuda("cov", inp.cov, torch.bool, (H, W))
    for name in ("coarse", "cskip"):
        cuda_build.require_cuda(name, getattr(inp, name), torch.uint8,
                                (p["mp"], p["CVp"], TILE_W))
    cuda_build.require_cuda("vol", inp.vol, torch.uint8,
                            (p["Np"], p["Sv"], p["Su"]))
    if p["use_gradient"]:
        cuda_build.require_cuda("grad", inp.grad, torch.uint8,
                                (p["Np"], p["Sv"], p["Su"]))
    cuda_build.require_cuda("kb_occ", inp.kb_occ, torch.int32, (2,))
    lib = cuda_build.load_kernels()
    dev = inp.vol.device
    lum = torch.empty((H, W), dtype=torch.float32, device=dev)
    alpha = torch.empty_like(lum)
    firsts = torch.empty_like(lum)
    nsamp = torch.empty((H, W), dtype=torch.int32, device=dev)
    # Without a gradient TF the kernel never reads ``grad``.
    grad = inp.grad if p["use_gradient"] else inp.vol
    ptrs = [t.data_ptr() for t in (
        inp.wu, inp.wv, inp.s_lo, inp.s_hi, inp.kappa, inp.cov, inp.coarse,
        inp.cskip, inp.vol, grad, inp.kb_occ, lum, alpha, firsts, nsamp)]
    cuda_build.check(lib.vkv_sweep_bricks(
        *ptrs, cuda_build.BrickParams(**p), cuda_build.stream()),
        "sweep_bricks")
    LAUNCHES["sweep_bricks"] += 1
    return lum, alpha, firsts, nsamp


def sweep_bricks(vol_t: torch.Tensor, occupancy_t: torch.Tensor,
                 tf: TFParams, uniforms: FrameUniforms, proj_view_model,
                 grid, *, p_axis: int, ert: bool, count_samples: bool,
                 n_slabs: int, sgn: int, tile_h: int, dist_leap: bool,
                 grad_t: torch.Tensor | None = None) -> RenderOutput:
    """The brick sweep stage: ``grid`` = (wu, wv, s_lo, s_hi, kappa,
    covered) w-grid fields (see grid_fields); ``proj_view_model`` the host
    (4, 4) float32 matrix for the first-hit depth; ``grad_t`` the
    transposed gradient map (gradient TFs)."""
    inp = brick_inputs(vol_t, occupancy_t, tf, uniforms, grid, p_axis=p_axis,
                       ert=ert, count_samples=count_samples, n_slabs=n_slabs,
                       sgn=sgn, tile_h=tile_h, dist_leap=dist_leap,
                       grad_t=grad_t)
    lum, alpha, firsts, nsamp = sweep_bricks_kernel(inp)
    f = torch.float32
    p = inp.params
    v_ax, u_ax = _SLICE_AXES[p_axis]
    H, W = lum.shape
    color = torch.stack([lum, lum, lum, alpha], -1)
    hit = (alpha > 0.0) & (firsts < 1.5)
    t_hit = firsts - p["o_p"]
    pen_xyz = [None, None, None]
    pen_xyz[p_axis] = firsts
    pen_xyz[u_ax] = p["o_u"] + inp.wu * t_hit
    pen_xyz[v_ax] = p["o_v"] + inp.wv * t_hit
    pen = torch.stack(pen_xyz, -1) - 0.5
    pen_h = torch.cat([pen, torch.ones((H, W, 1), dtype=f, device=pen.device)],
                      -1)
    pvm = torch.as_tensor(np.asarray(proj_view_model, np.float32),
                          device=pen.device)
    pen_clip = pen_h @ pvm.T
    w = pen_clip[..., 3]
    pen_depth = pen_clip[..., 2] / torch.where(w == 0, 1.0, w)
    depth = torch.where(hit, pen_depth, 0.0)
    zi = torch.zeros((H, W), dtype=torch.int32, device=pen.device)
    return RenderOutput(color=color, depth=depth, num_volume_samples=nsamp,
                        num_distance_samples=zi, num_empty_samples=zi,
                        iterations=n_slabs)
