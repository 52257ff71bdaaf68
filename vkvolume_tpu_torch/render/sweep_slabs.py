"""Per-slab plane sweep over per-cell rays — port of
``vkvolume_tpu/render/sweep_pallas.py``'s ``_sweep_pallas_jit`` and its
Pallas kernel (K7).

Per 8×128 tile of the image (the w-grid's, in the frame), front-to-back
compositing over slabs: per slab one ESS check of the tile's footprint
against the coarse skip map, a Chebyshev leap over empty slabs, trilinear
samples (a plane lerp, then bilinear in the plane), the closed-form TF
(intensity, or modulated by the gradient map), the reference's opacity
correction ``vaf·(1-(1-a)^κ)`` and ERT at alpha > 0.99. The slab walk is a
function of the TILE (its covered rays' bounds), as in the TPU kernel, so
the sampled slabs, hence the sample counts and first-hit planes, are the
TPU kernel's. This is the frame's sweep when the brick sweep (K1) cannot
run: fewer slabs than voxel planes, or no brick rect in the plan.

* ``slab_inputs`` is the prologue of ``_sweep_pallas_jit`` (per-cell w
  slopes, slab range, κ, the coarse map, the occupied slab range and the
  launch scalars), plain PyTorch as the JAX package left it to XLA.
* ``sweep_slabs_kernel`` launches K7 (csrc/sweep_slabs.cu) for CUDA
  tensors and runs ``sweep_slabs_plain``, its plain version, for CPU
  tensors.
* ``sweep_slabs`` is the whole stage: inputs, K7, and the depth and
  sample-count epilogue.

What the TPU kernel does only for its memory system is dropped, because
it cannot change a result: the 256-lane rect DMA with its aligned bases
and padded extents (the plan sizes R so every covered sample lies inside
the rect, so reading texels directly is the same), the 4-deep prefetch
ring (its slab sequence is the same chain of ``next_valid`` calls) and the
separable tent matmul (the tent weights are non-zero on at most two rows:
it is the per-pixel bilinear sum); so the TPU kernel's rect height ``R``
is no argument here. ``separable`` takes each tile row's v coordinate
from the tile's first column, as the TPU's separable sampler does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..options import Test
from ..tf.transfer_function import TFParams
from ..utils import cuda_build
from .ray_setup import _SLICE_AXES, FrameUniforms, RaySetup, RenderOutput
from .sweep_bricks import CoarseMap, _f2i, _f32, mark_reads, occupied_slabs

TILE_H = 8
TILE_W = 128
_BIG = 1e30
_INV255 = float(np.float32(1.0 / 255.0))

LAUNCHES = {"sweep_slabs": 0}


def n_steps_max(dim_max: int, sampling_factor: float) -> float:
    """The reference's per-ray step budget floor(ceil(dim_max·√3)·sf), in
    float32, the sample-count colour's denominator."""
    f32 = np.float32
    return float(np.floor(np.ceil(f32(dim_max) * np.sqrt(f32(3.0)))
                          * f32(sampling_factor)))


@dataclasses.dataclass(frozen=True)
class SlabInputs:
    """Everything K7 reads: per-cell fields (H, W), the coarse leap map
    (mp, CVp, 128) u8, the transposed volume (Np, Sv, Su) u8, the gradient
    map transposed alike (gradient TFs, else None), ``meta`` (3,) int32 on
    the device (the occupied slab range and the sweep direction) and the
    launch scalars (the fields of ``SlabParams`` in csrc/sweep_slabs.cu)."""
    wu: torch.Tensor
    wv: torch.Tensor
    s_lo: torch.Tensor
    s_hi: torch.Tensor
    kappa: torch.Tensor
    cov: torch.Tensor          # bool
    coarse: torch.Tensor
    vol: torch.Tensor
    grad: torch.Tensor | None
    meta: torch.Tensor         # k_occ_lo, k_occ_hi, sgn
    params: dict


def slab_inputs(vol_t: torch.Tensor, occupancy_t: torch.Tensor, tf: TFParams,
                rays: RaySetup, uniforms: FrameUniforms,
                grad_t: torch.Tensor | None = None, *, p_axis: int, ert: bool,
                count_samples: bool, n_slabs: int, dist_leap: bool,
                separable: bool = False) -> SlabInputs:
    """K7's inputs: the prologue of ``_sweep_pallas_jit``. ``rays`` needs
    entry and exit (``frustum.rays_from_dirs``); ``grad_t`` is read only
    with a gradient TF."""
    H, W = rays.valid.shape
    if H % TILE_H or W % TILE_W:
        raise ValueError(f"{H}x{W} does not tile by {TILE_H}x{TILE_W}")
    if rays.entry is None or rays.exit is None:
        raise ValueError("the per-slab sweep needs the rays' entry and exit")
    Np, Sv, Su = vol_t.shape
    if Np < 2:
        raise ValueError(f"volume too shallow for the slab sweep: {Np}")
    use_gradient = grad_t is not None and bool(tf.use_gradient)
    if use_gradient and tuple(grad_t.shape) != (Np, Sv, Su):
        raise ValueError(f"grad_t {tuple(grad_t.shape)} != vol_t "
                         f"{(Np, Sv, Su)}")
    v_ax, u_ax = _SLICE_AXES[p_axis]
    o = np.asarray(uniforms.cam_pos_tex, np.float32)

    d = rays.ray_dir
    d_p = d[..., p_axis]
    sgn = torch.sign(torch.where(rays.valid, d_p, 0.0).sum())
    sgn = torch.where(sgn == 0.0, 1.0, sgn)
    safe_dp = torch.where(d_p.abs() < 1e-6,
                          torch.where(d_p < 0, -1e-6, 1e-6), d_p)
    wu = d[..., u_ax] / safe_dp
    wv = d[..., v_ax] / safe_dp
    s_a = rays.entry[..., p_axis]
    s_b = rays.exit[..., p_axis]
    covered = rays.valid & (d_p.abs() > 1e-6)
    ds = _f32(1.0 / n_slabs)
    kappa = _f32(np.float32(max(Np, Sv, Su)) * np.float32(ds)) / safe_dp.abs()

    cm = CoarseMap.build(occupancy_t, (Np, Sv, Su), dist_leap)
    ks, ne = occupied_slabs(occupancy_t, Np, n_slabs, cm.bp_p)
    meta = torch.stack([torch.where(ne, ks, n_slabs).amin(),
                        torch.where(ne, ks, -1).amax(),
                        sgn.to(ks.dtype)]).to(torch.int32)
    params = dict(
        Np=Np, Sv=Sv, Su=Su, H=H, W=W, bp_p=cm.bp_p, CV=cm.CV, CU=cm.CU,
        CVp=cm.CVp, mp=cm.mp, n_slabs=n_slabs, ert=int(bool(ert)),
        count_samples=int(bool(count_samples)),
        use_gradient=int(use_gradient), separable=int(bool(separable)),
        o_u=float(o[u_ax]), o_v=float(o[v_ax]), o_p=float(o[p_axis]), ds=ds,
        imin=tf.intensity_min, iinv=tf.intensity_range_inv,
        vaf=tf.voxel_alpha_factor, gmin=tf.gradient_min,
        ginv=tf.gradient_range_inv, **cm.scalars())
    f = torch.float32
    return SlabInputs(
        wu=wu.to(f).contiguous(), wv=wv.to(f).contiguous(),
        s_lo=torch.minimum(s_a, s_b).to(f).contiguous(),
        s_hi=torch.maximum(s_a, s_b).to(f).contiguous(),
        kappa=kappa.to(f).contiguous(), cov=covered.contiguous(),
        coarse=cm.pad(cm.pair()), vol=vol_t.contiguous(),
        grad=grad_t.contiguous() if use_gradient else None, meta=meta,
        params=params)


def sweep_slabs_plain(inp: SlabInputs, reads: dict | None = None):
    """Plain PyTorch version of K7: (lum, alpha, firsts, nsamp), each
    (H, W). Runs every tile in lock-step, each with its own slab walk and
    masks; the arithmetic is the kernel's, operation for operation.
    ``reads`` gets the sectors the samples need, as in
    ``sweep_bricks.sweep_bricks_reference``."""
    p = inp.params
    H, W = p["H"], p["W"]
    Np, Sv, Su, n_slabs = p["Np"], p["Sv"], p["Su"], p["n_slabs"]
    bp_p, CV, CU, CVp, mp = p["bp_p"], p["CV"], p["CU"], p["CVp"], p["mp"]
    ert, ds = bool(p["ert"]), p["ds"]
    o_u, o_v, o_p = p["o_u"], p["o_v"], p["o_p"]
    k_occ_lo, k_occ_hi, sgn = (int(v) for v in inp.meta.tolist())
    f32 = np.float32
    f = torch.float32
    dev = inp.vol.device
    nty, ntx = H // TILE_H, W // TILE_W
    T = nty * ntx

    def tiles(a):
        return (a.reshape(nty, TILE_H, ntx, TILE_W).permute(0, 2, 1, 3)
                .reshape(T, TILE_H, TILE_W))

    wu_t, wv_t = tiles(inp.wu), tiles(inp.wv)
    s_lo, s_hi, kap, cov = (tiles(inp.s_lo), tiles(inp.s_hi),
                            tiles(inp.kappa), tiles(inp.cov))
    # The v coordinate: per cell, or (separable) per tile row from the
    # tile's first column.
    wv_q = wv_t[:, :, :1] if p["separable"] else wv_t

    def cov_min(a):
        return torch.where(cov, a, _BIG).amin(dim=(1, 2))

    def cov_max(a):
        return torch.where(cov, a, -_BIG).amax(dim=(1, 2))

    s_lo_t, s_hi_t = cov_min(s_lo), cov_max(s_hi)
    wu_min, wu_max = cov_min(wu_t), cov_max(wu_t)
    wv_min, wv_max = cov_min(wv_t), cov_max(wv_t)
    any_cov = cov.reshape(T, -1).any(dim=1)

    k_a = _f2i(torch.floor(s_lo_t / ds - 0.5))
    k_b = _f2i(torch.ceil(s_hi_t / ds - 0.5))
    k_a = torch.clamp(torch.clamp(k_a, min=k_occ_lo), 0, n_slabs - 1)
    k_b = torch.clamp(torch.clamp(k_b, max=k_occ_hi), 0, n_slabs - 1)
    if sgn > 0:
        k_begin, k_end = k_a, k_b + 1
        in_range = lambda k: k < k_end
    else:
        k_begin, k_end = k_b, k_a - 1
        in_range = lambda k: k > k_end

    slab_s = lambda k: (k.to(f) + 0.5) * ds

    def k0_of(k):
        return _f2i(torch.floor(slab_s(k) * float(Np) - 0.5)).clamp(0, Np - 2)

    rate = torch.clamp(torch.maximum(
        torch.maximum(wu_min.abs(), wu_max.abs()) * p["drift_u"],
        torch.maximum(wv_min.abs(), wv_max.abs()) * p["drift_v"]), min=1.0)
    inv_dsNp = float(f32(1.0) / (f32(ds) * f32(Np)))
    # Slabs per two map planes along p (the pair-wide footprint).
    d_pair = int(np.ceil(f32(2.0) * f32(bp_p) / (f32(ds) * f32(Np))))

    def qu_bounds(k):
        t = slab_s(k) - o_p
        return ((o_u + torch.minimum(wu_min * t, wu_max * t)) * float(Su) - 0.5,
                (o_u + torch.maximum(wu_min * t, wu_max * t)) * float(Su) - 0.5,
                (o_v + torch.minimum(wv_min * t, wv_max * t)) * float(Sv) - 0.5,
                (o_v + torch.maximum(wv_min * t, wv_max * t)) * float(Sv) - 0.5)

    rows16 = torch.arange(16, device=dev)
    cols = torch.arange(TILE_W, device=dev)

    def window_min_d(k):
        """Min pooled map value over the tile's dilated footprint on slab
        k's map planes, the footprint being the union of slab k's and the
        slab two map planes ahead; 0 when the window is taller than the
        TPU kernel's 16-row view (conservatively occupied)."""
        kc = k.clamp(0, n_slabs - 1)
        k2 = (kc + sgn * d_pair).clamp(0, n_slabs - 1)
        a, b = qu_bounds(kc), qu_bounds(k2)
        qu_lo, qu_hi = torch.minimum(a[0], b[0]), torch.maximum(a[1], b[1])
        qv_lo, qv_hi = torch.minimum(a[2], b[2]), torch.maximum(a[3], b[3])
        m0 = (k0_of(kc) // bp_p).clamp(0, mp - 1)
        iv, iu = p["inv_cvox_v"], p["inv_cvox_u"]
        cv_lo = _f2i(torch.floor((qv_lo - 1.0) * iv)).clamp(0, CV - 1)
        cv_hi = _f2i(torch.floor((qv_hi + 2.0) * iv)).clamp(0, CV - 1)
        cu_lo = _f2i(torch.floor((qu_lo - 1.0) * iu)).clamp(0, CU - 1)
        cu_hi = _f2i(torch.floor((qu_hi + 2.0) * iu)).clamp(0, CU - 1)
        cv8 = ((cv_lo // 8) * 8).clamp(0, max(CVp - 16, 0))
        rows = cv8[:, None] + rows16[None, :]
        block = inp.coarse[m0[:, None, None], rows[:, :, None],
                           cols[None, None, :]]
        mask = (((rows >= cv_lo[:, None]) & (rows <= cv_hi[:, None]))[:, :, None]
                & ((cols[None, :] >= cu_lo[:, None])
                   & (cols[None, :] <= cu_hi[:, None]))[:, None, :])
        d = torch.where(mask, block.to(torch.int64), 255).amin(dim=(1, 2))
        return torch.where(cv_hi > cv8 + 15, 0, d)

    def leap_target(k, d):
        """The slab past the empty Chebyshev ball of radius d-1 around slab
        k's footprint (conservative: may land one slab short)."""
        P = _f2i(torch.floor((d.to(f) - 1.0) / rate))
        c0 = k0_of(k) // bp_p
        if sgn > 0:
            return torch.maximum(k + 1, _f2i(torch.floor(
                (((c0 + P + 1) * bp_p - 2).to(f) + 1.5) * inv_dsNp - 0.5)))
        return torch.minimum(k - 1, _f2i(torch.ceil(
            (((c0 - P) * bp_p).to(f) + 0.5) * inv_dsNp - 0.5)) - 1)

    def next_valid(k, todo):
        """First slab from k on (in sweep order) whose footprint holds an
        occupied map cell, leaping over empty space."""
        todo = todo & in_range(k)
        while bool(todo.any()):
            d = window_min_d(k)
            occupied = d == 0
            k = torch.where(todo & ~occupied, leap_target(k, d), k)
            todo = todo & ~occupied & in_range(k)
        return k

    lum = torch.zeros((T, TILE_H, TILE_W), dtype=f, device=dev)
    alpha = torch.zeros_like(lum)
    firsts = torch.full_like(lum, 2.0)
    nsamp = torch.zeros((T, TILE_H, TILE_W), dtype=torch.int32, device=dev)
    vol = inp.vol.reshape(-1)
    grad = inp.grad.reshape(-1) if p["use_gradient"] else None
    plane = Sv * Su

    def sample(k, sel, lum, alpha, firsts, nsamp):
        s = slab_s(k)
        t = (s - o_p)[:, None, None]
        zp = s * float(Np) - 0.5
        k0 = _f2i(torch.floor(zp)).clamp(0, Np - 2)
        fp = torch.clamp(zp - k0.to(f), 0.0, 1.0)[:, None, None]
        s3 = s[:, None, None]
        qu = (o_u + wu_t * t) * float(Su) - 0.5
        qv = torch.clamp((o_v + wv_q * t) * float(Sv) - 0.5, 0.0,
                         float(Sv) - 1.0).expand(T, TILE_H, TILE_W)
        flu = torch.floor(qu)
        iu0 = _f2i(flu).clamp(0, Su - 1)
        iu1 = (iu0 + 1).clamp(max=Su - 1)
        fu = torch.clamp(qu - flu, 0.0, 1.0)
        r0 = _f2i(torch.floor(qv)).clamp(0, Sv - 1)
        r1 = (r0 + 1).clamp(max=Sv - 1)
        w0 = torch.clamp(1.0 - (qv - r0.to(f)).abs(), min=0.0)
        w1 = torch.clamp(1.0 - (qv - (r0 + 1).to(f)).abs(), min=0.0)
        base = (k0 * plane)[:, None, None]

        def tap(src, r, iu):
            # The plane lerp of one texel pair, in float32.
            idx = base + r * Su + iu
            return src[idx].to(f) * (1.0 - fp) + src[idx + plane].to(f) * fp

        def bilinear(src):
            v00, v01 = tap(src, r0, iu0), tap(src, r0, iu1)
            v10, v11 = tap(src, r1, iu0), tap(src, r1, iu1)
            c0 = v00 + (v01 - v00) * fu
            c1 = v10 + (v11 - v10) * fu
            return (w0 * c0 + w1 * c1) * _INV255

        a_tf = torch.clamp((bilinear(vol) - p["imin"]) * p["iinv"], 0.0, 1.0)
        in_rng = cov & (s3 >= s_lo) & (s3 <= s_hi) & sel[:, None, None]
        if ert:
            in_rng = in_rng & (alpha <= 0.99)
        if reads is not None:
            idxs = [base + r * Su + iu for r in (r0, r1) for iu in (iu0, iu1)]
            mark_reads(reads["vol"], vol, idxs, in_rng, plane)
            if grad is not None:
                mark_reads(reads["grad"], grad, idxs, in_rng & (a_tf > 0.0),
                           plane)
        if grad is not None:
            a_tf = a_tf * torch.clamp((bilinear(grad) - p["gmin"]) * p["ginv"],
                                      0.0, 1.0)
        a_corr = torch.clamp(p["vaf"] * (1.0 - torch.pow(1.0 - a_tf, kap)),
                             0.0, 1.0)
        contrib = in_rng & (a_tf > 0.0)
        one_m = 1.0 - alpha
        lum = torch.where(contrib, lum + one_m * a_tf * a_corr, lum)
        new_alpha = torch.where(contrib, alpha + one_m * a_corr, alpha)
        hit = contrib & (a_corr > 0.0) & (firsts > 1.5)
        firsts = torch.where(hit, s3.expand_as(firsts), firsts)
        if ert:
            new_alpha = torch.where(contrib & (new_alpha > 0.99), 1.0,
                                    new_alpha)
        if p["count_samples"]:
            nsamp = nsamp + in_rng.to(torch.int32)
        return lum, new_alpha, firsts, nsamp

    k = next_valid(k_begin, any_cov)
    while True:
        active = any_cov & in_range(k)
        if ert:
            active = active & (cov & (alpha <= 0.99)).reshape(T, -1).any(dim=1)
        if not bool(active.any()):
            break
        s3 = slab_s(k)[:, None, None]
        work = cov & (s3 >= s_lo) & (s3 <= s_hi)
        if ert:
            work = work & (alpha <= 0.99)
        sel = active & work.reshape(T, -1).any(dim=1)
        if bool(sel.any()):
            lum, alpha, firsts, nsamp = sample(k, sel, lum, alpha, firsts,
                                               nsamp)
        k = torch.where(active, next_valid(k + sgn, active), k)

    def untile(a):
        return (a.reshape(nty, ntx, TILE_H, TILE_W).permute(0, 2, 1, 3)
                .reshape(H, W))

    return untile(lum), untile(alpha), untile(firsts), untile(nsamp)


def sweep_slabs_kernel(inp: SlabInputs):
    """K7: (lum, alpha, firsts, nsamp). CPU tensors run the plain version;
    CUDA tensors launch the kernel (or raise)."""
    if inp.vol.device.type == "cpu":
        return sweep_slabs_plain(inp)
    p = inp.params
    H, W = p["H"], p["W"]
    for name in ("wu", "wv", "s_lo", "s_hi", "kappa"):
        cuda_build.require_cuda(name, getattr(inp, name), torch.float32,
                                (H, W))
    cuda_build.require_cuda("cov", inp.cov, torch.bool, (H, W))
    cuda_build.require_cuda("coarse", inp.coarse, torch.uint8,
                            (p["mp"], p["CVp"], TILE_W))
    shape = (p["Np"], p["Sv"], p["Su"])
    cuda_build.require_cuda("vol", inp.vol, torch.uint8, shape)
    if p["use_gradient"]:
        cuda_build.require_cuda("grad", inp.grad, torch.uint8, shape)
    cuda_build.require_cuda("meta", inp.meta, torch.int32, (3,))
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
        inp.vol, grad, inp.meta, lum, alpha, firsts, nsamp)]
    cuda_build.check(lib.vkv_sweep_slabs(
        *ptrs, cuda_build.SlabParams(**p), cuda_build.stream()),
        "sweep_slabs")
    LAUNCHES["sweep_slabs"] += 1
    return lum, alpha, firsts, nsamp


def sweep_slabs(vol_t: torch.Tensor, occupancy_t: torch.Tensor, tf: TFParams,
                rays: RaySetup, uniforms: FrameUniforms, proj_view_model,
                grad_t: torch.Tensor | None = None, *, p_axis: int,
                ert: bool, test: Test = Test.NONE, count_samples: bool = False,
                n_slabs: int, separable: bool = False,
                dist_leap: bool = False) -> RenderOutput:
    """The per-slab sweep stage (``_sweep_pallas_jit``): ``vol_t`` and
    ``occupancy_t`` transposed for ``p_axis``; ``occupancy_t`` a Chebyshev
    distance map when ``dist_leap``, else an occupancy map (0 = occupied);
    ``proj_view_model`` the host (4, 4) float32 matrix for the first-hit
    depth."""
    num_test = test == Test.NUM_TEXTURE_SAMPLES
    inp = slab_inputs(vol_t, occupancy_t, tf, rays, uniforms, grad_t,
                      p_axis=p_axis, ert=ert,
                      count_samples=count_samples or num_test,
                      n_slabs=n_slabs, dist_leap=dist_leap,
                      separable=separable)
    lum, alpha, firsts, nsamp = sweep_slabs_kernel(inp)
    p = inp.params
    v_ax, u_ax = _SLICE_AXES[p_axis]
    H, W = lum.shape
    f = torch.float32
    dev = lum.device
    color = torch.stack([lum, lum, lum, alpha], -1)
    # Depth from the first contributing slab.
    hit = (alpha > 0.0) & (firsts < 1.5)
    t_hit = firsts - p["o_p"]
    pen_xyz = [None, None, None]
    pen_xyz[p_axis] = firsts
    pen_xyz[u_ax] = p["o_u"] + inp.wu * t_hit
    pen_xyz[v_ax] = p["o_v"] + inp.wv * t_hit
    pen = torch.stack(pen_xyz, -1) - 0.5
    pen_h = torch.cat([pen, torch.ones((H, W, 1), dtype=f, device=dev)], -1)
    pvm = torch.as_tensor(np.asarray(proj_view_model, np.float32), device=dev)
    pen_clip = pen_h @ pvm.T
    w = pen_clip[..., 3]
    pen_depth = pen_clip[..., 2] / torch.where(w == 0, 1.0, w)
    depth = torch.where(hit, pen_depth, rays.depth_init)
    if num_test:
        val = nsamp.to(f) / n_steps_max(max(vol_t.shape), tf.sampling_factor)
        color = torch.stack([val, val, val, torch.ones_like(val)], -1)
        color = torch.where(inp.cov[..., None], color, 0.0)
    zi = torch.zeros((H, W), dtype=torch.int32, device=dev)
    return RenderOutput(color=color, depth=depth, num_volume_samples=nsamp,
                        num_distance_samples=zi, num_empty_samples=zi,
                        iterations=n_slabs)
