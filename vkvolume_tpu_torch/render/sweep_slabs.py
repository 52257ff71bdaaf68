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
* ``sweep_slabs_kernel`` is K7 (csrc/sweep_slabs.cu) in two launches:
  ``slab_walk`` writes each tile's visited slabs to a list, and
  ``sweep_slabs_composite`` composites every pixel over its tile's list.
  For CPU tensors each runs its plain version (``slab_walk_plain``,
  ``sweep_slabs_composite_plain``). ``sweep_slabs_plain`` is the plain
  sweep with the two interleaved, as the TPU kernel runs them; the split
  changes no output bit.
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
from ..utils import cuda_build, timing
from .ray_setup import _SLICE_AXES, FrameUniforms, RaySetup, RenderOutput
from .sweep_bricks import (CoarseMap, TileLists, _composite_lists, _f2i,
                           _f32, _interleaved, _PlainTiles, _walk_lists,
                           count_passed, mark_reads, n_steps_max,
                           occupied_slabs, tile_lists, window_min)

TILE_H = 8
TILE_W = 128
_INV255 = float(np.float32(1.0 / 255.0))

LAUNCHES = {"sweep_slabs": 0, "slab_walk": 0}


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
    entry and exit (``ray_setup.rays_from_dirs``); ``grad_t`` is read only
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


class _PlainSlabs(_PlainTiles):
    """The plain version of K7 (candidates: slabs): the slab walk (the
    pair-wide footprint's coarse window, the leap) and the sampling of one
    slab."""

    def __init__(self, inp: SlabInputs, reads: dict | None = None):
        super().__init__(inp, TILE_H, reads)
        p = self.p
        k_occ_lo, k_occ_hi, self.sgn = (int(v) for v in inp.meta.tolist())
        # The v coordinate: per cell, or (separable) per tile row from the
        # tile's first column.
        self.wv_q = self.wv_t[:, :, :1] if p["separable"] else self.wv_t
        self.cap = n_slabs = self.n_slabs
        ds = p["ds"]
        k_a = _f2i(torch.floor(self.s_lo_t / ds - 0.5))
        k_b = _f2i(torch.ceil(self.s_hi_t / ds - 0.5))
        self.span(torch.clamp(torch.clamp(k_a, min=k_occ_lo), 0, n_slabs - 1),
                  torch.clamp(torch.clamp(k_b, max=k_occ_hi), 0, n_slabs - 1))
        # Slabs per two map planes along p (the pair-wide footprint).
        f32 = np.float32
        self.d_pair = int(np.ceil(f32(2.0) * f32(p["bp_p"])
                                  / (f32(ds) * f32(p["Np"]))))

    def k0_of(self, k):
        Np = self.p["Np"]
        return _f2i(torch.floor(self.slab_s(k) * float(Np) - 0.5)).clamp(
            0, Np - 2)

    def qu_bounds(self, k):
        p = self.p
        o_u, o_v, Su, Sv = p["o_u"], p["o_v"], float(p["Su"]), float(p["Sv"])
        t = self.slab_s(k) - p["o_p"]
        wu_min, wu_max, wv_min, wv_max = (self.wu_min, self.wu_max,
                                          self.wv_min, self.wv_max)
        return ((o_u + torch.minimum(wu_min * t, wu_max * t)) * Su - 0.5,
                (o_u + torch.maximum(wu_min * t, wu_max * t)) * Su - 0.5,
                (o_v + torch.minimum(wv_min * t, wv_max * t)) * Sv - 0.5,
                (o_v + torch.maximum(wv_min * t, wv_max * t)) * Sv - 0.5)

    def window_min_d(self, k, seen=None):
        """Min pooled map value over each tile's dilated footprint on slab
        k's map planes, the footprint being the union of slab k's and the
        slab two map planes ahead; 0 when the window is taller than the
        TPU kernel's 16-row view (conservatively occupied). ``seen``: as in
        ``sweep_bricks.window_min``."""
        n_slabs = self.n_slabs
        kc = k.clamp(0, n_slabs - 1)
        k2 = (kc + self.sgn * self.d_pair).clamp(0, n_slabs - 1)
        a, b = self.qu_bounds(kc), self.qu_bounds(k2)
        m0 = (self.k0_of(kc) // self.p["bp_p"]).clamp(0, self.p["mp"] - 1)
        return window_min(self.p, self.inp.coarse, m0,
                          torch.minimum(a[0], b[0]), torch.maximum(a[1], b[1]),
                          torch.minimum(a[2], b[2]), torch.maximum(a[3], b[3]),
                          self.rows16, self.cols, seen)

    def leap_target(self, k, d):
        """The slab past the empty Chebyshev ball of radius d-1 around slab
        k's footprint (conservative: may land one slab short)."""
        f = torch.float32
        bp_p, inv_dsNp = self.p["bp_p"], self.inv_dsNp
        P = _f2i(torch.floor((d.to(f) - 1.0) / self.rate))
        c0 = self.k0_of(k) // bp_p
        if self.sgn > 0:
            return torch.maximum(k + 1, _f2i(torch.floor(
                (((c0 + P + 1) * bp_p - 2).to(f) + 1.5) * inv_dsNp - 0.5)))
        return torch.minimum(k - 1, _f2i(torch.ceil(
            (((c0 - P) * bp_p).to(f) + 0.5) * inv_dsNp - 0.5)) - 1)

    def probe(self, k, todo=None, stats: dict | None = None):
        """(occupied footprint, the leap's target) of slab k of each tile;
        ``stats`` counts the window of each ``todo`` tile."""
        d = self.window_min_d(
            k, None if stats is None else (stats, "coarse", todo))
        return d == 0, self.leap_target(k, d)

    def work(self, k, alpha):
        """Tiles with a pixel that samples slab k."""
        s3 = self.slab_s(k)[:, None, None]
        work = self.cov & (s3 >= self.s_lo) & (s3 <= self.s_hi)
        if self.ert:
            work = work & (alpha <= 0.99)
        return work.reshape(self.T, -1).any(dim=1)

    def sample(self, k, sel, state):
        """Composites slab k of each ``sel`` tile into ``state``."""
        lum, alpha, firsts, nsamp = state
        p, inp, reads = self.p, self.inp, self.reads
        Np, Sv, Su = p["Np"], p["Sv"], p["Su"]
        o_u, o_v, o_p = p["o_u"], p["o_v"], p["o_p"]
        cov, s_lo, s_hi, kap = self.cov, self.s_lo, self.s_hi, self.kap
        T = self.T
        f = torch.float32
        vol = inp.vol.reshape(-1)
        grad = inp.grad.reshape(-1) if p["use_gradient"] else None
        plane = Sv * Su
        s = self.slab_s(k)
        t = (s - o_p)[:, None, None]
        zp = s * float(Np) - 0.5
        k0 = _f2i(torch.floor(zp)).clamp(0, Np - 2)
        fp = torch.clamp(zp - k0.to(f), 0.0, 1.0)[:, None, None]
        s3 = s[:, None, None]
        qu = (o_u + self.wu_t * t) * float(Su) - 0.5
        qv = torch.clamp((o_v + self.wv_q * t) * float(Sv) - 0.5, 0.0,
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

        a_int = torch.clamp((bilinear(vol) - p["imin"]) * p["iinv"], 0.0,
                            1.0)
        a_tf = a_int
        in_rng = cov & (s3 >= s_lo) & (s3 <= s_hi) & sel[:, None, None]
        if self.ert:
            in_rng = in_rng & (alpha <= 0.99)
        if reads is not None:
            idxs = [base + r * Su + iu for r in (r0, r1) for iu in (iu0, iu1)]
            mark_reads(reads["vol"], vol, idxs, in_rng, plane)
            if grad is not None:
                mark_reads(reads["grad"], grad, idxs, in_rng & (a_int > 0.0),
                           plane)
        if grad is not None:
            a_tf = a_tf * torch.clamp((bilinear(grad) - p["gmin"]) * p["ginv"],
                                      0.0, 1.0)
        a_corr = torch.clamp(p["vaf"] * (1.0 - torch.pow(1.0 - a_tf, kap)),
                             0.0, 1.0)
        contrib = in_rng & (a_tf > 0.0)
        count_passed(reads, in_rng & (a_int > 0.0), contrib)
        one_m = 1.0 - alpha
        lum = torch.where(contrib, lum + one_m * a_tf * a_corr, lum)
        new_alpha = torch.where(contrib, alpha + one_m * a_corr, alpha)
        hit = contrib & (a_corr > 0.0) & (firsts > 1.5)
        firsts = torch.where(hit, s3.expand_as(firsts), firsts)
        if self.ert:
            new_alpha = torch.where(contrib & (new_alpha > 0.99), 1.0,
                                    new_alpha)
        if p["count_samples"]:
            nsamp = nsamp + in_rng.to(torch.int32)
        return lum, new_alpha, firsts, nsamp


def sweep_slabs_plain(inp: SlabInputs, reads: dict | None = None):
    """Plain PyTorch version of K7 with its walk and compositing
    interleaved, as the TPU kernel runs them
    (``sweep_bricks._interleaved``): (lum, alpha, firsts, nsamp), each
    (H, W). The independent check of the split that K7 runs (``slab_walk``
    + ``sweep_slabs_composite``). ``reads`` gets the sectors the samples
    need, as in ``sweep_bricks.sweep_bricks_reference``."""
    return _interleaved(_PlainSlabs(inp, reads))


def slab_walk_plain(inp: SlabInputs, stats: dict | None = None) -> TileLists:
    """Plain version of K7's walk: each tile's visited slabs in sweep
    order. ``stats`` (``sweep_bricks.note_windows``; a sector map under
    "coarse"): the windows the walk reduces, one per step."""
    return _walk_lists(_PlainSlabs(inp), stats)


def sweep_slabs_composite_plain(inp: SlabInputs, walk: TileLists):
    """Plain version of K7's compositing over a walk's lists: (lum, alpha,
    firsts, nsamp), each (H, W)."""
    return _composite_lists(_PlainSlabs(inp), walk)


def _require_fields(inp: SlabInputs, names) -> None:
    p = inp.params
    for name in names:
        cuda_build.require_cuda(name, getattr(inp, name), torch.float32,
                                (p["H"], p["W"]))
    cuda_build.require_cuda("cov", inp.cov, torch.bool, (p["H"], p["W"]))
    cuda_build.require_cuda("meta", inp.meta, torch.int32, (3,))


def slab_walk(inp: SlabInputs) -> TileLists:
    """K7's walk: each tile's visited slabs. CPU tensors run the plain
    version; CUDA tensors launch the kernel (or raise)."""
    if inp.vol.device.type == "cpu":
        return slab_walk_plain(inp)
    p = inp.params
    _require_fields(inp, ("wu", "wv", "s_lo", "s_hi"))
    cuda_build.require_cuda("coarse", inp.coarse, torch.uint8,
                            (p["mp"], p["CVp"], TILE_W))
    cuda_build.require_aligned("coarse", inp.coarse, 4)
    lists = tile_lists(p["H"] // TILE_H * (p["W"] // TILE_W), p["n_slabs"],
                       inp.vol.device)
    ptrs = [t.data_ptr() for t in (inp.wu, inp.wv, inp.s_lo, inp.s_hi,
                                   inp.cov, inp.coarse, inp.meta, lists.cnt,
                                   lists.lst)]
    with timing.kernel(LAUNCHES, "slab_walk"):
        cuda_build.check(cuda_build.load_kernels().vkv_slab_walk(
            *ptrs, cuda_build.SlabParams(**p), cuda_build.stream()),
            "slab_walk")
    return lists


def sweep_slabs_composite(inp: SlabInputs, walk: TileLists):
    """K7's compositing over the walk's lists: (lum, alpha, firsts,
    nsamp). CPU tensors run the plain version; CUDA tensors launch the
    kernel (or raise)."""
    if inp.vol.device.type == "cpu":
        return sweep_slabs_composite_plain(inp, walk)
    p = inp.params
    H, W = p["H"], p["W"]
    _require_fields(inp, ("wu", "wv", "s_lo", "s_hi", "kappa"))
    shape = (p["Np"], p["Sv"], p["Su"])
    cuda_build.require_cuda("vol", inp.vol, torch.uint8, shape)
    if p["use_gradient"]:
        cuda_build.require_cuda("grad", inp.grad, torch.uint8, shape)
    n_tiles = H // TILE_H * (W // TILE_W)
    cuda_build.require_cuda("cnt", walk.cnt, torch.int32, (n_tiles,))
    cuda_build.require_cuda("lst", walk.lst, torch.int16,
                            (n_tiles, p["n_slabs"]))
    dev = inp.vol.device
    lum = torch.empty((H, W), dtype=torch.float32, device=dev)
    alpha = torch.empty_like(lum)
    firsts = torch.empty_like(lum)
    nsamp = torch.empty((H, W), dtype=torch.int32, device=dev)
    # Without a gradient TF the kernel never reads ``grad``.
    grad = inp.grad if p["use_gradient"] else inp.vol
    ptrs = [t.data_ptr() for t in (
        inp.wu, inp.wv, inp.s_lo, inp.s_hi, inp.kappa, inp.cov, inp.vol,
        grad, inp.meta, walk.cnt, walk.lst, lum, alpha, firsts, nsamp)]
    with timing.kernel(LAUNCHES, "sweep_slabs"):
        cuda_build.check(cuda_build.load_kernels().vkv_sweep_slabs(
            *ptrs, cuda_build.SlabParams(**p), cuda_build.stream()),
            "sweep_slabs")
    return lum, alpha, firsts, nsamp


def sweep_slabs_kernel(inp: SlabInputs):
    """K7: the walk, then the compositing over its lists: (lum, alpha,
    firsts, nsamp). CPU tensors run the plain versions; CUDA tensors
    launch the kernels (or raise)."""
    return sweep_slabs_composite(inp, slab_walk(inp))


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
    pen_h = torch.cat([pen, torch.ones((H, W, 1), dtype=f, device=dev)],
                      -1)
    pvm = torch.as_tensor(np.asarray(proj_view_model, np.float32),
                          device=dev)
    pen_clip = pen_h @ pvm.T
    w = pen_clip[..., 3]
    pen_depth = pen_clip[..., 2] / torch.where(w == 0, 1.0, w)
    depth = torch.where(hit, pen_depth, rays.depth_init)
    if num_test:
        val = nsamp.to(f) / n_steps_max(max(vol_t.shape),
                                        tf.sampling_factor)
        color = torch.stack([val, val, val, torch.ones_like(val)], -1)
        color = torch.where(inp.cov[..., None], color, 0.0)
    zi = torch.zeros((H, W), dtype=torch.int32, device=dev)
    return RenderOutput(color=color, depth=depth, num_volume_samples=nsamp,
                        num_distance_samples=zi, num_empty_samples=zi,
                        iterations=n_slabs)
