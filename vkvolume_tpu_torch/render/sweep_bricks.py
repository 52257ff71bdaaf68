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
* ``sweep_bricks_kernel`` is K1 (csrc/sweep_bricks.cu) in two launches:
  ``brick_walk`` writes each tile's visited bricks to a list, and
  ``sweep_bricks_composite`` composites every pixel over its tile's list.
  For CPU tensors each runs its plain version (``brick_walk_plain``,
  ``sweep_bricks_composite_plain``). ``sweep_bricks_reference`` is the
  plain sweep with the two interleaved, as the TPU kernel runs them: the
  split changes no output bit, because a tile's walk never depends on its
  pixels' state.
* ``sweep_bricks`` is the whole stage: inputs, K1, and the colour / depth
  epilogue (``first_hit_depth``), for the volume-sharded sweep
  (``parallel.sweep_volume_sharded``); the w-grid frame runs the parts.

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
sampled by the same taps), and either TF as the closed form or through the
baked TF texture (``texture_tf``, the TRANSFER_FUNCTION_TEXTURE variant,
``sweep_bricks.py:456-484`` of the JAX package): since the texture is the
baked quantised closed form, its NEAREST lookup is the closed form at the
quantised texel of each axis (``texel_alpha``), multiplied and truncated
to u8/255 (``truncate_alpha``); no 2-D gather.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..tf.transfer_function import TFParams, texel_alpha, truncate_alpha
from ..utils import cuda_build, timing
from .ray_setup import _SLICE_AXES, FrameUniforms, RenderOutput

TILE_W = 128
BRICK = 8          # slabs per brick
TILE_HS = (8, 16, 32)
_BIG = 1e30
_INV255 = float(np.float32(1.0 / 255.0))
_INV256 = 1.0 / 256.0

LAUNCHES = {"sweep_bricks": 0, "sweep_bricks_texture": 0, "brick_walk": 0}


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
    ``BrickParams`` in csrc/sweep_bricks.cu; ``texture_tf`` selects the
    texture-TF variant)."""
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


def n_steps_max(dim_max: int, sampling_factor: float) -> float:
    """The reference's per-ray step budget floor(ceil(dim_max·√3)·sf), in
    float32, the sample-count colour's denominator."""
    f32 = np.float32
    return float(np.floor(np.ceil(f32(dim_max) * np.sqrt(f32(3.0)))
                          * f32(sampling_factor)))


@dataclasses.dataclass(frozen=True)
class CoarseMap:
    """The coarse 2-D skip map both sweeps read (K1 and K7; as
    ``_sweep_bricks_jit`` and ``_sweep_pallas_jit`` build it): the
    (mp, mv, mu) map pooled by MIN into cells of at least 8 voxels along v
    and at most 128 columns along u, so that one (16, 128) window covers a
    tile's footprint. 0 = occupied; with ``dist_leap`` the values are
    Chebyshev distances (multi-plane leaps), else clamped to {0, 1}."""
    coarse: torch.Tensor       # (mp, CV, CU), the map's dtype
    mp: int
    CV: int
    CU: int
    CVp: int                   # rows padded: >= 16, a multiple of 8
    bp_p: int                  # voxels per map cell along p, v, u
    bp_v: int
    bp_u: int
    factor_v: int              # map cells per coarse cell along v, u
    factor_u: int
    Np: int
    Sv: int
    Su: int

    @classmethod
    def build(cls, occupancy_t: torch.Tensor, vol_shape, dist_leap: bool):
        Np, Sv, Su = vol_shape
        mp, mv, mu = occupancy_t.shape
        bp_v = -(-Sv // mv)
        bp_u = -(-Su // mu)
        factor_v = max(1, -(-8 // bp_v))
        factor_u = max(-(-mu // 128), max(1, -(-8 // bp_u)))
        CV = -(-mv // factor_v)
        CU = -(-mu // factor_u)
        dmap = occupancy_t if dist_leap else torch.clamp(occupancy_t, max=1)
        dmap_pad = torch.nn.functional.pad(
            dmap, (0, CU * factor_u - mu, 0, CV * factor_v - mv), value=255)
        coarse = dmap_pad.reshape(mp, CV, factor_v, CU, factor_u).amin(
            dim=(2, 4))
        return cls(coarse=coarse, mp=mp, CV=CV, CU=CU,
                   CVp=max(16, -(-CV // 8) * 8), bp_p=-(-Np // mp),
                   bp_v=bp_v, bp_u=bp_u, factor_v=factor_v,
                   factor_u=factor_u, Np=Np, Sv=Sv, Su=Su)

    def pair(self) -> torch.Tensor:
        """The leap map: pre-min'd with the next plane (a slab between
        voxel planes reads map planes m and m + 1)."""
        c = self.coarse
        return torch.minimum(c, torch.cat([c[1:], c[-1:]]))

    def pad(self, a: torch.Tensor) -> torch.Tensor:
        """(mp, CV, CU) → the kernels' (mp, CVp, 128) u8, padded with 255."""
        return torch.nn.functional.pad(
            a, (0, TILE_W - self.CU, 0, self.CVp - self.CV),
            value=255).to(torch.uint8).contiguous()

    def scalars(self) -> dict:
        """The window and leap-rate launch scalars (float32 values)."""
        return dict(
            inv_cvox_v=_f32(1.0 / (self.factor_v * self.bp_v)),
            inv_cvox_u=_f32(1.0 / (self.factor_u * self.bp_u)),
            # map cells drifted per map plane at |w| = 1
            drift_u=_f32(self.Su * self.bp_p / (self.Np * self.bp_u)),
            drift_v=_f32(self.Sv * self.bp_p / (self.Np * self.bp_v)))


def occupied_slabs(occupancy_t: torch.Tensor, Np: int, n_slabs: int,
                   bp_p: int):
    """(ks, ne): the slab indices and whether slab k's map planes hold an
    occupied cell (slabs outside the occupied range are empty for every
    tile)."""
    mp = occupancy_t.shape[0]
    ds = _f32(1.0 / n_slabs)
    nonempty_m = (occupancy_t == 0).any(dim=2).any(dim=1)
    ks = torch.arange(n_slabs, device=occupancy_t.device)
    zps = (ks.to(torch.float32) + 0.5) * ds * Np - 0.5
    k0s = torch.floor(zps).to(torch.int64).clamp(0, Np - 2)
    ne = (nonempty_m[(k0s // bp_p).clamp(0, mp - 1)]
          | nonempty_m[((k0s + 1) // bp_p).clamp(0, mp - 1)])
    return ks, ne


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
                 grad_t: torch.Tensor | None = None,
                 texture_tf: bool = False) -> BrickInputs:
    """K1's inputs: the prologue of ``_sweep_bricks_jit`` (coarse leap map,
    tight skip map, occupied brick range, launch scalars). ``grad_t``: the
    gradient map transposed like ``vol_t``, required by a gradient TF;
    ``texture_tf``: the TF through the baked texture."""
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

    cm = CoarseMap.build(occupancy_t, (Np, Sv, Su), dist_leap)
    mp, CV, CU, CVp, bp_p = cm.mp, cm.CV, cm.CU, cm.CVp, cm.bp_p

    # Tight skip map: cskip[m] == 0 iff an occupied cell lies in map planes
    # [m, m + mp_span] (the plane span one brick covers).
    mp_span = -(-(PLANES - 1) // bp_p)
    cbin = torch.clamp(cm.coarse, max=1)
    cskip = cbin
    for s in range(1, mp_span + 1):
        fill = torch.full((min(s, mp), CV, CU), 255, dtype=cbin.dtype,
                          device=dev)
        cskip = torch.minimum(cskip, torch.cat([cbin[s:], fill])[:mp])

    # Globally occupied brick range.
    ds = _f32(1.0 / n_slabs)
    n_bricks = -(-n_slabs // BRICK)
    ks, ne = occupied_slabs(occupancy_t, Np, n_slabs, bp_p)
    kb_i = ks // BRICK
    kb_occ = torch.stack([
        torch.where(ne, kb_i, n_bricks).amin(),
        torch.where(ne, kb_i, -1).amax()]).to(torch.int32)

    params = dict(
        Np=Np, Sv=Sv, Su=Su, H=H, W=W, tile_h=tile_h, bp_p=bp_p, CV=CV,
        CU=CU, CVp=CVp, mp=mp, n_slabs=n_slabs, sgn=1 if sgn > 0 else -1,
        ert=int(bool(ert)), count_samples=int(bool(count_samples)),
        aligned=int(n_slabs == Np), use_gradient=int(use_gradient),
        texture_tf=int(bool(texture_tf)), o_u=float(o[u_ax]),
        o_v=float(o[v_ax]), o_p=float(o[p_axis]), ds=ds,
        imin=tf.intensity_min, iinv=tf.intensity_range_inv,
        vaf=tf.voxel_alpha_factor,
        gmin=tf.gradient_min, ginv=tf.gradient_range_inv, **cm.scalars())
    f = torch.float32
    return BrickInputs(
        wu=wu.to(f).contiguous(), wv=wv.to(f).contiguous(),
        s_lo=s_lo.to(f).contiguous(), s_hi=s_hi.to(f).contiguous(),
        kappa=kappa.to(f).contiguous(), cov=covered.contiguous(),
        coarse=cm.pad(cm.pair()), cskip=cm.pad(cskip),
        vol=vol_t.contiguous(),
        grad=grad_t.contiguous() if use_gradient else None, kb_occ=kb_occ,
        params=params)


def _f2i(x: torch.Tensor) -> torch.Tensor:
    """float → int64 of an already floored/ceiled value, clamped like the
    kernel's f2i (only absurd values are affected)."""
    return x.clamp(-1e9, 1e9).to(torch.int64)


def sector_map(t: torch.Tensor) -> torch.Tensor:
    """One flag per 32-byte sector of ``t``'s storage (``reads`` below)."""
    n = t.numel() * t.element_size()
    return torch.zeros(-(-n // 32), dtype=torch.bool, device=t.device)


def mark_reads(sectors: torch.Tensor, src: torch.Tensor, idxs, need,
               plane: int) -> None:
    """Flags the sectors of the texels at each of ``idxs`` (and one plane
    on, where ``plane``) that a sample under mask ``need`` reads."""
    for idx in idxs:
        i = torch.broadcast_to(idx, need.shape)[need] * src.element_size()
        sectors[i // 32] = True
        if plane:
            sectors[(i + plane * src.element_size()) // 32] = True


@dataclasses.dataclass(frozen=True)
class TileLists:
    """What a sweep's walk hands its composite: for every tile (row-major
    over the grid of tiles) the number of bricks (K1) or slabs (K7) it
    visits, ``cnt`` (T,) int32, and their indices in sweep order, ``lst``
    (T, cap) int16 (entries past ``cnt`` are undefined)."""
    cnt: torch.Tensor
    lst: torch.Tensor

    def entries(self) -> torch.Tensor:
        """The defined entries, tile after tile (for comparing two walks)."""
        cap = self.lst.shape[1]
        keep = (torch.arange(cap, device=self.lst.device)[None, :]
                < self.cnt.to(torch.int64)[:, None])
        return self.lst[keep]


class _PlainTiles:
    """What the two plain sweeps (K1, K7) share, vectorised over tiles: the
    inputs cut into ``th`` × 128 tiles, each tile's covered rays' reduced
    bounds and leap rate, its walk range over candidates (bricks or slabs)
    and ``next_valid`` over a subclass's ``probe``, and the compositing
    state. The arithmetic is the kernels', operation for operation.
    ``reads``: see ``sweep_bricks_reference``."""

    def __init__(self, inp, th: int, reads: dict | None = None):
        self.inp, self.reads = inp, reads
        self.p = p = inp.params
        self.n_slabs, self.ert = p["n_slabs"], bool(p["ert"])
        nty, ntx = p["H"] // th, p["W"] // TILE_W
        self.shape, self.T = (nty, ntx, th), nty * ntx

        def tiles(a):
            return (a.reshape(nty, th, ntx, TILE_W).permute(0, 2, 1, 3)
                    .reshape(self.T, th, TILE_W))

        self.wu_t, self.wv_t = tiles(inp.wu), tiles(inp.wv)
        self.s_lo, self.s_hi, self.kap, self.cov = (
            tiles(inp.s_lo), tiles(inp.s_hi), tiles(inp.kappa),
            tiles(inp.cov))
        cov = self.cov

        def cov_min(a):
            return torch.where(cov, a, _BIG).amin(dim=(1, 2))

        def cov_max(a):
            return torch.where(cov, a, -_BIG).amax(dim=(1, 2))

        self.s_lo_t, self.s_hi_t = cov_min(self.s_lo), cov_max(self.s_hi)
        self.wu_min, self.wu_max = cov_min(self.wu_t), cov_max(self.wu_t)
        self.wv_min, self.wv_max = cov_min(self.wv_t), cov_max(self.wv_t)
        self.any_cov = cov.reshape(self.T, -1).any(dim=1)
        self.rate = torch.clamp(torch.maximum(
            torch.maximum(self.wu_min.abs(), self.wu_max.abs())
            * p["drift_u"],
            torch.maximum(self.wv_min.abs(), self.wv_max.abs())
            * p["drift_v"]), min=1.0)
        f32 = np.float32
        self.inv_dsNp = float(f32(1.0) / (f32(p["ds"]) * f32(p["Np"])))
        dev = inp.vol.device
        self.rows16 = torch.arange(16, device=dev)
        self.cols = torch.arange(TILE_W, device=dev)

    def span(self, lo, hi) -> None:
        """Each tile walks candidates lo..hi in sweep order (self.sgn)."""
        if self.sgn > 0:
            self.begin, self.end = lo, hi + 1
        else:
            self.begin, self.end = hi, lo - 1

    def in_range(self, k):
        return k < self.end if self.sgn > 0 else k > self.end

    def slab_s(self, k):
        return (k.to(torch.float32) + 0.5) * self.p["ds"]

    def next_valid(self, k, todo, stats: dict | None = None):
        """First candidate at or after k (in sweep order) of each ``todo``
        tile whose window holds an occupied cell, leaping over empty space.
        ``stats`` adds up the windows the walk reduces (``note_windows``)."""
        todo = todo & self.in_range(k)
        while bool(todo.any()):
            occupied, target = self.probe(k, todo, stats)
            leap = todo & ~occupied
            k = torch.where(leap, target, k)
            todo = leap & self.in_range(k)
        return k

    def start(self):
        """Zero state: (lum, alpha, firsts, nsamp), tiled."""
        T, th = self.T, self.shape[2]
        dev = self.inp.vol.device
        lum = torch.zeros((T, th, TILE_W), dtype=torch.float32, device=dev)
        return (lum, torch.zeros_like(lum), torch.full_like(lum, 2.0),
                torch.zeros((T, th, TILE_W), dtype=torch.int32, device=dev))

    def live(self, alpha):
        """Tiles with a covered pixel that can still take a sample."""
        return (self.cov & (alpha <= 0.99)).reshape(self.T, -1).any(dim=1)

    def finish(self, state):
        """The state untiled: (lum, alpha, firsts, nsamp), each (H, W)."""
        nty, ntx, th = self.shape
        return tuple(a.reshape(nty, ntx, th, TILE_W).permute(0, 2, 1, 3)
                     .reshape(nty * th, ntx * TILE_W) for a in state)


def _interleaved(w: _PlainTiles):
    """A plain sweep with walk and compositing interleaved, as the TPU
    kernels run them: every tile in lock-step, a tile leaving the walk when
    none of its covered pixels can take another sample (ERT) and skipping
    a candidate none of its pixels samples."""
    state = w.start()
    k = w.next_valid(w.begin, w.any_cov)
    while True:
        active = w.any_cov & w.in_range(k)
        if w.ert:
            active = active & w.live(state[1])
        if not bool(active.any()):
            break
        sel = active & w.work(k, state[1])
        if bool(sel.any()):
            state = w.sample(k, sel, state)
        k = torch.where(active, w.next_valid(k + w.sgn, active), k)
    return w.finish(state)


def _walk_lists(w: _PlainTiles, stats: dict | None) -> TileLists:
    """A plain walk: each tile's visited candidates in sweep order (every
    one the walk lands on in its range, whatever the pixels' opacity)."""
    dev = w.inp.vol.device
    lst = torch.zeros((w.T, w.cap), dtype=torch.int16, device=dev)
    n = torch.zeros(w.T, dtype=torch.int64, device=dev)
    k = w.next_valid(w.begin, w.any_cov, stats)
    while True:
        active = w.any_cov & w.in_range(k)
        if not bool(active.any()):
            return TileLists(cnt=n.to(torch.int32), lst=lst)
        rows = active.nonzero()[:, 0]
        lst[rows, n[rows]] = k[rows].to(torch.int16)
        n = n + active.to(torch.int64)
        k = torch.where(active, w.next_valid(k + w.sgn, active, stats), k)


def _composite_lists(w: _PlainTiles, walk: TileLists):
    """A plain composite over a walk's lists: entry i of every tile in
    lock-step."""
    state = w.start()
    cnt = walk.cnt.to(torch.int64)
    for i in range(int(cnt.max()) if w.T else 0):
        if w.ert and not bool(w.live(state[1]).any()):
            break
        listed = i < cnt
        k = torch.where(listed, walk.lst[:, i].to(torch.int64), 0)
        sel = listed & w.work(k, state[1])
        if bool(sel.any()):
            state = w.sample(k, sel, state)
    return w.finish(state)


class _PlainBricks(_PlainTiles):
    """The plain version of K1 (candidates: 8-slab bricks): the brick walk
    (tight cskip window, then the coarse window's leap) and the sampling of
    one brick."""

    def __init__(self, inp: BrickInputs, reads: dict | None = None):
        super().__init__(inp, inp.params["tile_h"], reads)
        p = self.p
        self.sgn = p["sgn"]
        self.aligned = bool(p["aligned"])
        self.use_gradient = bool(p["use_gradient"])
        self.texture_tf = bool(p["texture_tf"])
        self.wu_c = self.wu_t[:, 0, :]   # the u math uses tile row 0
        self.wv_r = self.wv_t[:, :, 0]   # the v math uses tile column 0
        self.cap = n_bricks = -(-self.n_slabs // BRICK)
        ds = p["ds"]
        kb_occ_lo, kb_occ_hi = (int(v) for v in inp.kb_occ.tolist())
        k_a = _f2i(torch.floor(self.s_lo_t / ds - 0.5))
        k_b = _f2i(torch.ceil(self.s_hi_t / ds - 0.5))
        self.span(
            torch.clamp(torch.clamp(k_a // BRICK, min=kb_occ_lo), 0,
                        n_bricks - 1),
            torch.clamp(torch.clamp(k_b // BRICK, max=kb_occ_hi), 0,
                        n_bricks - 1))
        f32 = np.float32
        self.d_pair = int(np.ceil(f32(2.0) * f32(p["bp_p"])
                                  * f32(self.inv_dsNp)))

    def k0_of(self, k):
        Np = self.p["Np"]
        if self.aligned:
            return k.clamp(0, Np - 2)
        return _f2i(torch.floor(self.slab_s(k) * float(Np) - 0.5)).clamp(
            0, Np - 2)

    def qu_bounds2(self, k1, k2):
        p = self.p
        t1 = self.slab_s(k1) - p["o_p"]
        t2 = self.slab_s(k2) - p["o_p"]
        wu_min, wu_max, wv_min, wv_max = (self.wu_min, self.wu_max,
                                          self.wv_min, self.wv_max)
        a1, b1, a2, b2 = wu_min * t1, wu_max * t1, wu_min * t2, wu_max * t2
        c1, e1, c2, e2 = wv_min * t1, wv_max * t1, wv_min * t2, wv_max * t2
        ulo = torch.minimum(torch.minimum(a1, b1), torch.minimum(a2, b2))
        uhi = torch.maximum(torch.maximum(a1, b1), torch.maximum(a2, b2))
        vlo = torch.minimum(torch.minimum(c1, e1), torch.minimum(c2, e2))
        vhi = torch.maximum(torch.maximum(c1, e1), torch.maximum(c2, e2))
        return ((p["o_u"] + ulo) * float(p["Su"]) - 0.5,
                (p["o_u"] + uhi) * float(p["Su"]) - 0.5,
                (p["o_v"] + vlo) * float(p["Sv"]) - 0.5,
                (p["o_v"] + vhi) * float(p["Sv"]) - 0.5)

    def brick_window(self, kb, todo=None, stats: dict | None = None):
        """(occupied by the tight window, leap distance of the coarse
        window) of brick kb of each tile. ``stats`` counts the tight window
        of each ``todo`` tile and the coarse window of each that leaps."""
        n_slabs, d_pair, bp_p = self.n_slabs, self.d_pair, self.p["bp_p"]
        mp = self.p["mp"]
        k1 = kb * BRICK
        k2 = torch.clamp(k1 + BRICK - 1, max=n_slabs - 1)
        if self.sgn > 0:
            ka, kc, k_front = k1, (k2 + d_pair).clamp(0, n_slabs - 1), k1
        else:
            ka, kc, k_front = (k1 - d_pair).clamp(0, n_slabs - 1), k2, k2
        m_lo = (self.k0_of(k1) // bp_p).clamp(0, mp - 1)
        m0 = (self.k0_of(k_front) // bp_p).clamp(0, mp - 1)
        occupied = window_min(
            self.p, self.inp.cskip, m_lo, *self.qu_bounds2(k1, k2),
            self.rows16, self.cols,
            None if stats is None else (stats, "cskip", todo)) == 0
        d = window_min(self.p, self.inp.coarse, m0, *self.qu_bounds2(ka, kc),
                       self.rows16, self.cols,
                       None if stats is None else (stats, "coarse",
                                                   todo & ~occupied))
        return occupied, d

    def leap_target(self, kb, d):
        bp_p, inv_dsNp = self.p["bp_p"], self.inv_dsNp
        P = _f2i(torch.floor((d.to(torch.float32) - 1.0) / self.rate))
        if self.sgn > 0:
            c0 = self.k0_of(kb * BRICK) // bp_p
            k_tgt = _f2i(torch.floor(
                (((c0 + P + 1) * bp_p - 2).to(torch.float32) + 1.5)
                * inv_dsNp - 0.5))
            return torch.maximum(kb + 1, k_tgt // BRICK)
        k2 = torch.clamp(kb * BRICK + BRICK - 1, max=self.n_slabs - 1)
        c0 = self.k0_of(k2) // bp_p
        k_tgt = _f2i(torch.ceil(
            (((c0 - P) * bp_p).to(torch.float32) + 0.5) * inv_dsNp - 0.5)) - 1
        return torch.minimum(kb - 1, k_tgt // BRICK)

    def probe(self, kb, todo=None, stats: dict | None = None):
        """(occupied by the tight window, the leap's target) of brick kb of
        each tile."""
        occupied, d = self.brick_window(kb, todo, stats)
        return occupied, self.leap_target(kb, d)

    def work(self, kb, alpha):
        """Tiles with a pixel that samples brick kb."""
        first = self.slab_s(kb * BRICK)
        last = self.slab_s(torch.clamp(kb * BRICK + BRICK - 1,
                                       max=self.n_slabs - 1))
        sb_lo = torch.minimum(first, last)[:, None, None]
        sb_hi = torch.maximum(first, last)[:, None, None]
        work = self.cov & (sb_hi >= self.s_lo) & (sb_lo <= self.s_hi)
        if self.ert:
            work = work & (alpha <= 0.99)
        return work.reshape(self.T, -1).any(dim=1)

    def sample(self, kb, sel, state):
        """Composites brick kb of each ``sel`` tile into ``state``."""
        lum, alpha, firsts, nsamp = state
        p, inp, reads = self.p, self.inp, self.reads
        Np, Sv, Su, n_slabs = p["Np"], p["Sv"], p["Su"], self.n_slabs
        cov, s_lo, s_hi, kap = self.cov, self.s_lo, self.s_hi, self.kap
        aligned, use_gradient = self.aligned, self.use_gradient
        f = torch.float32
        vol = inp.vol.reshape(-1)
        grad = inp.grad.reshape(-1) if use_gradient else None

        def axis_alpha(x, lo, inv):
            """One axis of the TF: the closed form, or (texture TF) the
            closed form at the quantised texel."""
            if self.texture_tf:
                return texel_alpha(x, lo, inv)
            return torch.clamp((x - lo) * inv, 0.0, 1.0)

        js = range(BRICK) if self.sgn > 0 else range(BRICK - 1, -1, -1)
        for j in js:
            k = kb * BRICK + j
            s = self.slab_s(k)
            t = s - p["o_p"]
            s3 = s[:, None, None]
            in_rng = (cov & (s3 >= s_lo) & (s3 <= s_hi)
                      & (sel & (k < n_slabs))[:, None, None])
            if self.ert:
                in_rng = in_rng & (alpha <= 0.99)
            qu = (p["o_u"] + self.wu_c * t[:, None]) * float(Su) - 0.5
            qv = torch.clamp((p["o_v"] + self.wv_r * t[:, None]) * float(Sv)
                             - 0.5, 0.0, float(Sv) - 1.0)
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
                kk0, fp = self.k0_of(k), None
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

            a_int = axis_alpha(bilinear(vol), p["imin"], p["iinv"])
            a_tf = a_int
            if reads is not None:
                idxs = [base + r[:, :, None] * Su + iu[:, None, :]
                        for r in (r0, r1) for iu in (iu0, iu1)]
                lerp = 0 if aligned else Sv * Su
                mark_reads(reads["vol"], vol, idxs, in_rng, lerp)
                if use_gradient:
                    mark_reads(reads["grad"], grad, idxs,
                               in_rng & (a_int > 0.0), lerp)
            if use_gradient:
                a_tf = a_tf * axis_alpha(bilinear(grad), p["gmin"],
                                         p["ginv"])
            if self.texture_tf:
                a_tf = truncate_alpha(a_tf)
            a_corr = torch.clamp(
                p["vaf"] * (1.0 - torch.pow(1.0 - a_tf, kap)), 0.0, 1.0)
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
            alpha = new_alpha
            if p["count_samples"]:
                nsamp = nsamp + in_rng.to(torch.int32)
        return lum, alpha, firsts, nsamp


def window_min(p: dict, ref: torch.Tensor, m, qu_lo, qu_hi, qv_lo, qv_hi,
               rows16, cols, seen=None):
    """Min of ref[m] over each tile's dilated cell window (texel rect
    [qu_lo, qu_hi] × [qv_lo, qv_hi]); 0 when the window is taller than the
    TPU kernels' 16-row view (both sweeps' walks). ``seen``, when given, is
    (stats, the map's name, the tiles whose window counts): see
    ``note_windows``."""
    CV, CU, CVp = p["CV"], p["CU"], p["CVp"]
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
    tall = cv_hi > cv8 + 15
    if seen is not None:
        note_windows(*seen, m, rows, cv_lo, cv_hi, cu_lo, cu_hi, tall, CVp)
    return torch.where(tall, 0, d)


def note_windows(stats: dict, name: str, counted, m, rows, cv_lo, cv_hi,
                 cu_lo, cu_hi, tall, CVp: int) -> None:
    """Adds the windows of the ``counted`` tiles to a walk's ``stats``:
    "windows", their number; "words", the 4-byte words the walk kernels'
    ``window_min`` reads for them (none for a window taller than the
    view); and, where ``stats[name]`` is a ``sector_map`` of that map, the
    32-byte sectors holding those words (the bytes side of the walks'
    bound)."""
    stats["windows"] = stats.get("windows", 0) + int(counted.sum())
    read = counted & ~tall
    words = (cv_hi - cv_lo + 1) * (cu_hi // 4 - cu_lo // 4 + 1)
    stats["words"] = stats.get("words", 0) + int(words[read].sum())
    sectors = stats.get(name)
    if sectors is None:
        return
    per_row = TILE_W // 32
    s = torch.arange(per_row, device=rows.device)
    in_rows = (read[:, None] & (rows >= cv_lo[:, None])
               & (rows <= cv_hi[:, None]))
    in_cols = (s >= (cu_lo // 32)[:, None]) & (s <= (cu_hi // 32)[:, None])
    idx = ((m[:, None] * CVp + rows) * per_row)[:, :, None] + s
    sectors[idx[in_rows[:, :, None] & in_cols[:, None, :]]] = True


def count_passed(reads: dict | None, past_intensity, composited) -> None:
    """Adds to ``reads["passed"]``, where the plain sweep was given one,
    the samples whose intensity alpha is above 0 (the kernels take their
    gradient taps) and those that composite (alpha above 0 after the
    gradient TF: the kernels take ``powf`` and composite only these)."""
    if reads is not None and "passed" in reads:
        reads["passed"] += torch.stack([past_intensity.sum(),
                                        composited.sum()]).to(torch.int64)


def sweep_bricks_reference(inp: BrickInputs, reads: dict | None = None):
    """Plain PyTorch version of K1 with its walk and compositing
    interleaved, as the TPU kernel runs them (``_interleaved``): (lum,
    alpha, firsts, nsamp), each (H, W). The independent check of the split
    that K1 runs (``brick_walk`` + ``sweep_bricks_composite``).

    ``reads`` (``{"vol": sector_map(inp.vol), "grad": ...}``), when given,
    gets the sectors this run's samples need: the volume's taps of every
    sample in range, the gradient map's of those whose intensity alpha is
    above 0 (the kernel skips the others' gradient taps); with a
    ``"passed"`` entry (``torch.zeros(2, dtype=torch.int64)``), the counts
    of ``count_passed``."""
    return _interleaved(_PlainBricks(inp, reads))


def brick_walk_plain(inp: BrickInputs, stats: dict | None = None
                     ) -> TileLists:
    """Plain version of K1's walk: each tile's visited bricks in sweep
    order. ``stats`` (``note_windows``; sector maps under "cskip" and
    "coarse"): the windows the walk reduces, a tight one per step and a
    coarse one per leap."""
    return _walk_lists(_PlainBricks(inp), stats)


def sweep_bricks_composite_plain(inp: BrickInputs, walk: TileLists):
    """Plain version of K1's compositing over a walk's lists: (lum, alpha,
    firsts, nsamp), each (H, W)."""
    return _composite_lists(_PlainBricks(inp), walk)


def tile_lists(n_tiles: int, cap: int, device) -> TileLists:
    """Uninitialised lists for a walk kernel to fill (int16 indices)."""
    if cap > np.iinfo(np.int16).max:
        raise ValueError(f"{cap} bricks or slabs exceed the int16 lists")
    return TileLists(
        cnt=torch.empty(n_tiles, dtype=torch.int32, device=device),
        lst=torch.empty((n_tiles, cap), dtype=torch.int16, device=device))


def brick_walk(inp: BrickInputs) -> TileLists:
    """K1's walk: each tile's visited bricks. CPU tensors run the plain
    version; CUDA tensors launch the kernel (or raise)."""
    if inp.vol.device.type == "cpu":
        return brick_walk_plain(inp)
    p = inp.params
    H, W = p["H"], p["W"]
    for name in ("wu", "wv", "s_lo", "s_hi"):
        cuda_build.require_cuda(name, getattr(inp, name), torch.float32,
                                (H, W))
    cuda_build.require_cuda("cov", inp.cov, torch.bool, (H, W))
    for name in ("coarse", "cskip"):
        cuda_build.require_cuda(name, getattr(inp, name), torch.uint8,
                                (p["mp"], p["CVp"], TILE_W))
        cuda_build.require_aligned(name, getattr(inp, name), 4)
    cuda_build.require_cuda("kb_occ", inp.kb_occ, torch.int32, (2,))
    lists = tile_lists(H // p["tile_h"] * (W // TILE_W),
                       -(-p["n_slabs"] // BRICK), inp.vol.device)
    ptrs = [t.data_ptr() for t in (
        inp.wu, inp.wv, inp.s_lo, inp.s_hi, inp.cov, inp.coarse, inp.cskip,
        inp.kb_occ, lists.cnt, lists.lst)]
    with timing.kernel(LAUNCHES, "brick_walk"):
        cuda_build.check(cuda_build.load_kernels().vkv_brick_walk(
            *ptrs, cuda_build.BrickParams(**p), cuda_build.stream()),
            "brick_walk")
    return lists


def sweep_bricks_composite(inp: BrickInputs, walk: TileLists):
    """K1's compositing over the walk's lists: (lum, alpha, firsts,
    nsamp). CPU tensors run the plain version; CUDA tensors launch the
    kernel (or raise)."""
    if inp.vol.device.type == "cpu":
        return sweep_bricks_composite_plain(inp, walk)
    p = inp.params
    H, W = p["H"], p["W"]
    for name in ("wu", "wv", "s_lo", "s_hi", "kappa"):
        cuda_build.require_cuda(name, getattr(inp, name), torch.float32,
                                (H, W))
    cuda_build.require_cuda("cov", inp.cov, torch.bool, (H, W))
    cuda_build.require_cuda("vol", inp.vol, torch.uint8,
                            (p["Np"], p["Sv"], p["Su"]))
    if p["use_gradient"]:
        cuda_build.require_cuda("grad", inp.grad, torch.uint8,
                                (p["Np"], p["Sv"], p["Su"]))
    n_tiles = H // p["tile_h"] * (W // TILE_W)
    cuda_build.require_cuda("cnt", walk.cnt, torch.int32, (n_tiles,))
    cuda_build.require_cuda("lst", walk.lst, torch.int16,
                            (n_tiles, -(-p["n_slabs"] // BRICK)))
    dev = inp.vol.device
    lum = torch.empty((H, W), dtype=torch.float32, device=dev)
    alpha = torch.empty_like(lum)
    firsts = torch.empty_like(lum)
    nsamp = torch.empty((H, W), dtype=torch.int32, device=dev)
    # Without a gradient TF the kernel never reads ``grad``.
    grad = inp.grad if p["use_gradient"] else inp.vol
    ptrs = [t.data_ptr() for t in (
        inp.wu, inp.wv, inp.s_lo, inp.s_hi, inp.kappa, inp.cov, inp.vol,
        grad, walk.cnt, walk.lst, lum, alpha, firsts, nsamp)]
    key = "sweep_bricks_texture" if p["texture_tf"] else "sweep_bricks"
    with timing.kernel(LAUNCHES, key):
        cuda_build.check(cuda_build.load_kernels().vkv_sweep_bricks(
            *ptrs, cuda_build.BrickParams(**p), cuda_build.stream()),
            "sweep_bricks")
    return lum, alpha, firsts, nsamp


def sweep_bricks_kernel(inp: BrickInputs):
    """K1: the walk, then the compositing over its lists: (lum, alpha,
    firsts, nsamp). CPU tensors run the plain versions; CUDA tensors
    launch the kernels (or raise)."""
    return sweep_bricks_composite(inp, brick_walk(inp))


def sweep_bricks(vol_t: torch.Tensor, occupancy_t: torch.Tensor,
                 tf: TFParams, uniforms: FrameUniforms, proj_view_model,
                 grid, *, p_axis: int, ert: bool, count_samples: bool,
                 n_slabs: int, sgn: int, tile_h: int, dist_leap: bool,
                 grad_t: torch.Tensor | None = None,
                 texture_tf: bool = False) -> RenderOutput:
    """The brick sweep stage: ``grid`` = (wu, wv, s_lo, s_hi, kappa,
    covered) w-grid fields (see grid_fields); ``proj_view_model`` the host
    (4, 4) float32 matrix for the first-hit depth; ``grad_t`` the
    transposed gradient map (gradient TFs); ``texture_tf`` the TF through
    the baked texture."""
    inp = brick_inputs(vol_t, occupancy_t, tf, uniforms, grid, p_axis=p_axis,
                       ert=ert, count_samples=count_samples, n_slabs=n_slabs,
                       sgn=sgn, tile_h=tile_h, dist_leap=dist_leap,
                       grad_t=grad_t, texture_tf=texture_tf)
    lum, alpha, firsts, nsamp = sweep_bricks_kernel(inp)
    depth = first_hit_depth(uniforms, proj_view_model, p_axis, inp.wu,
                            inp.wv, alpha, firsts)
    zi = torch.zeros(lum.shape, dtype=torch.int32, device=lum.device)
    return RenderOutput(color=torch.stack([lum, lum, lum, alpha], -1),
                        depth=depth, num_volume_samples=nsamp,
                        num_distance_samples=zi, num_empty_samples=zi,
                        iterations=n_slabs)


def first_hit_depth(uniforms: FrameUniforms, proj_view_model, p_axis: int,
                    wu: torch.Tensor, wv: torch.Tensor, alpha: torch.Tensor,
                    firsts: torch.Tensor) -> torch.Tensor:
    """The brick sweep's depth (H, W): each w-grid ray's first hit (its
    slab position ``firsts`` along ``p_axis``, the ray's ``wu``, ``wv``)
    through the host (4, 4) ``proj_view_model``, reverse-Z; 0 where the
    ray composited nothing."""
    f = torch.float32
    o = np.asarray(uniforms.cam_pos_tex, np.float32)
    v_ax, u_ax = _SLICE_AXES[p_axis]
    H, W = alpha.shape
    hit = (alpha > 0.0) & (firsts < 1.5)
    t_hit = firsts - float(o[p_axis])
    pen_xyz = [None, None, None]
    pen_xyz[p_axis] = firsts
    pen_xyz[u_ax] = float(o[u_ax]) + wu * t_hit
    pen_xyz[v_ax] = float(o[v_ax]) + wv * t_hit
    pen = torch.stack(pen_xyz, -1) - 0.5
    pen_h = torch.cat(
        [pen, torch.ones((H, W, 1), dtype=f, device=pen.device)], -1)
    pvm = torch.as_tensor(np.asarray(proj_view_model, np.float32),
                          device=pen.device)
    pen_clip = pen_h @ pvm.T
    w = pen_clip[..., 3]
    pen_depth = pen_clip[..., 2] / torch.where(w == 0, 1.0, w)
    return torch.where(hit, pen_depth, 0.0)
