"""Multi-device rendering over a ``torch.distributed`` process group —
port of ``vkvolume_tpu/parallel/mesh.py``.

The JAX module runs one process that owns every device of a one-axis
``jax.sharding.Mesh``; PyTorch runs one process (rank) per device, and
every rank calls the same function on its own shard (SPMD). The port's
mesh is therefore a process group (``Mesh``), and what XLA inserts from
JAX's shardings is spelled out here as collectives:

* ``march_sharded``: image rows (rays) sharded, volume and maps on every
  rank; no collective until ``iterations``' max (``gather_rows`` rebuilds
  the image where a caller wants it whole);
* ``march_volume_sharded``: z-slabs of the volume with ``_HALO`` halo
  planes, each rank's slab cut on the host and put on its device; rays
  replicated, each rank marches its segment of every ray, one all-gather
  of the segments, then every rank over-folds them in ray order;
* ``render_frame_sharded``: the w-grid frame with the grid's rows sharded
  for the sweep, one all-gather of the channel stack, and the image rows
  sharded for the warp;
* ``sweep_volume_sharded``: the brick sweep on bp-aligned plane slabs of
  the transposed volume in rebased local texture space, the grid outputs
  over-folded in slab order.

Under gloo a collective of CUDA tensors stages through host memory; under
NCCL it stays on the devices. ``make_mesh`` takes the group's backend as
it was initialised (``launch.spawn`` picks it) and never switches it.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from ..engine.volume import resolve_device
from ..options import Test
from ..render import sweep_bricks as sb
from ..render import sweep_frame as sf
from ..render.marcher import march
from ..render.ray_setup import _SLICE_AXES, RaySetup, RenderOutput

RAY_AXIS = "rays"
VOL_AXIS = "slabs"
_HALO = 2   # trilinear needs 1 plane, on-the-fly gradient taps 1 more
_PIXEL_FIELDS = ("color", "depth", "num_volume_samples",
                 "num_distance_samples", "num_empty_samples")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of a one-axis device mesh: the process group of
    its ranks, this rank's place in it, its device and the group's
    backend."""

    group: object
    rank: int
    size: int
    device: torch.device
    backend: str

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's ``t`` (equal shapes) concatenated along ``dim`` in
        rank order, on every rank (the list form of ``all_gather``, which
        gloo takes for CUDA tensors)."""
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.group)
        return torch.cat(parts, dim)

    def broadcast_object(self, obj):
        """Mesh rank 0's picklable ``obj`` on every rank."""
        box = [obj]
        dist.broadcast_object_list(
            box, src=dist.get_global_rank(self.group, 0), group=self.group)
        return box[0]

    def max_int(self, x: int) -> int:
        """The largest of the ranks' ``x``."""
        t = torch.tensor([int(x)], dtype=torch.int64, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return int(t)


def make_mesh(n_devices: int | None = None, *,
              device: str | torch.device | None = None) -> Mesh | None:
    """The mesh of the first ``n_devices`` ranks of the initialised default
    process group (all of them by default). Every rank of the group calls
    it; a rank outside the mesh gets None. ``device``: this rank's device,
    by default ``cuda:<LOCAL_RANK % device count>`` (raises without a
    CUDA device); "cpu" only when asked."""
    if device is None or torch.device(device) == torch.device("cuda"):
        if not torch.cuda.is_available():
            resolve_device("cuda")            # raises: no CUDA device
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()
                                   if dist.is_initialized() else 0))
        device = f"cuda:{local % torch.cuda.device_count()}"
    dev = resolve_device(device)
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group, or "
                           "parallel.spawn)")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"a mesh of {n} of {world} ranks")
    rank = dist.get_rank()
    # new_group is collective over the whole world, members or not.
    group = dist.group.WORLD if n == world else dist.new_group(list(range(n)))
    if rank >= n:
        return None
    return Mesh(group=group, rank=rank, size=n, device=dev,
                backend=str(dist.get_backend(group)))


def _row_block(a: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    h = a.shape[0] // mesh.size
    return a[mesh.rank * h:(mesh.rank + 1) * h]


def shard_rays(rays: RaySetup, mesh: Mesh) -> RaySetup:
    """This rank's contiguous image rows of every per-pixel field."""
    return dataclasses.replace(rays, **{
        f.name: _row_block(getattr(rays, f.name), mesh)
        for f in dataclasses.fields(rays)
        if getattr(rays, f.name) is not None})


def _flatten(tree, leaves: list):
    """``tree``'s structure, each tensor replaced by its index into
    ``leaves`` (where it is appended)."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return ("tensor", len(leaves) - 1)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return ("dataclass", type(tree), {
            f.name: _flatten(getattr(tree, f.name), leaves)
            for f in dataclasses.fields(tree)})
    if isinstance(tree, (tuple, list)):
        return (type(tree).__name__, [_flatten(x, leaves) for x in tree])
    if isinstance(tree, dict):
        return ("dict", {k: _flatten(v, leaves) for k, v in tree.items()})
    return ("leaf", tree)


def _unflatten(spec, leaves: list):
    kind = spec[0]
    if kind == "tensor":
        return leaves[spec[1]]
    if kind == "dataclass":
        return spec[1](**{k: _unflatten(v, leaves)
                          for k, v in spec[2].items()})
    if kind in ("tuple", "list"):
        seq = [_unflatten(x, leaves) for x in spec[1]]
        return tuple(seq) if kind == "tuple" else seq
    if kind == "dict":
        return {k: _unflatten(v, leaves) for k, v in spec[1].items()}
    return spec[1]


def replicate(tree, mesh: Mesh):
    """Mesh rank 0's ``tree`` (tensors, dataclasses, tuples, lists, dicts
    and plain values) on every rank, its tensors on each rank's device.
    The other ranks' ``tree`` is ignored (pass None)."""
    leaves: list = []
    if mesh.rank == 0:
        spec = _flatten(tree, leaves)
        leaves = [t.to(mesh.device).contiguous() for t in leaves]
        meta = (spec, [(t.shape, t.dtype) for t in leaves])
    else:
        meta = None
    spec, shapes = mesh.broadcast_object(meta)
    if mesh.rank != 0:
        leaves = [torch.empty(shape, dtype=dtype, device=mesh.device)
                  for shape, dtype in shapes]
    src = dist.get_global_rank(mesh.group, 0)
    for t in leaves:
        dist.broadcast(t, src=src, group=mesh.group)
    return _unflatten(spec, leaves)


def gather_rows(out: RenderOutput, mesh: Mesh) -> RenderOutput:
    """The whole image, on every rank, of a row-sharded ``RenderOutput``
    (what XLA inserts from JAX's output sharding)."""
    return dataclasses.replace(out, **{
        k: mesh.all_gather(getattr(out, k), 0) for k in _PIXEL_FIELDS})


def _take_planes(a, idx: np.ndarray, device: torch.device) -> torch.Tensor:
    """Planes ``idx`` of ``a`` (host numpy or a tensor) on ``device``: the
    slab is cut where ``a`` lies, so a host array never reaches the device
    whole."""
    if isinstance(a, torch.Tensor):
        return a[torch.as_tensor(idx, device=a.device)].to(device)
    return torch.from_numpy(np.ascontiguousarray(a[idx])).to(device)


def march_volume_sharded(
    mesh: Mesh,
    volume_u8,
    gradient_u8,
    dist_maps_u8,
    tf,
    rays: RaySetup,
    block_size_xyz,
    proj_view_model,
    **static_options,
) -> RenderOutput:
    """Volume-sharded march (the tensor-parallel analogue): the volume is
    split along z into per-rank slabs with ``_HALO`` halo planes for the
    trilinear / on-the-fly-gradient taps; every rank holds the rays and
    marches only the segment of each ray inside its slab's z-interval. The
    segments compose with the front-to-back over operator in per-pixel ray
    order (ERT saturates alpha to exactly 1, so later segments multiply by
    zero); the small distance maps stay on every rank.

    ``volume_u8`` / ``gradient_u8`` (D, H, W) u8 may lie on the host (numpy
    or a CPU tensor): each rank cuts its own slab there and puts only that
    on its device. ``dist_maps_u8`` and ``rays`` are on the rank's device.
    Segment sample phases differ from the single-device march (each
    segment re-derives n_steps from its own interval), so parity with
    ``march`` is at resample tolerance, like the plane-sweep renderers.
    Returns the whole image on every rank."""
    n, r = mesh.size, mesh.rank
    D = volume_u8.shape[0]
    Pz = -(-D // n)
    # This rank's slab with clamped halo (CLAMP_TO_EDGE at volume ends).
    idx = np.clip(r * Pz + np.arange(-_HALO, Pz + _HALO), 0, D - 1)
    slab = _take_planes(volume_u8, idx, mesh.device)
    grad_slab = (None if gradient_u8 is None
                 else _take_planes(gradient_u8, idx, mesh.device))
    f32 = np.float32
    z0 = r * Pz
    z1 = min(z0 + Pz, D)
    z_lo = float(f32(z0) / f32(D))                 # texture-space interval
    z_hi = float(f32(z1) / f32(D))

    # Clamp each ray to [z_lo, z_hi] along z (the interval arithmetic of
    # the clip plane / depth clamps, ray_setup.py).
    o = rays.entry
    dirs = rays.ray_dir
    dz = dirs[..., 2]
    par = dz.abs() < 1e-9
    safe = torch.where(par, 1.0, dz)
    t0 = (z_lo - o[..., 2]) / safe
    t1 = (z_hi - o[..., 2]) / safe
    tl = torch.minimum(t0, t1)
    th = torch.maximum(t0, t1)
    inside = (o[..., 2] >= z_lo) & (o[..., 2] <= z_hi)
    tl = torch.where(par, torch.where(inside, 0.0, 1e30), tl)
    th = torch.where(par, torch.where(inside, rays.ray_distance, -1e30), th)
    ta = torch.clamp(tl, min=0.0)
    tb = torch.minimum(rays.ray_distance, th)
    seg = dataclasses.replace(
        rays,
        entry=o + dirs * ta[..., None],
        exit=o + dirs * tb[..., None],
        ray_distance=torch.clamp(tb - ta, min=0.0),
        valid=rays.valid & (ta < tb),
    )
    part = march(slab, grad_slab, dist_maps_u8, tf, seg, block_size_xyz,
                 proj_view_model, vol_origin_z=z0 - _HALO, global_depth=D,
                 **static_options)
    parts = {k: mesh.all_gather(getattr(part, k)[None], 0)
             for k in _PIXEL_FIELDS}

    # Compose the segments with the over operator in per-pixel ray order
    # (dz > 0: slab 0 is nearest); every rank folds alike.
    def fold(order):
        c = torch.zeros_like(part.color)
        for k in order:
            c = c + (1.0 - c[..., 3:4]) * parts["color"][k]
        return c

    color = torch.where((dz > 0)[..., None], fold(range(n)),
                        fold(range(n - 1, -1, -1)))
    counts = {k: parts[k].sum(0, dtype=torch.int32)
              for k in _PIXEL_FIELDS[2:]}
    return RenderOutput(
        color=color,
        depth=parts["depth"].amax(0),        # reverse-Z: greater = nearer
        iterations=mesh.max_int(part.iterations), **counts)


def render_frame_sharded(
    mesh: Mesh,
    vol_t: torch.Tensor,
    occupancy_t: torch.Tensor | None,
    tf,
    rays: RaySetup,
    uniforms,
    proj_view_model,
    grad_t: torch.Tensor | None = None,
    *,
    p_axis: int,
    ert: bool = True,
    test=None,
    oversample: float = 1.0,
    dist_leap: bool = False,
    plan: dict | None = None,
) -> RenderOutput:
    """The w-grid frame over the mesh (``sweep_frame.render_frame`` split
    across ranks). Every rank passes the whole image's ``rays`` and the
    volume and maps on its device; mesh rank 0 plans (``plan`` overrides,
    as in ``render_frame``) and every rank takes that plan. Then:

    * the **sweep** runs on this rank's ``Hi / n`` contiguous grid rows —
      the brick sweep (K1) when they tile by the plan's ``tile_h``, else
      the per-slab sweep (K7);
    * one all-gather rebuilds the grid (the frame's only collective; under
      gloo it stages through host memory);
    * the **warp** runs on this rank's image rows, which are returned
      (``gather_rows`` makes the whole image).

    Constraints: the image and the planned grid split into 8-row tiles per
    rank (H % (8·n) == 0, Hi % (8·n) == 0) and the width into 128-lane
    tiles; a wide-rect plan the brick sweep cannot take on every rank is
    re-planned at 256 lanes, as in the JAX package."""
    if test is None:
        test = Test.NONE
    n = mesh.size
    H, W = rays.valid.shape
    if H % (sf.TILE_H * n) or W % sf.TILE_W:
        raise ValueError(f"image {H}x{W} not tile-divisible over {n} devices")
    shape_t = tuple(vol_t.shape)
    if plan is None:
        plan = mesh.broadcast_object(
            sf.plan_frame(uniforms, rays, p_axis, shape_t, H, W)
            if mesh.rank == 0 else None)
    if plan is None:
        raise sf.PallasUnsupported("view exceeds w-grid kernel limits")
    n_slabs = int(max(2, round(shape_t[0] * oversample)))
    if sf.read_plan(plan).rect_w > 256 and not sf.brick_route(
            plan, n_slabs, shape_t[0], ranks=n):
        # Wide-rect plans are brick-sweep-only: where the brick sweep cannot
        # take this one on every rank, re-plan at the 256-lane rect the
        # per-slab sweep covers.
        plan = mesh.broadcast_object(
            sf.plan_frame(uniforms, rays, p_axis, shape_t, H, W, max_rect=256)
            if mesh.rank == 0 else None)
        if plan is None:
            raise sf.PallasUnsupported("view exceeds w-grid kernel limits")
    Hi = sf.read_plan(plan).Hi
    if Hi % (sf.TILE_H * n):
        raise ValueError(f"grid height {Hi} not divisible over {n}")
    return sf.render_planned(
        vol_t, occupancy_t, tf, shard_rays(rays, mesh), uniforms,
        proj_view_model, grad_t, plan, p_axis=p_axis, ert=ert, test=test,
        oversample=oversample, dist_leap=dist_leap, texture_tf=False,
        height=H, shard=mesh)


def march_sharded(
    mesh: Mesh,
    volume_u8,
    gradient_u8,
    dist_maps_u8,
    tf,
    rays: RaySetup,
    block_size_xyz,
    proj_view_model,
    **static_options,
) -> RenderOutput:
    """Data-parallel march: rays sharded over the mesh by image rows,
    volume and maps on every rank's device (``replicate`` puts rank 0's
    there). Every rank passes the whole image's ``rays``; the image height
    must be divisible by the mesh size. Rays are independent, so the march
    needs no collective until ``iterations``' max; returns this rank's
    rows (``gather_rows`` makes the whole image)."""
    n = mesh.size
    H = rays.valid.shape[0]
    if H % n:
        raise ValueError(f"image height {H} not divisible by mesh size {n}")
    out = march(volume_u8, gradient_u8, dist_maps_u8, tf,
                shard_rays(rays, mesh), block_size_xyz, proj_view_model,
                **static_options)
    return dataclasses.replace(out, iterations=mesh.max_int(out.iterations))


def sweep_volume_sharded(
    mesh: Mesh,
    vol_t,
    occupancy_t,
    tf,
    uniforms,
    proj_view_model,
    grad_t=None,
    *,
    p_axis: int,
    height: int,
    width: int,
    ert: bool = True,
    dist_leap: bool = False,
) -> RenderOutput:
    """Volume-sharded production sweep: the w-grid brick sweep (K1) runs
    on per-rank plane slabs of the (p-transposed) volume and the segment
    grids compose with the over operator — ``march_volume_sharded`` for
    the production renderer. Each rank sweeps its slab through the
    unchanged brick sweep in a LOCAL texture space; with the aligned
    sampling (n_slabs == Np) the affine re-basing is exact:

        s' = (s·Np − z0) / Np_loc         (slab/plane coordinates)
        o_p' = (o_p·Np − z0) / Np_loc,  t' = t·Np/Np_loc
        wu' = wu·Np_loc/Np  (so wu'·t' == wu·t — u/v sampling unchanged)

    ``kappa`` (the opacity-correction step length) stays GLOBAL, so each
    segment composites exactly the samples the single-device sweep takes
    in its s-range; the over-composition is then exact up to ERT's
    cross-shard tail (a saturated earlier slab multiplies later ones by
    (1 − α) ≤ 0.01 instead of skipping them).

    ``vol_t`` / ``occupancy_t`` / ``grad_t`` may lie on the host (numpy or
    a CPU tensor): each rank cuts its own slab there (shard edges on
    map-plane boundaries; the local volume padded to whole map planes,
    padded occupancy planes EMPTY) and puts only that on its device. Depth
    comes from a per-rank pvm composed with the local→global texture
    affine. Returns the w-grid (Hi, Wi) outputs, not pixels, on every
    rank."""
    n, r = mesh.size, mesh.rank
    Np, Sv, Su = vol_t.shape
    n_slabs = Np                       # aligned sampling only (default)

    # vol_t is transposed for p_axis, so only that axis may plan.
    view, plan = sf.select_view_plan(
        uniforms, height, width, lambda q: (Np, Sv, Su), axes=(p_axis,))
    if view is None or view.get("mixed") or plan is None:
        raise sf.PallasUnsupported("view exceeds w-grid kernel limits")
    fp = sf.read_plan(plan)
    if fp.R_brick is None:
        raise sf.PallasUnsupported("brick kernel infeasible for this view")
    sgn = fp.sgn

    # ---- shard geometry (host): map-plane-aligned slab edges + halo ----
    mp = occupancy_t.shape[0]
    bp = -(-Np // mp)                  # voxel planes per map plane
    Pz = -(-(-(-Np // n)) // bp) * bp  # slab planes per rank (bp-aligned)
    HALO = sb.BRICK + 1
    z0 = min(r * Pz, Np)
    z1 = min(z0 + Pz, Np)
    # One local size for every rank: planes [z0, z0 + Pz + HALO) clamped,
    # padded to a whole number of map planes.
    np_loc = -(-(Pz + HALO) // bp) * bp
    idx = np.clip(r * Pz + np.arange(np_loc), 0, Np - 1)
    dev = mesh.device
    slab = _take_planes(vol_t, idx, dev)
    grad_sl = None if grad_t is None else _take_planes(grad_t, idx, dev)
    # Clamp-padding repeats plane Np-1 past the volume's end; the padded
    # occupancy planes are EMPTY, so those planes are never sampled.
    midx = r * (Pz // bp) + np.arange(np_loc // bp)
    occ_sl = _take_planes(occupancy_t, np.clip(midx, 0, mp - 1), dev)
    occ_sl[torch.as_tensor(midx >= mp, device=dev)] = 255

    f32 = np.float32
    # The global w-grid fields (alike on every rank), then rebased.
    wu_g, wv_g = sf.w_grid(fp.gp, fp.Hi, fp.Wi, dev)
    s_lo, s_hi, cov, kappa = sb.grid_fields(
        uniforms, wu_g, wv_g, sgn, p_axis, max(Np, Sv, Su), n_slabs)
    # Restrict to the rank's s-range and rebase into local texture
    # coordinates (a 0.25-slab margin keeps the halo slabs out under f32
    # rounding).
    fz0, fz1 = f32(z0), f32(z1)
    fNp, fnl = f32(Np), f32(np_loc)
    scale = float(fNp / fnl)                       # global→local s
    s_lo_c = torch.clamp(s_lo, min=float(fz0 / fNp))
    s_hi_c = torch.clamp(s_hi, max=float(fz1 / fNp))
    cov_d = cov & (s_lo_c <= s_hi_c)
    s_lo_l = (s_lo_c * float(fNp) - float(fz0)) / float(fnl)
    s_hi_l = torch.clamp((s_hi_c * float(fNp) - float(fz0)) / float(fnl),
                         max=float((fz1 - fz0 - f32(0.25)) / fnl))
    wu_l = wu_g / scale
    wv_l = wv_g / scale

    o = np.asarray(uniforms.cam_pos_tex, np.float32).copy()
    o[p_axis] = (o[p_axis] * fNp - fz0) / fnl
    u_loc = dataclasses.replace(uniforms, cam_pos_tex=o)

    # Local→global texture affine for the depth projection: global
    # p = local·(np_loc/Np) + z0/Np; u and v unchanged. The sweep's
    # epilogue maps pen − 0.5 through the pvm, so in local coordinates
    # pen_l − 0.5 must first map to pen_g − 0.5:
    # pen_g − 0.5 = A·((pen_l − 0.5) + 0.5) − 0.5.
    v_ax, u_ax = _SLICE_AXES[p_axis]
    A = np.zeros((4, 4))
    A[u_ax, u_ax] = A[v_ax, v_ax] = A[3, 3] = 1.0
    A[p_axis, p_axis] = np_loc / Np
    A[p_axis, 3] = z0 / Np
    shift = np.eye(4)
    shift[:3, 3] = 0.5
    unshift = np.eye(4)
    unshift[:3, 3] = -0.5
    pvm_l = (np.asarray(proj_view_model, np.float64)
             @ (unshift @ A @ shift)).astype(np.float32)

    part = sb.sweep_bricks(
        slab, occ_sl, tf, u_loc, pvm_l,
        (wu_l, wv_l, s_lo_l, s_hi_l, kappa, cov_d), p_axis=p_axis, ert=ert,
        count_samples=False, n_slabs=np_loc, sgn=sgn,
        tile_h=fp.tile_h, dist_leap=dist_leap, grad_t=grad_sl)
    parts = {k: mesh.all_gather(getattr(part, k)[None], 0)
             for k in ("color", "depth", "num_volume_samples")}

    # Ordered over-composition: sgn > 0 ⇒ rank 0's slab is nearest.
    order = range(n) if sgn > 0 else range(n - 1, -1, -1)
    color = torch.zeros_like(part.color)
    depth = torch.zeros_like(part.depth)
    nsamp = torch.zeros_like(part.num_volume_samples)
    for k in order:
        color = color + (1.0 - color[..., 3:4]) * parts["color"][k]
        depth = torch.where(depth != 0.0, depth, parts["depth"][k])
        nsamp = nsamp + parts["num_volume_samples"][k]
    zi = torch.zeros_like(nsamp)
    return RenderOutput(color=color, depth=depth, num_volume_samples=nsamp,
                        num_distance_samples=zi, num_empty_samples=zi,
                        iterations=mesh.max_int(part.iterations))
