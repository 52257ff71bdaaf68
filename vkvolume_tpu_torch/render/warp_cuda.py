"""Warps of the w-grid image to pixels — port of
``vkvolume_tpu/render/warp_pallas.py``.

* The two-pass projective warp: the pixel→grid map is an exact
  homography, so the bilinear resample factors into two row-aligned 1-D
  rational resamples with a transpose between them (Catmull & Smith
  1980). Each pass is one launch of K2 (csrc/resample_rows.cu) through
  ``resample_pass``, which takes in the JAX warp's XLA glue: the u16
  encode on load, the transpose between the passes and the decode.
  ``resample_rows`` is K2 with those options off. CPU tensors run the
  plain versions (``resample_pass_plain``, ``warp_two_pass[_b]_plain``).
* The single-pass warp: ``warp_to_pixels`` launches K8
  (csrc/warp_pixels.cu) for CUDA tensors and runs ``warp_to_pixels_plain``
  for CPU tensors. The plain version is the port of
  ``sweep_pallas._warp_reference``, the gather warp that the JAX frame
  computes on a CPU and on any device for a ``warp_xla`` plan; the frame
  calls it directly for such plans.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import cuda_build, timing

LAUNCHES = {"resample_rows": 0, "warp_to_pixels": 0}


def resample_rows_reference(src_chw: torch.Tensor, pos: torch.Tensor,
                            encode_out: bool = False) -> torch.Tensor:
    """Plain version of K2: out[c, y, x] = lerp(src[c, y, pos[y, x]]) with
    pos clamped to [0, Ws-1]; pos < -5 → 0; u16 output (round half to even,
    clip to [0, 65535]) when ``encode_out``."""
    C, Hs, Ws = src_chw.shape
    posc = torch.clamp(pos, 0.0, Ws - 1.0)
    fl = torch.floor(posc)
    x0 = fl.to(torch.int64).clamp(0, Ws - 1)
    x1 = torch.clamp(x0 + 1, max=Ws - 1)
    fu = torch.clamp(posc - fl, 0.0, 1.0)
    src = src_chw.to(torch.int32) if src_chw.dtype == torch.uint16 else src_chw
    src = src.to(torch.float32)
    g0 = torch.gather(src, 2, x0.expand(C, -1, -1))
    g1 = torch.gather(src, 2, x1.expand(C, -1, -1))
    val = torch.where((pos > -5.0)[None], g0 + (g1 - g0) * fu, 0.0)
    if encode_out:
        return torch.round(torch.clamp(val, 0.0, 65535.0)).to(torch.uint16)
    return val


def resample_pass_plain(src: torch.Tensor, pos: torch.Tensor, *,
                        encode_out: bool = False, scales_in=None,
                        column_src: bool = False,
                        transpose_out: bool = False,
                        scales_out=None) -> torch.Tensor:
    """Plain version of one K2 launch: ``resample_rows_reference`` with
    the pass's options. The source is (C, lines, n_src), or (C, n_src,
    lines) read through the transpose (``column_src``); ``scales_in``
    encodes an f32 source to u16 on load (``round(clip(v * sc, 0,
    65535))`` per channel); ``scales_out`` divides the output by them;
    ``transpose_out`` writes (C, n_pos, lines) instead of (C, lines,
    n_pos)."""
    if column_src:
        src = src.transpose(1, 2)
    if scales_in is not None:
        src = _encode(src, _scales(scales_in, src))
    out = resample_rows_reference(src, pos, encode_out)
    if scales_out is not None:
        out = out / _scales(scales_out, out)
    return (out.transpose(1, 2) if transpose_out else out).contiguous()


def resample_pass(src: torch.Tensor, pos: torch.Tensor, *,
                  encode_out: bool = False, scales_in=None,
                  column_src: bool = False, transpose_out: bool = False,
                  scales_out=None) -> torch.Tensor:
    """K2, one launch: ``resample_pass_plain``'s function (CPU tensors run
    it). ``scales_in`` needs an f32 source, ``scales_out`` an f32 output;
    each holds one scale per channel, at most 4."""
    if src.ndim != 3 or pos.ndim != 2:
        raise ValueError(f"src {tuple(src.shape)} / pos {tuple(pos.shape)}: "
                         "expected (C, lines, n_src) / (lines, n_pos)")
    C = src.shape[0]
    lines, n_pos = pos.shape
    n_src = src.shape[1] if column_src else src.shape[2]
    if (src.shape[2] if column_src else src.shape[1]) != lines:
        raise ValueError(f"pos lines {lines} != source lines "
                         f"{tuple(src.shape)} (column_src={column_src})")
    for name, sc in (("scales_in", scales_in), ("scales_out", scales_out)):
        if sc is not None and (len(sc) != C or C > 4):
            raise ValueError(f"{name}: {len(sc)} scales for {C} channels "
                             "(one per channel, at most 4)")
    if scales_in is not None and src.dtype != torch.float32:
        raise ValueError("scales_in: the source must be float32")
    if scales_out is not None and encode_out:
        raise ValueError("scales_out: the output must be float32")
    if src.device.type == "cpu":
        return resample_pass_plain(
            src, pos, encode_out=encode_out, scales_in=scales_in,
            column_src=column_src, transpose_out=transpose_out,
            scales_out=scales_out)
    if src.dtype not in (torch.uint16, torch.float32):
        raise ValueError(f"src: expected uint16 or float32, got {src.dtype}")
    cuda_build.require_cuda("src", src, src.dtype)
    cuda_build.require_cuda("pos", pos, torch.float32)
    lib = cuda_build.load_kernels()
    shape = (C, n_pos, lines) if transpose_out else (C, lines, n_pos)
    out = torch.empty(shape, dtype=torch.uint16 if encode_out
                      else torch.float32, device=src.device)
    sc = scales_in if scales_in is not None else scales_out
    params = cuda_build.PassParams(
        C, lines, n_src, n_pos, scales_in is not None,
        scales_out is not None,
        (ctypes.c_float * 4)(*(list(sc or []) + [1.0] * 4)[:4]))
    with timing.kernel(LAUNCHES, "resample_rows"):
        cuda_build.check(lib.vkv_resample_pass(
            src.data_ptr(), pos.data_ptr(), out.data_ptr(), params,
            int(src.dtype == torch.uint16), int(encode_out), int(column_src),
            int(transpose_out), cuda_build.stream()), "resample_pass")
    return out


def resample_rows(src_chw: torch.Tensor, pos: torch.Tensor, *,
                  encode_out: bool = False) -> torch.Tensor:
    """K2 with every option off: row-aligned 1-D resample of a (C, Hs, Ws)
    u16 or f32 source at positions ``pos`` (Ho, Wo) with Ho == Hs;
    (C, Ho, Wo) f32, or u16 with ``encode_out``."""
    return resample_pass(src_chw, pos, encode_out=encode_out)


def _scales(scales, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(scales, dtype=torch.float32,
                        device=like.device)[:, None, None]


def _encode(a: torch.Tensor, sc: torch.Tensor) -> torch.Tensor:
    return torch.round(torch.clamp(a * sc, 0.0, 65535.0)).to(torch.uint16)


def warp_two_pass(chans: torch.Tensor, xa: torch.Tensor, gy_t: torch.Tensor,
                  *, scales) -> torch.Tensor:
    """Row-first order. chans: (C, Hi, Wi) f32 grid image; xa: (Hi, W)
    pass-A positions; gy_t: (W, Hp) transposed pass-B positions. Returns
    (C, Hp, W); the caller crops rows. The passes run u16-encoded
    (``scales`` map each channel into [0, 65535]): ≤1/65535 quantisation per
    pass, far below an 8-bit output's LSB. Two K2 launches, nothing
    between them: pass 1 encodes on load and writes (C, W, Hi), pass 2
    decodes and writes (C, Hp, W)."""
    t = resample_pass(chans, xa, encode_out=True, scales_in=scales,
                      transpose_out=True)
    return resample_pass(t, gy_t, scales_out=scales, transpose_out=True)


def warp_two_pass_plain(chans: torch.Tensor, xa: torch.Tensor,
                        gy_t: torch.Tensor, *, scales) -> torch.Tensor:
    """Plain version of ``warp_two_pass``: the same two passes, plain."""
    t = resample_pass_plain(chans, xa, encode_out=True, scales_in=scales,
                            transpose_out=True)
    return resample_pass_plain(t, gy_t, scales_out=scales,
                               transpose_out=True)


def warp_two_pass_b(chans: torch.Tensor, yb: torch.Tensor, gx_p: torch.Tensor,
                    *, scales) -> torch.Tensor:
    """Column-first order (the transposed Catmull-Smith factorisation).
    chans: (C, Hi, Wi) f32; yb: (Wi, Hp) pass-1 positions into grid rows,
    per grid column; gx_p: (Hp, W) pass-2 positions into grid columns.
    Returns (C, Hp, W); the caller crops rows. Two K2 launches: pass 1
    reads the grid's columns, encodes on load and writes (C, Hp, Wi),
    pass 2 decodes."""
    t = resample_pass(chans, yb, encode_out=True, scales_in=scales,
                      column_src=True, transpose_out=True)
    return resample_pass(t, gx_p, scales_out=scales)


def warp_two_pass_b_plain(chans: torch.Tensor, yb: torch.Tensor,
                          gx_p: torch.Tensor, *, scales) -> torch.Tensor:
    """Plain version of ``warp_two_pass_b``."""
    t = resample_pass_plain(chans, yb, encode_out=True, scales_in=scales,
                            column_src=True, transpose_out=True)
    return resample_pass_plain(t, gx_p, scales_out=scales)


def warp_to_pixels_plain(chans: torch.Tensor, gx: torch.Tensor,
                         gy: torch.Tensor) -> torch.Tensor:
    """Plain version of K8 (``sweep_pallas._warp_reference``): the
    (C, Hi, Wi) float32 channels sampled bilinearly at (gx, gy) (H, W),
    positions clipped to the grid; 0 where gx < -5. (C, H, W) float32."""
    C, Hi, Wi = chans.shape
    gxc = torch.clamp(gx, 0.0, Wi - 1.0)
    gyc = torch.clamp(gy, 0.0, Hi - 1.0)
    flx, fly = torch.floor(gxc), torch.floor(gyc)
    x0 = flx.to(torch.int64).clamp(0, Wi - 1)
    y0 = fly.to(torch.int64).clamp(0, Hi - 1)
    x1 = (x0 + 1).clamp(max=Wi - 1)
    y1 = (y0 + 1).clamp(max=Hi - 1)
    fx = torch.clamp(gxc - flx, 0.0, 1.0)
    fy = gyc - fly
    flat = chans.reshape(C, -1)

    def tap(y, x):
        return flat[:, (y * Wi + x).reshape(-1)].reshape((C,) + gx.shape)

    c00, c01 = tap(y0, x0), tap(y0, x1)
    c10, c11 = tap(y1, x0), tap(y1, x1)
    v0 = c00 + (c01 - c00) * fx
    v1 = c10 + (c11 - c10) * fx
    return torch.where((gx > -5.0)[None], v0 + (v1 - v0) * fy, 0.0)


def warp_to_pixels(src_chw: torch.Tensor, gx: torch.Tensor,
                   gy: torch.Tensor, *,
                   tile_paths: torch.Tensor | None = None) -> torch.Tensor:
    """K8: the single-pass warp of the (C, Hi, Wi) float32 grid channels to
    the (H, W) pixels at grid positions (gx, gy); (C, H, W) float32.
    ``tile_paths``: None, or an int32 CUDA tensor of four counters that
    the launch adds its tiles to: no covered pixel, staged in shared
    memory in one pass, in two passes, a half read from global memory."""
    if gx.shape != gy.shape or gx.ndim != 2:
        raise ValueError(f"gx {tuple(gx.shape)}, gy {tuple(gy.shape)}: "
                         "expected the same (H, W)")
    if src_chw.device.type == "cpu":
        return warp_to_pixels_plain(src_chw, gx, gy)
    C, Hi, Wi = src_chw.shape
    cuda_build.require_cuda("src_chw", src_chw, torch.float32)
    cuda_build.require_cuda("gx", gx, torch.float32)
    cuda_build.require_cuda("gy", gy, torch.float32)
    if tile_paths is not None:
        cuda_build.require_cuda("tile_paths", tile_paths, torch.int32, (4,))
    if src_chw.numel() >= 2 ** 31:
        raise ValueError(f"src_chw {tuple(src_chw.shape)}: at most "
                         "2**31 - 1 values")
    lib = cuda_build.load_kernels()
    out = torch.empty((C,) + tuple(gx.shape), dtype=torch.float32,
                      device=src_chw.device)
    H, W = gx.shape
    with timing.kernel(LAUNCHES, "warp_to_pixels"):
        cuda_build.check(lib.vkv_warp_pixels(
            src_chw.data_ptr(), gx.data_ptr(), gy.data_ptr(), out.data_ptr(),
            C, Hi, Wi, H, W,
            None if tile_paths is None else tile_paths.data_ptr(),
            cuda_build.stream()), "warp_to_pixels")
    return out
