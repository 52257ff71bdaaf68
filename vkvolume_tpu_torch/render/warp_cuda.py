"""Warps of the w-grid image to pixels — port of
``vkvolume_tpu/render/warp_pallas.py``.

* The two-pass projective warp: the pixel→grid map is an exact
  homography, so the bilinear resample factors into two row-aligned 1-D
  rational resamples with a transpose between them (Catmull & Smith
  1980). Each pass is ``resample_rows``, which launches K2
  (csrc/resample_rows.cu) for CUDA tensors and runs
  ``resample_rows_reference`` for CPU tensors. The transposes and the u16
  encode/decode are plain PyTorch, as XLA did them.
* The single-pass warp: ``warp_to_pixels`` launches K8
  (csrc/warp_pixels.cu) for CUDA tensors and runs ``warp_to_pixels_plain``
  for CPU tensors. The plain version is the port of
  ``sweep_pallas._warp_reference``, the gather warp that the JAX frame
  computes on a CPU and on any device for a ``warp_xla`` plan; the frame
  calls it directly for such plans.
"""

from __future__ import annotations

import torch

from ..utils import cuda_build

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


def resample_rows(src_chw: torch.Tensor, pos: torch.Tensor, *,
                  encode_out: bool = False) -> torch.Tensor:
    """K2: row-aligned 1-D resample of a (C, Hs, Ws) u16 or f32 source at
    positions ``pos`` (Ho, Wo) with Ho == Hs; (C, Ho, Wo) f32, or u16 with
    ``encode_out``."""
    C, Hs, Ws = src_chw.shape
    Ho, Wo = pos.shape
    if Ho != Hs:
        raise ValueError(f"pos rows {Ho} != source rows {Hs}")
    if src_chw.device.type == "cpu":
        return resample_rows_reference(src_chw, pos, encode_out)
    if src_chw.dtype not in (torch.uint16, torch.float32):
        raise ValueError(f"src: expected uint16 or float32, got {src_chw.dtype}")
    cuda_build.require_cuda("src", src_chw, src_chw.dtype)
    cuda_build.require_cuda("pos", pos, torch.float32)
    lib = cuda_build.load_kernels()
    out = torch.empty((C, Ho, Wo),
                      dtype=torch.uint16 if encode_out else torch.float32,
                      device=src_chw.device)
    cuda_build.check(lib.vkv_resample_rows(
        src_chw.data_ptr(), pos.data_ptr(), out.data_ptr(), C, Hs, Ws, Wo,
        int(src_chw.dtype == torch.uint16), int(encode_out),
        cuda_build.stream()), "resample_rows")
    LAUNCHES["resample_rows"] += 1
    return out


def _encode(a: torch.Tensor, sc: torch.Tensor) -> torch.Tensor:
    return torch.round(torch.clamp(a * sc, 0.0, 65535.0)).to(torch.uint16)


def warp_two_pass(chans: torch.Tensor, xa: torch.Tensor, gy_t: torch.Tensor,
                  *, scales) -> torch.Tensor:
    """Row-first order. chans: (C, Hi, Wi) grid image; xa: (Hi, W) pass-A
    positions; gy_t: (W, Hp) transposed pass-B positions. Returns
    (C, Hp, W); the caller crops rows. The passes run u16-encoded
    (``scales`` map each channel into [0, 65535]): ≤1/65535 quantisation per
    pass, far below an 8-bit output's LSB."""
    sc = torch.tensor(scales, dtype=torch.float32,
                      device=chans.device)[:, None, None]
    t = resample_rows(_encode(chans, sc), xa, encode_out=True)
    out_t = resample_rows(t.transpose(1, 2).contiguous(), gy_t)
    return out_t.transpose(1, 2) / sc


def warp_two_pass_b(chans: torch.Tensor, yb: torch.Tensor, gx_p: torch.Tensor,
                    *, scales) -> torch.Tensor:
    """Column-first order (the transposed Catmull-Smith factorisation).
    chans: (C, Hi, Wi); yb: (Wi, Hp) pass-1 positions into grid rows, per
    grid column; gx_p: (Hp, W) pass-2 positions into grid columns. Returns
    (C, Hp, W); the caller crops rows."""
    sc = torch.tensor(scales, dtype=torch.float32,
                      device=chans.device)[:, None, None]
    src = _encode(chans.transpose(1, 2), sc).contiguous()      # (C, Wi, Hi)
    t = resample_rows(src, yb, encode_out=True)                # (C, Wi, Hp)
    return resample_rows(t.transpose(1, 2).contiguous(), gx_p) / sc


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


def warp_to_pixels(chans: torch.Tensor, gx: torch.Tensor,
                   gy: torch.Tensor) -> torch.Tensor:
    """K8: the single-pass warp of the (C, Hi, Wi) float32 grid channels to
    the (H, W) pixels at grid positions (gx, gy); (C, H, W) float32."""
    if gx.shape != gy.shape:
        raise ValueError(f"gx {tuple(gx.shape)} != gy {tuple(gy.shape)}")
    if chans.device.type == "cpu":
        return warp_to_pixels_plain(chans, gx, gy)
    C, Hi, Wi = chans.shape
    cuda_build.require_cuda("chans", chans, torch.float32)
    cuda_build.require_cuda("gx", gx, torch.float32)
    cuda_build.require_cuda("gy", gy, torch.float32)
    lib = cuda_build.load_kernels()
    out = torch.empty((C,) + tuple(gx.shape), dtype=torch.float32,
                      device=chans.device)
    cuda_build.check(lib.vkv_warp_pixels(
        chans.data_ptr(), gx.data_ptr(), gy.data_ptr(), out.data_ptr(), C, Hi,
        Wi, gx.numel(), cuda_build.stream()), "warp_to_pixels")
    LAUNCHES["warp_to_pixels"] += 1
    return out
