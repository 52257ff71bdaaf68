"""Build and bind the package's CUDA kernels (``vkvolume_tpu_torch/csrc``).

Every ``csrc/*.cu`` file exposes plain ``extern "C"`` launchers and
includes no PyTorch headers (only ``csrc/*.cuh``), so each compiles in
seconds: one nvcc process per source, all started together, then one link
into a shared library, which ctypes loads. The library lands in ``build/``
beside the package, named by a hash of the sources, headers and flags, so
an edited source is rebuilt and an unchanged one is reused. The build runs at the first CUDA
kernel call, never at import: machines without nvcc import and test the
package through the plain PyTorch versions.

Each launcher takes device pointers and the stream as ``c_void_p`` and
returns ``cudaGetLastError()``; ``check`` raises on a non-zero code, so a
refused launch (too many threads, too much shared memory) never passes
silently.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess

import torch

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(CSRC)), "build")

# sm_90a: Hopper. No --use_fast_math (powf and division stay IEEE), and no
# FMA contraction: the kernels then round every multiply and add exactly as
# their plain PyTorch versions do, which keeps sample counts and first-hit
# planes identical between the two.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int

_lib = None
build_log = ""          # nvcc's output of the build this process made


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "are built from source at their first use")


class BrickParams(ctypes.Structure):
    """Mirror of ``BrickParams`` in csrc/sweep_bricks.cu (field order and
    types must match)."""
    _fields_ = [(name, ctypes.c_int) for name in (
        "Np", "Sv", "Su", "H", "W", "tile_h", "bp_p", "CV", "CU", "CVp",
        "mp", "n_slabs", "sgn", "ert", "count_samples", "aligned",
        "use_gradient", "texture_tf")] + [
        (name, ctypes.c_float) for name in (
            "o_u", "o_v", "o_p", "ds", "imin", "iinv", "vaf", "inv_cvox_v",
            "inv_cvox_u", "drift_u", "drift_v", "gmin", "ginv")]


class SlabParams(ctypes.Structure):
    """Mirror of ``SlabParams`` in csrc/sweep_slabs.cu (field order and
    types must match)."""
    _fields_ = [(name, ctypes.c_int) for name in (
        "Np", "Sv", "Su", "H", "W", "bp_p", "CV", "CU", "CVp", "mp",
        "n_slabs", "ert", "count_samples", "use_gradient", "separable")] + [
        (name, ctypes.c_float) for name in (
            "o_u", "o_v", "o_p", "ds", "imin", "iinv", "vaf", "inv_cvox_v",
            "inv_cvox_u", "drift_u", "drift_v", "gmin", "ginv")]


class PassParams(ctypes.Structure):
    """Mirror of ``PassParams`` in csrc/resample_rows.cu (field order and
    types must match)."""
    _fields_ = [(name, ctypes.c_int) for name in (
        "C", "lines", "n_src", "n_pos", "encode", "decode")] + [
        ("sc", ctypes.c_float * 4)]


class FrameScalars(ctypes.Structure):
    """Mirror of ``FrameScalars`` in csrc/frame_glue.cu (field order and
    types must match): ``s`` holds ``sweep_frame.pack_frame_scalars``'
    array."""
    _fields_ = [("s", ctypes.c_float * 142)] + [
        (name, ctypes.c_int) for name in (
            "Hi", "Wi", "row0", "H", "W", "Hp", "p_axis", "sgn", "warp")] + [
        ("kappa_scale", ctypes.c_float)]


class BrickMapParams(ctypes.Structure):
    """Mirror of ``BrickMapParams`` in csrc/frame_glue.cu (field order and
    types must match)."""
    _fields_ = [(name, ctypes.c_int) for name in (
        "mp", "mv", "mu", "CV", "CU", "CVp", "factor_v", "factor_u",
        "mp_span", "bp_p", "Np", "n_slabs", "dist_leap")] + [
        ("ds", ctypes.c_float)]


_SIGNATURES = {
    # (occ, out4, Z, Y, X, cap, stream)
    "vkv_scan_relax4": [_P, _P, _I, _I, _I, _I, _P],
    # (in4, out8, Z, Y, X, stream)
    "vkv_z_relax8": [_P, _P, _I, _I, _I, _P],
    # (occ, out, Z, Y, X, stream)
    "vkv_scan_relax2": [_P, _P, _I, _I, _I, _P],
    # (in, out, Z, Y, X, axis, dir, stream)
    "vkv_relax": [_P, _P, _I, _I, _I, _I, _I, _P],
    # (src, pos, out, params, src_u16, out_u16, column_src, transpose_out,
    #  stream)
    "vkv_resample_pass": [_P, _P, _P, PassParams, _I, _I, _I, _I, _P],
    # (wu, wv, s_lo, s_hi, cov, coarse, cskip, kb_occ, cnt, lst, params,
    #  stream)
    "vkv_brick_walk": [_P] * 10 + [BrickParams, _P],
    # (wu, wv, s_lo, s_hi, kappa, cov, vol, grad, cnt, lst, lum, alpha,
    #  firsts, nsamp, params, stream)
    "vkv_sweep_bricks": [_P] * 14 + [BrickParams, _P],
    # (wu, wv, s_lo, s_hi, cov, coarse, meta, cnt, lst, params, stream)
    "vkv_slab_walk": [_P] * 9 + [SlabParams, _P],
    # (wu, wv, s_lo, s_hi, kappa, cov, vol, grad, meta, cnt, lst, lum,
    #  alpha, firsts, nsamp, params, stream)
    "vkv_sweep_slabs": [_P] * 15 + [SlabParams, _P],
    # (src, gx, gy, out, C, Hi, Wi, H, W, paths, stream)
    "vkv_warp_pixels": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P],
    # (vol, grad or NULL, out, D, H, W, mz, my, mx, ti, tg, stream)
    "vkv_occupancy": [_P, _P, _P] + [_I] * 8 + [_P],
    # (wu, wv, s_lo, s_hi, kappa, cov, scalars, stream)
    "vkv_frame_grid": [_P] * 6 + [FrameScalars, _P],
    # (gx, gy, pos1, pos2, scalars, stream); unused outputs NULL
    "vkv_frame_positions": [_P] * 4 + [FrameScalars, _P],
    # (lum, alpha, firsts, chans, scalars, stream)
    "vkv_frame_epilogue": [_P] * 4 + [FrameScalars, _P],
    # (occ, coarse, cskip, flags, kb_occ, params, stream)
    "vkv_brick_maps": [_P] * 5 + [BrickMapParams, _P],
}


def load_kernels() -> ctypes.CDLL:
    """The kernel library, built on first use (raises with nvcc's stderr
    when the build fails)."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as fh:
            h.update(fh.read())
    os.makedirs(BUILD_DIR, exist_ok=True)
    so = os.path.join(BUILD_DIR, f"libvkvolume_kernels_{h.hexdigest()[:16]}.so")
    if not os.path.exists(so):
        nvcc = _nvcc()
        tmp = f"{so}.tmp{os.getpid()}"
        objs = [f"{tmp}.{os.path.basename(src)}.o" for src in sources]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(sources, objs)]
        logs = [(src, proc, proc.communicate()[0])
                for src, proc in zip(sources, procs)]
        build_log = "".join(f"== {os.path.basename(src)}\n{out}"
                            for src, _, out in logs)
        if any(proc.returncode for _, proc, _ in logs):
            raise RuntimeError(f"nvcc failed:\n{build_log}")
        proc = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", tmp,
                               *objs], capture_output=True, text=True)
        build_log += proc.stdout + proc.stderr
        for obj in objs:
            os.remove(obj)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{build_log}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def stream() -> int:
    """PyTorch's current CUDA stream as an integer handle."""
    return torch.cuda.current_stream().cuda_stream


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed (cudaError {err})")


def require_cuda(name: str, t: torch.Tensor, dtype: torch.dtype,
                 shape: tuple | None = None) -> None:
    """Device, dtype, shape and contiguity check of one kernel argument."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def require_aligned(name: str, t: torch.Tensor, nbytes: int) -> None:
    """A kernel reads ``t`` in words of ``nbytes``: its base must be
    aligned to them."""
    if t.data_ptr() % nbytes:
        raise ValueError(f"{name}: expected a base aligned to {nbytes} "
                         "bytes")
