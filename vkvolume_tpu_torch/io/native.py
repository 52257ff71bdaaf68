"""ctypes binding to the native C++ loader (``native/loader.cpp``).

The JAX package's ``vkvolume_tpu/io/native.py``, unchanged: host numpy
(and ctypes) only, shared by both packages' file formats.

The reference does its IO in C++ (read in 100 MB chunks, boost::endian swap,
normalise; src/load_volume.cpp:112-172). Our native equivalent performs the
read + endian swap + normalisation in one multithreaded pass. If the shared
library has not been built, callers fall back to the numpy path.

Build with ``make -C native`` (produces ``native/libvkvol_io.so``).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None
_TRIED = False

_DTYPE_CODES = {"uint8_t": 0, "int8_t": 1, "uint16_t": 2, "int16_t": 3}


def _find_lib():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    for cand in (
        os.path.join(here, "native", "libvkvol_io.so"),
        os.path.join(os.path.dirname(__file__), "libvkvol_io.so"),
    ):
        if os.path.exists(cand):
            try:
                lib = ctypes.CDLL(cand)
                lib.vkvol_load_normalised.restype = ctypes.c_int
                lib.vkvol_load_normalised.argtypes = [
                    ctypes.c_char_p,      # path
                    ctypes.c_longlong,    # n_voxels
                    ctypes.c_int,         # dtype code
                    ctypes.c_int,         # big_endian
                    ctypes.c_float,       # lo
                    ctypes.c_float,       # hi
                    ctypes.POINTER(ctypes.c_uint8),  # out
                ]
                _LIB = lib
                break
            except OSError:
                continue
    return _LIB


def available() -> bool:
    return _find_lib() is not None


def load_normalised(path, header) -> np.ndarray | None:
    """Native single-pass load; returns None when the library is unavailable."""
    lib = _find_lib()
    if lib is None:
        return None
    out = np.empty(header.n_voxels, dtype=np.uint8)
    lo, hi = header.normalisation_range
    rc = lib.vkvol_load_normalised(
        str(path).encode(),
        header.n_voxels,
        _DTYPE_CODES[header.dtype],
        1 if header.endianness == "big" else 0,
        np.float32(lo),
        np.float32(hi),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    if rc != 0:
        raise IOError(f"native loader failed with code {rc} for {path}")
    return out
