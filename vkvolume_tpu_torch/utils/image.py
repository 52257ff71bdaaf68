"""Image output helpers (PNG snapshots; replaces the swapchain present) —
port of ``vkvolume_tpu/utils/image.py``.

The PNG codec is the standard library's (``zlib`` + ``struct``): 8-bit RGB,
one IDAT chunk, no row filters. It needs no imaging package, which the
GPU machines this port runs on may lack.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"


def composite_over(rgba: np.ndarray, background=(0.0, 0.0, 0.0)) -> np.ndarray:
    """Premultiplied rgba over a constant background → float rgb."""
    rgba = np.asarray(rgba, np.float32)
    bg = np.asarray(background, np.float32)
    return rgba[..., :3] + (1.0 - rgba[..., 3:4]) * bg


def to_u8(rgb: np.ndarray) -> np.ndarray:
    return np.clip(np.round(np.asarray(rgb, np.float32) * 255.0), 0, 255).astype(
        np.uint8
    )


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(rgb_or_rgba: np.ndarray) -> bytes:
    """An (H, W, 3) u8 image, or float rgb / premultiplied rgba (composited
    over black and rounded to u8), as the bytes of an 8-bit RGB PNG."""
    arr = np.asarray(rgb_or_rgba)
    if arr.dtype != np.uint8:
        if arr.ndim == 3 and arr.shape[-1] == 4:
            arr = to_u8(composite_over(arr))
        else:
            arr = to_u8(arr)
    if arr.ndim != 3 or arr.shape[-1] != 3:
        raise ValueError(f"expected an (H, W, 3) image, got {arr.shape}")
    h, w, _ = arr.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),       # filter: none
                           np.ascontiguousarray(arr).reshape(h, 3 * w)], 1)
    return (_PNG_SIG
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path: str, rgb_or_rgba: np.ndarray) -> None:
    """Write ``encode_png(rgb_or_rgba)`` to ``path``."""
    data = encode_png(rgb_or_rgba)
    with open(path, "wb") as f:
        f.write(data)


def read_png(path: str) -> np.ndarray:
    """Read back an 8-bit RGB PNG without row filters (what ``write_png``
    writes) as (H, W, 3) u8; raises on anything else."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: bad CRC in {kind!r}")
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        pos += 12 + n
    if hdr is None or hdr[2:] != (8, 2, 0, 0, 0):
        raise ValueError(f"{path}: not an 8-bit RGB PNG without interlace")
    w, h = hdr[0], hdr[1]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = rows.reshape(h, 3 * w + 1)
    if rows[:, 0].any():
        raise ValueError(f"{path}: row filters are not supported")
    return rows[:, 1:].reshape(h, w, 3).copy()
