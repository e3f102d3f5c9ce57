"""BMP container I/O (host side, numpy; counterpart of `jpegtpu/io/bmp.py`).

Capabilities match the reference loader (natural_c/src/io/bmp_handler.c):
24-bit uncompressed BMPs, 'BM' magic check, 4-byte row padding, BGR order,
bottom-up unless height < 0. The writer emits the same format the reference
writer does (bottom-up BGR24, 2835 px/m resolution, bmp_handler.c:131-211).

The pixel pass runs in the native runtime when it builds, else as
vectorized numpy slicing.
"""
from __future__ import annotations

import struct

import numpy as np

_BMP_MAGIC = 0x4D42  # 'BM'


class BMPError(ValueError):
    pass


def decode(data: bytes) -> np.ndarray:
    """Decode a 24-bit BMP byte string to an RGB uint8 array [H, W, 3]."""
    if len(data) < 54:
        raise BMPError("file too small for BMP headers")
    magic, _fsize, _res, offset = struct.unpack_from("<HIII", data, 0)
    if magic != _BMP_MAGIC:
        raise BMPError(f"bad magic 0x{magic:04X}, expected 0x4D42 ('BM')")
    (header_size, width, height, _planes, bpp, compression) = struct.unpack_from(
        "<IiihHI", data, 14
    )
    del header_size
    if bpp != 24:
        raise BMPError(f"only 24-bit BMPs supported, got {bpp}-bit")
    if compression != 0:
        raise BMPError(f"only uncompressed BMPs supported, got compression={compression}")

    top_down = height < 0
    height = abs(height)
    if width <= 0 or height <= 0:
        raise BMPError(f"bad dimensions {width}x{height}")

    row_stride = (width * 3 + 3) & ~3  # rows padded to 4 bytes
    need = offset + row_stride * height
    if len(data) < need:
        raise BMPError(f"truncated pixel data: have {len(data)}, need {need}")

    raw = np.frombuffer(data, dtype=np.uint8, count=row_stride * height, offset=offset)
    from .. import native

    if native.available():
        # C++ single-pass flip + BGR->RGB swizzle (the reference
        # loader's pixel loop, bmp_handler.c:60-104, at memory speed).
        return native.bmp_to_rgb(raw, height, width, row_stride, top_down)
    rows = raw.reshape(height, row_stride)[:, : width * 3].reshape(height, width, 3)
    if not top_down:
        rows = rows[::-1]
    return rows[..., ::-1].copy()  # BGR -> RGB, contiguous


def encode(rgb: np.ndarray) -> bytes:
    """Encode an RGB uint8 array [H, W, 3] as a 24-bit bottom-up BMP."""
    if rgb.ndim != 3 or rgb.shape[2] != 3 or rgb.dtype != np.uint8:
        raise BMPError(f"expected uint8 [H, W, 3], got {rgb.dtype} {rgb.shape}")
    h, w = rgb.shape[:2]
    row_stride = (w * 3 + 3) & ~3
    pixel_bytes = row_stride * h
    offset = 54

    header = struct.pack(
        "<HIII", _BMP_MAGIC, offset + pixel_bytes, 0, offset
    ) + struct.pack(
        "<IiihHIIiiII",
        40, w, h, 1, 24, 0, pixel_bytes, 2835, 2835, 0, 0,
    )
    body = np.zeros((h, row_stride), dtype=np.uint8)
    body[:, : w * 3] = rgb[::-1, :, ::-1].reshape(h, w * 3)  # bottom-up BGR
    return header + body.tobytes()


def read(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode(f.read())


def write(path: str, rgb: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode(rgb))
