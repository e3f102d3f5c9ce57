"""Native (C++) host runtime: byte stuffing and the BMP pixel pass.

Counterpart of `jpegtpu/native`, with its own copy of the C++ source.
Compiled on demand with g++ into `build/jpegtpu_torch/` and loaded with
ctypes. Every entry point has a numpy twin (entropy.host.stuff_bytes,
io.bmp's slicing path); callers use it when g++ is missing.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from .. import _build

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "bitpack.cpp")

_lock = threading.Lock()
_lib = None
_tried = False


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = os.path.join(_build.BUILD_DIR, "libjt_bitpack.so")
        try:
            _build.compile_if_stale(
                so, [_SRC], lambda out: ["g++", "-O3", "-shared", "-fPIC",
                                         "-o", out, _SRC],
            )
            lib = ctypes.CDLL(so)
        except (OSError, subprocess.CalledProcessError):
            return None
        lib.jt_stuff_bytes.restype = ctypes.c_size_t
        lib.jt_stuff_bytes.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
        ]
        lib.jt_words_to_stuffed.restype = ctypes.c_size_t
        lib.jt_words_to_stuffed.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ]
        lib.jt_bmp_to_rgb.restype = None
        lib.jt_bmp_to_rgb.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def stuff_bytes(raw: np.ndarray) -> bytes:
    """0xFF -> 0xFF 00 stuffing of a contiguous uint8 array."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native runtime unavailable")
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    out = np.empty(2 * raw.size + 1, dtype=np.uint8)
    n = lib.jt_stuff_bytes(raw.ctypes.data, raw.size, out.ctypes.data)
    return out[:n].tobytes()


def words_to_stuffed(words: np.ndarray, total_bits: int) -> bytes:
    """Packed MSB-aligned uint32 word stream -> stuffed entropy bytes."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native runtime unavailable")
    words = np.ascontiguousarray(words, dtype=np.uint32)
    nbytes = (int(total_bits) + 7) // 8
    if words.size * 4 < nbytes:
        raise ValueError(f"{words.size} words hold fewer than {nbytes} bytes")
    out = np.empty(2 * nbytes + 4, dtype=np.uint8)
    n = lib.jt_words_to_stuffed(words.ctypes.data, int(total_bits), out.ctypes.data)
    return out[:n].tobytes()


def bmp_to_rgb(px: np.ndarray, height: int, width: int, row_stride: int,
               top_down: bool) -> np.ndarray:
    """px: the raw (padded, possibly bottom-up BGR) BMP pixel section as
    uint8; returns RGB [H, W, 3]."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native runtime unavailable")
    px = np.ascontiguousarray(px, dtype=np.uint8)
    if px.size < row_stride * height:
        raise ValueError("pixel section shorter than height * row_stride")
    out = np.empty((height, width, 3), np.uint8)
    lib.jt_bmp_to_rgb(
        px.ctypes.data, height, width, row_stride, int(top_down),
        out.ctypes.data,
    )
    return out
