"""Native (C++) host runtime: byte stuffing, the restart-scan finish and
the BMP pixel pass.

Counterpart of `jpegtpu/native`, with its own copy of the C++ source.
Compiled on demand with g++ into `build/jpegtpu_torch/` and loaded with
ctypes. Every entry point has a numpy twin (entropy.host.stuff_bytes,
entropy.host.scan_from_words, io.bmp's slicing path); callers use it
when g++ is missing.
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
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.jt_scan_from_words.restype = ctypes.c_size_t
        lib.jt_scan_from_words.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
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


def _counts_ptr(counts: np.ndarray | None):
    """The address of a chunk tally, or None (not counted)."""
    if counts is None:
        return None
    if (counts.dtype != np.int64 or counts.shape != (2,)
            or not counts.flags.c_contiguous or not counts.flags.writeable):
        raise ValueError("counts must be a writeable int64 array of 2")
    return counts.ctypes.data


def words_to_stuffed(words: np.ndarray, total_bits: int,
                     counts: np.ndarray | None = None) -> bytes:
    """Packed MSB-aligned uint32 word stream -> stuffed entropy bytes.

    The stuffer takes the stream 8 bytes a step; counts, an int64 array
    of 2 if given, gains the 8-byte chunks tested in [0] and those that
    held a 0xFF (stuffed a byte at a time) in [1]."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native runtime unavailable")
    words = np.ascontiguousarray(words, dtype=np.uint32)
    nbytes = (int(total_bits) + 7) // 8
    if words.size * 4 < nbytes:
        raise ValueError(f"{words.size} words hold fewer than {nbytes} bytes")
    out = np.empty(2 * nbytes + 4, dtype=np.uint8)
    n = lib.jt_words_to_stuffed(words.ctypes.data, int(total_bits),
                                out.ctypes.data, _counts_ptr(counts))
    return out[:n].tobytes()


def scan_from_words(words: np.ndarray, seg_bytes: np.ndarray,
                    rst_phase: int = 0, trailing: bool = False,
                    counts: np.ndarray | None = None) -> bytes:
    """One stitched word buffer of byte-aligned segments -> the full
    RST-delimited stuffed scan (stuff(seg_0) RST stuff(seg_1) RST ...) in
    one native pass. seg_bytes: per-segment byte lengths; rst_phase: the
    index of the marker after segment 0 (markers cycle RST0..RST7);
    trailing: also put a marker after the last segment (a scan that
    another buffer continues, as a shard's is by the next shard's);
    counts: as words_to_stuffed's, summed over the segments (a segment's
    chunks start at its first word boundary)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native runtime unavailable")
    words = np.ascontiguousarray(words, dtype=np.uint32)
    seg_bytes = np.ascontiguousarray(seg_bytes, dtype=np.int64)
    total = int(seg_bytes.sum())
    if words.size * 4 < total:
        raise ValueError(f"{words.size} words hold fewer than {total} bytes")
    out = np.empty(2 * total + 2 * seg_bytes.size + 4, dtype=np.uint8)
    n = lib.jt_scan_from_words(
        words.ctypes.data, seg_bytes.ctypes.data, seg_bytes.size,
        int(rst_phase), int(bool(trailing)), out.ctypes.data,
        _counts_ptr(counts),
    )
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
