"""Block layout helpers (counterpart of `jpegtpu/ops/blocks.py`).

Pad-to-multiple-of-8 with edge replication: the reference clamps source
coordinates, which is exactly edge-replicate padding.
"""
from __future__ import annotations

import numpy as np


def padded_dims(height: int, width: int, multiple: int = 8) -> tuple[int, int]:
    return (
        (height + multiple - 1) // multiple * multiple,
        (width + multiple - 1) // multiple * multiple,
    )


def pad_edge(img: np.ndarray, multiple: int = 8) -> np.ndarray:
    """Edge-replicate pad a [H, W] (or [H, W, C]) image so H, W are
    multiples. Runs on the host, before the image goes to the device, as
    in jpegtpu."""
    h, w = img.shape[0], img.shape[1]
    ph, pw = padded_dims(h, w, multiple)
    if ph == h and pw == w:
        return img
    pad = [(0, ph - h), (0, pw - w)] + [(0, 0)] * (img.ndim - 2)
    return np.pad(img, pad, mode="edge")
