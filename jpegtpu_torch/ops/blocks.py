"""Block layout helpers (counterpart of `jpegtpu/ops/blocks.py`, and of
the MCU geometry in `jpegtpu/color_pipeline.py`).

Pad-to-multiple-of-8 (or of the MCU) with edge replication: the reference
clamps source coordinates, which is exactly edge-replicate padding.

A color MCU (T.81 A.2.3) covers fy x fx luma blocks and one Cb and one Cr
block: 4:2:0 is 2 x 2, 4:2:2 is 1 x 2, 4:4:4 is 1 x 1.
"""
from __future__ import annotations

import numpy as np


_FACTORS = {"420": (2, 2), "422": (1, 2), "444": (1, 1)}


def sampling_factors(subsampling: str) -> tuple[int, int]:
    """(fy, fx): luma blocks per MCU down and across."""
    return _FACTORS[subsampling]


def slots_per_mcu(subsampling: str) -> int:
    """Blocks per MCU: fy * fx luma, one Cb, one Cr."""
    fy, fx = sampling_factors(subsampling)
    return fy * fx + 2


def mcu_dims(subsampling: str) -> tuple[int, int]:
    fy, fx = sampling_factors(subsampling)
    return 8 * fy, 8 * fx


def padded_dims_color(h: int, w: int, subsampling: str) -> tuple[int, int]:
    mh, mw = mcu_dims(subsampling)
    return -(-h // mh) * mh, -(-w // mw) * mw


def pad_edge(img: np.ndarray, mh: int = 8, mw: int = 8) -> np.ndarray:
    """Edge-replicate pad a [H, W] (or [H, W, C]) image so H is a
    multiple of mh and W of mw (a block, or a color MCU: `mcu_dims`).
    Runs on the host, before the image goes to the device, as in jpegtpu."""
    h, w = img.shape[0], img.shape[1]
    ph, pw = -(-h // mh) * mh, -(-w // mw) * mw
    if ph == h and pw == w:
        return img
    pad = [(0, ph - h), (0, pw - w)] + [(0, 0)] * (img.ndim - 2)
    return np.pad(img, pad, mode="edge")
