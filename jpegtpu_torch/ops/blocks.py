"""Block layout helpers (counterpart of `jpegtpu/ops/blocks.py`, and of
the MCU geometry in `jpegtpu/color_pipeline.py`).

Pad-to-multiple-of-8 (or of the MCU) with edge replication, in place in
a staging buffer (copy_into, pad_in_place; io.transfer): the reference
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


COPY_THREADS = 4  # host threads that copy images into staging memory
_BAND_ROWS = 256  # rows a copying thread takes at a time


def copy_into(slots, images, pool=None) -> None:
    """Copy each image ([H, W] or [H, W, C]; [H, W] into a 3-channel slot
    is repeated to each channel) into the top left corner of its slot
    (slots[i], as large or larger). With a thread pool, the bands of rows
    of all the images copy in parallel, COPY_THREADS lists of bands
    (numpy lets go of the GIL while it copies)."""
    bands = [(slot, image[..., None] if slot.ndim > image.ndim else image, lo)
             for slot, image in zip(slots, images)
             for lo in range(0, image.shape[0], _BAND_ROWS)]

    def run(part):
        for slot, src, lo in part:
            hi = min(lo + _BAND_ROWS, src.shape[0])
            slot[lo:hi, :src.shape[1]] = src[lo:hi]

    if pool is None:
        run(bands)
    else:
        list(pool.map(run, [bands[k::COPY_THREADS]
                            for k in range(COPY_THREADS)]))


def pad_in_place(dst: np.ndarray, h: int, w: int) -> None:
    """Edge-replicate dst[:h, :w] over the rest of dst, as np.pad's "edge"
    mode does: the columns right, then the rows below, corners from the
    last pixel."""
    if w < dst.shape[1]:
        dst[:h, w:] = dst[:h, w - 1:w]
    if h < dst.shape[0]:
        dst[h:] = dst[h - 1:h]
