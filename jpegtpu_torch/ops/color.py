"""Color conversion and chroma subsampling (counterpart of
`jpegtpu/ops/color.py`), in plain PyTorch on any device.

Two luma paths, as in jpegtpu:
  * `rgb_to_y_reference`: the reference's integer approximation
    Y = (77 R + 150 G + 29 B) >> 8 (the grayscale path's luma);
  * `rgb_to_ycbcr`: full-range JFIF/BT.601 YCbCr in 16-bit fixed point
    (the color path).
The color path's kernels (ops.transform, K2 and K3) fuse this arithmetic
into the transform; these functions are their plain versions' first step.
"""
from __future__ import annotations

import torch

# 16-bit fixed-point JFIF weights (R, G, B) and the rounding bias
_Y_W = (19595, 38470, 7471)
_CB_W = (-11059, -21709, 32768)
_CR_W = (32768, -27439, -5329)
_HALF = 1 << 15


def rgb_to_y_reference(rgb: torch.Tensor) -> torch.Tensor:
    """[..., 3] uint8 -> [...] uint8 luma via the reference's integer
    approximation Y = (77 R + 150 G + 29 B) >> 8."""
    r = rgb[..., 0].to(torch.int32)
    g = rgb[..., 1].to(torch.int32)
    b = rgb[..., 2].to(torch.int32)
    return ((77 * r + 150 * g + 29 * b) >> 8).to(torch.uint8)


def rgb_to_ycbcr(rgb: torch.Tensor) -> torch.Tensor:
    """[..., 3] uint8 -> [..., 3] uint8 full-range JFIF YCbCr:
    Y = (19595 R + 38470 G + 7471 B + 2^15) >> 16, Cb and Cr likewise with
    their weights, + 128 and clipped to [0, 255] (arithmetic shifts)."""
    r = rgb[..., 0].to(torch.int32)
    g = rgb[..., 1].to(torch.int32)
    b = rgb[..., 2].to(torch.int32)

    def channel(w):
        return (w[0] * r + w[1] * g + w[2] * b + _HALF) >> 16

    return torch.stack([
        channel(_Y_W),
        (channel(_CB_W) + 128).clamp(0, 255),
        (channel(_CR_W) + 128).clamp(0, 255),
    ], dim=-1).to(torch.uint8)


def subsample(chan: torch.Tensor, fy: int, fx: int) -> torch.Tensor:
    """Box-filter subsampling of a [H, W] uint8 plane by fy x fx (H, W
    multiples): s = the sum of each window, (s + n/2) >> log2(n) with
    n = fy * fx, rounding to nearest as libjpeg's box filter does
    (jpegtpu's subsample_420 is 2 x 2, subsample_422 1 x 2)."""
    h, w = chan.shape
    n = fy * fx
    s = chan.to(torch.int32).reshape(h // fy, fy, w // fx, fx).sum((1, 3))
    return ((s + n // 2) >> (n.bit_length() - 1)).to(torch.uint8)


def level_shift(y: torch.Tensor) -> torch.Tensor:
    """uint8 -> int32 centered at zero."""
    return y.to(torch.int32) - 128
