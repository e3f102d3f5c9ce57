"""Color conversion (counterpart of `jpegtpu/ops/color.py`: the
grayscale path's luma)."""
from __future__ import annotations

import torch


def rgb_to_y_reference(rgb: torch.Tensor) -> torch.Tensor:
    """[..., 3] uint8 -> [...] uint8 luma via the reference's integer
    approximation Y = (77 R + 150 G + 29 B) >> 8."""
    r = rgb[..., 0].to(torch.int32)
    g = rgb[..., 1].to(torch.int32)
    b = rgb[..., 2].to(torch.int32)
    return ((77 * r + 150 * g + 29 * b) >> 8).to(torch.uint8)


def level_shift(y: torch.Tensor) -> torch.Tensor:
    """uint8 -> int32 centered at zero."""
    return y.to(torch.int32) - 128
