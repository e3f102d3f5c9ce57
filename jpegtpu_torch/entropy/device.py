"""On-device entropy helpers around the kernels (counterpart of the parts
of `jpegtpu/entropy/device.py` the grayscale path uses): DC differences
and the worst-case per-block capacity."""
from __future__ import annotations

import torch

# Worst-case entropy bits for one 8x8 block: DC <= 20 (luminance code +
# 11 amplitude bits), 63 AC lanes <= 16 + 10 each, <= 3 ZRLs of 11 bits,
# EOB 4. The terms cannot all co-occur, so this bounds every block.
MAX_BITS_PER_BLOCK = 20 + 63 * 26 + 3 * 11 + 4  # = 1695
MAX_WORDS_PER_BLOCK = (MAX_BITS_PER_BLOCK + 31) // 32  # = 53


def dc_differences(dc: torch.Tensor) -> torch.Tensor:
    """DC difference along scan order: one predictor chain over the whole
    image, starting from 0 (T.81 F.1.2.1)."""
    prev = torch.cat([torch.zeros(1, dtype=dc.dtype, device=dc.device), dc[:-1]])
    return dc - prev
