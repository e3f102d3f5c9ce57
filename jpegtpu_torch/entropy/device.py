"""On-device entropy helpers around the kernels (counterpart of the parts
of `jpegtpu/entropy/device.py` and `jpegtpu/color_pipeline.py` the
single-scan paths use): DC differences and the worst-case per-block
capacity. Plain PyTorch, as jpegtpu computes these in XLA outside any
kernel."""
from __future__ import annotations

import torch

# Worst-case entropy bits for one 8x8 block: DC <= 20 (luminance code +
# 11 amplitude bits), 63 AC lanes <= 16 + 10 each, <= 3 ZRLs of 11 bits,
# EOB 4. The terms cannot all co-occur, so this bounds every block. The
# chrominance tables stay inside it too: DC <= 11 + 11 = 22 bits, ZRL 10,
# EOB 2, so 22 + 63 * 26 + 3 * 10 + 2 = 1692 <= 1695.
MAX_BITS_PER_BLOCK = 20 + 63 * 26 + 3 * 11 + 4  # = 1695
MAX_WORDS_PER_BLOCK = (MAX_BITS_PER_BLOCK + 31) // 32  # = 53


def dc_differences(dc: torch.Tensor) -> torch.Tensor:
    """DC difference along the last axis: one predictor chain per row,
    starting from 0 (T.81 F.1.2.1). Gray: [nb], the whole scan. Color:
    [2, nc], the Cb and Cr chains in MCU raster order."""
    prev = torch.nn.functional.pad(dc[..., :-1], (1, 0))
    return dc - prev


def y_dc_differences(dc: torch.Tensor, subsampling: str) -> torch.Tensor:
    """Luma DC differences of a color scan (counterpart of jpegtpu's
    `color_pipeline._y_dc_diff_natural`): dc [R, C] raster Y-plane DCs ->
    differences along the interleaved scan's Y chain, still in [R, C]
    raster layout.

    4:2:0 visits each MCU's 2x2 Y blocks as Y00 Y01 Y10 Y11 (T.81 A.2.3),
    so a block's predecessor is one of a few fixed neighbours:
      col odd            -> left       dc[r, c-1]
      col even, row odd  -> up-right   dc[r-1, c+1]
      col even, row even -> down-left  dc[r+1, c-1]
        (col 0: the previous MCU row's last block dc[r-1, C-1]; the
         first block has predecessor 0)
    4:2:2 and 4:4:4 visit Y in raster order: the predecessor is the left
    block, with the same wrap at col 0."""
    r, c = dc.shape
    pad = torch.nn.functional.pad
    left = pad(dc[:, :-1], (1, 0))
    lastcol_up = pad(dc[:-1, -1], (1, 0))[:, None].expand(r, c)
    cols = torch.arange(c, device=dc.device)[None, :]
    pred = torch.where(cols == 0, lastcol_up, left)
    if subsampling == "420":
        rows = torch.arange(r, device=dc.device)[:, None]
        up_right = pad(dc[:-1, 1:], (0, 1, 1, 0))
        down_left = pad(dc[1:, :-1], (1, 0, 0, 1))
        pred = torch.where(cols % 2 == 1, left,
                           torch.where(rows % 2 == 1, up_right,
                                       torch.where(cols == 0, lastcol_up,
                                                   down_left)))
    return dc - pred
