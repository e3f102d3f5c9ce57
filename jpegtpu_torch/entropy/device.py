"""On-device entropy helpers around the kernels (counterpart of the parts
of `jpegtpu/entropy/device.py` and `jpegtpu/color_pipeline.py` the
single-image paths use): DC differences with restart resets, the symbol
histograms of 2-pass optimal coding, and the worst-case per-block
capacity. Plain PyTorch, as jpegtpu computes these in XLA outside any
kernel."""
from __future__ import annotations

import numpy as np
import torch

from ..ops.blocks import sampling_factors

# Worst-case entropy bits for one 8x8 block: DC <= 20 (luminance code +
# 11 amplitude bits), 63 AC lanes <= 16 + 10 each, <= 3 ZRLs of 11 bits,
# EOB 4. The terms cannot all co-occur, so this bounds every block. The
# chrominance tables stay inside it too: DC <= 11 + 11 = 22 bits, ZRL 10,
# EOB 2, so 22 + 63 * 26 + 3 * 10 + 2 = 1692 <= 1695. So do optimal
# tables, whose codes reach 16 bits (T.81 C): a block with k nonzero AC
# coefficients takes at most DC 16 + 11, k codes of 16 + 10, one 16-bit
# ZRL per 16 of its 63 - k zeros and a 16-bit EOB only when k < 63, so
# 27 + 26k + (63 - k) + 16 <= 1656 for k <= 62, and 27 + 63 * 26 = 1665
# for k = 63.
MAX_BITS_PER_BLOCK = 20 + 63 * 26 + 3 * 11 + 4  # = 1695
MAX_WORDS_PER_BLOCK = (MAX_BITS_PER_BLOCK + 31) // 32  # = 53


def dc_differences(dc: torch.Tensor, seg_len: int = 0) -> torch.Tensor:
    """DC difference along the last axis: one predictor chain per row,
    starting from 0 (T.81 F.1.2.1) and reset to 0 at every multiple of
    seg_len (a restart segment's first block or MCU, F.1.2.3; 0 = no
    restarts). Gray: [nb], the whole scan. Color: [2, nc], the Cb and Cr
    chains in MCU raster order."""
    prev = torch.nn.functional.pad(dc[..., :-1], (1, 0))
    if seg_len:
        first = torch.arange(dc.shape[-1], device=dc.device) % seg_len == 0
        prev = torch.where(first, 0, prev)
    return dc - prev


def y_dc_differences(dc: torch.Tensor, subsampling: str,
                     seg_mcus: int = 0) -> torch.Tensor:
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
    block, with the same wrap at col 0. With seg_mcus, the first luma
    block of every seg_mcus-th MCU (a restart segment's start) has
    predecessor 0."""
    r, c = dc.shape
    pad = torch.nn.functional.pad
    left = pad(dc[:, :-1], (1, 0))
    lastcol_up = pad(dc[:-1, -1], (1, 0))[:, None].expand(r, c)
    cols = torch.arange(c, device=dc.device)[None, :]
    rows = torch.arange(r, device=dc.device)[:, None]
    pred = torch.where(cols == 0, lastcol_up, left)
    if subsampling == "420":
        up_right = pad(dc[:-1, 1:], (0, 1, 1, 0))
        down_left = pad(dc[1:, :-1], (1, 0, 0, 1))
        pred = torch.where(cols % 2 == 1, left,
                           torch.where(rows % 2 == 1, up_right,
                                       torch.where(cols == 0, lastcol_up,
                                                   down_left)))
    if seg_mcus:
        fy, fx = sampling_factors(subsampling)
        mcu = (rows // fy) * (c // fx) + cols // fx
        first = (cols % fx == 0) & (rows % fy == 0) & (mcu % seg_mcus == 0)
        pred = torch.where(first, 0, pred)
    return dc - pred


# Layout of the flat per-table-class symbol counts symbol_histograms
# returns, one row per class (0 luminance, 1 chrominance).
HIST_DC = 0      # [12] DC size categories
HIST_AC = 12     # [176] AC (run, size) at run * 11 + size (size >= 1)
HIST_ZRL = 188
HIST_EOB = 189
HIST_SIZE = 190


def _size(v: torch.Tensor) -> torch.Tensor:
    """JPEG size category (bit length of |v|) of an int32 tensor with
    |v| < 2^24, as int32: the binary exponent of |v| in float32, which
    holds such integers exactly (frexp(0) gives 0)."""
    return torch.frexp(v.abs().float()).exponent


def symbol_histograms(levels: torch.Tensor, dc_diff: torch.Tensor,
                      table: int = 0) -> torch.Tensor:
    """Pass 1 of 2-pass optimal Huffman coding, on the levels' device
    (counterpart of jpegtpu.entropy.device.symbol_histograms): levels
    [64, nb] int32 + their DC differences [nb] -> int64 symbol counts
    [2, HIST_SIZE] with every count in row `table` (0 luminance,
    1 chrominance): DC size categories, AC (run, size) with size >= 1,
    ZRL and EOB, exactly the symbols K4 emits for these levels. Counts of
    several calls add. A bincount over run * 11 + size replaces jpegtpu's
    chunked one-hot einsum; the [63, nb] temporaries stay int32."""
    dev = levels.device
    ac = levels[1:]  # [63, nb]
    nz = ac != 0
    pos = torch.arange(1, 64, dtype=torch.int32, device=dev)[:, None]
    last = torch.cummax(torch.where(nz, pos, 0), dim=0).values
    prev = torch.nn.functional.pad(last[:-1], (0, 0, 1, 0))
    run = pos - prev - 1  # zeros since the previous nonzero (or DC)
    asize = _size(ac)
    dump = HIST_ZRL - HIST_AC  # symbols K4 never emits land here
    sym = torch.where(nz & (asize <= 10), (run & 15) * 11 + asize, dump)
    dsize = _size(dc_diff)
    counts = torch.zeros((2, HIST_SIZE), dtype=torch.int64, device=dev)
    counts[table, HIST_DC:HIST_AC] = torch.bincount(
        torch.where(dsize <= 11, dsize, 12), minlength=13)[:12]
    counts[table, HIST_AC:HIST_ZRL] = torch.bincount(
        sym.reshape(-1), minlength=dump + 1)[:dump]
    counts[table, HIST_ZRL] = torch.where(nz, run >> 4, 0).sum()
    counts[table, HIST_EOB] = (ac[62] == 0).sum()
    return counts


def assemble_histograms(counts) -> dict:
    """Host finish of symbol_histograms (one readback): counts
    [2, HIST_SIZE] on any device -> 256-bin histograms {'dc_lum',
    'ac_lum', 'dc_chrom', 'ac_chrom'} as tables.optimal_specs_from_
    frequencies takes them."""
    c = counts.cpu().numpy() if torch.is_tensor(counts) else np.asarray(counts)
    out = {}
    for t, kind in ((0, "lum"), (1, "chrom")):
        d = np.zeros(256, np.int64)
        d[:12] = c[t, HIST_DC:HIST_DC + 12]
        a = np.zeros(256, np.int64)
        ac = c[t, HIST_AC:HIST_AC + 176].reshape(16, 11)
        for r in range(16):
            a[(r << 4) + 1:(r << 4) + 11] = ac[r, 1:]
        a[0xF0] = c[t, HIST_ZRL]
        a[0x00] = c[t, HIST_EOB]
        out[f"dc_{kind}"] = d
        out[f"ac_{kind}"] = a
    return out
