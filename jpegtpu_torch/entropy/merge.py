"""K5 and K6: the color scan's MCU interleave (counterparts of
`jpegtpu/entropy/pallas_pack.py: merge_mcu_natural_pallas` and
`merge_streams_pallas`).

Per-block streams of the luma blocks (words [cap, ny], raster order over
the luma grid) and of the chroma blocks (words [cap, 2 * nmcu]: the Cb
blocks, then the Cr blocks, raster order over the MCU grid) -> one stream
per MCU: its fy x fx luma blocks in (dy, dx) order, then Cb, then Cr
(T.81 A.2.3), as words [E * cap, nmcu] (E = fy * fx + 2, words past the
MCU's bits zero) and bit counts [nmcu]. A block's bits count at most
cap * 32: a block past that overflowed and the encode retries at a
larger cap. Words travel as int32 bit patterns (see entropy.pack).

K5 (merge_mcu) reads the block streams where K4 left them, in raster
order. K6 (merge_streams) reads them slot-major, [E, cap, nmcu]: plane s
holds every MCU's s-th block (slot_major_streams gathers them so), the
layout of jpegtpu's non-raw color batch route. Both give the same MCU
streams. Both walk an MCU's streams in one thread through a funnel-shift
accumulator; K5 first copies the first 16 words of each of its blocks
into shared memory with asynchronous copies, all in flight together, and
walks them from there (csrc/merge.cu).
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..ops.blocks import sampling_factors, slots_per_mcu
from .pack import deposit, to_int32


def mcu_luma_blocks(nmch: int, nmcw: int, subsampling: str) -> torch.Tensor:
    """[fy * fx, nmcu] raster index of each MCU's luma blocks in scan
    order: (fy * my + dy) * nbw_y + fx * mx + dx."""
    fy, fx = sampling_factors(subsampling)
    my = torch.arange(nmch)[:, None]
    mx = torch.arange(nmcw)[None, :]
    return torch.stack([
        ((fy * my + dy) * (fx * nmcw) + fx * mx + dx).reshape(-1)
        for dy in range(fy) for dx in range(fx)
    ])


def merge_mcu(words_y: torch.Tensor, bits_y: torch.Tensor,
              words_c: torch.Tensor, bits_c: torch.Tensor, nmch: int,
              nmcw: int, subsampling: str):
    """-> (words [E * cap, nmcu] int32, bits [nmcu] int32).

    On CUDA tensors this launches csrc/merge.cu; on CPU tensors it runs
    `merge_mcu_plain`."""
    fy, fx = sampling_factors(subsampling)
    cap = words_y.shape[0]
    nmcu = nmch * nmcw
    if (words_y.shape != (cap, fy * fx * nmcu) or bits_y.shape != (
            fy * fx * nmcu,) or words_c.shape != (cap, 2 * nmcu)
            or bits_c.shape != (2 * nmcu,)):
        raise ValueError(
            f"bad shapes for {nmch}x{nmcw} MCUs ({subsampling}): words_y "
            f"{tuple(words_y.shape)}, bits_y {tuple(bits_y.shape)}, words_c "
            f"{tuple(words_c.shape)}, bits_c {tuple(bits_c.shape)}")
    if words_y.device.type == "cpu":
        return merge_mcu_plain(words_y, bits_y, words_c, bits_c, nmch, nmcw,
                               subsampling)
    for t, name in ((words_y, "words_y"), (bits_y, "bits_y"),
                    (words_c, "words_c"), (bits_c, "bits_c")):
        _build.require_cuda(t, name, torch.int32)
    mcap = slots_per_mcu(subsampling) * cap
    out = torch.empty((mcap, nmcu), dtype=torch.int32, device=words_y.device)
    bits = torch.empty((nmcu,), dtype=torch.int32, device=words_y.device)
    P, I = ctypes.c_void_p, ctypes.c_int
    _build.launch(
        "merge", "merge_mcu", (P, P, P, P, I, I, I, I, I, P, P),
        words_y.data_ptr(), bits_y.data_ptr(), words_c.data_ptr(),
        bits_c.data_ptr(), cap, nmch, nmcw, fy, fx, out.data_ptr(),
        bits.data_ptr(), device=words_y.device,
    )
    return out, bits


def merge_mcu_plain(words_y: torch.Tensor, bits_y: torch.Tensor,
                    words_c: torch.Tensor, bits_c: torch.Tensor, nmch: int,
                    nmcw: int, subsampling: str):
    """Plain PyTorch K5 (any device), the same function as the kernel:
    each MCU's E streams gathered slot-major, then merge_streams_plain."""
    return merge_streams_plain(*slot_major_streams(
        words_y, bits_y, words_c, bits_c, nmch, nmcw, subsampling))


def slot_major_streams(words_y: torch.Tensor, bits_y: torch.Tensor,
                       words_c: torch.Tensor, bits_c: torch.Tensor,
                       nmch: int, nmcw: int, subsampling: str):
    """K4's raster-order block streams (merge_mcu's arguments) -> the
    slot-major streams of an nmch x nmcw MCU grid: (words [E, cap, nmcu],
    bits [E, nmcu]), plane s holding every MCU's s-th block: the fy x fx
    luma blocks in (dy, dx) order, then Cb, then Cr. As jpegtpu's
    _y_slot_major, the luma planes are a transpose of the raster grid
    ([nmch, fy, nmcw, fx] -> [fy, fx, nmch, nmcw]), written once; the
    chroma planes are already slot-major."""
    fy, fx = sampling_factors(subsampling)
    cap, ky = words_y.shape[0], fy * fx
    nmcu = nmch * nmcw
    words = words_y.new_empty((ky + 2, cap, nmcu))
    words[:ky].view(fy, fx, cap, nmch, nmcw).copy_(
        words_y.view(cap, nmch, fy, nmcw, fx).permute(2, 4, 0, 1, 3))
    words[ky:].copy_(words_c.view(cap, 2, nmcu).transpose(0, 1))
    bits = torch.cat([
        bits_y.view(nmch, fy, nmcw, fx).permute(1, 3, 0, 2).reshape(ky, nmcu),
        bits_c.view(2, nmcu)])
    return words, bits


def merge_streams(words: torch.Tensor, bits: torch.Tensor):
    """K6: slot-major streams words [E, cap, M] int32 + bits [E, M] int32
    -> (words [E * cap, M] int32, bits [M] int32): for each MCU m the E
    streams words[s, :, m] back to back, MSB first, words past its bits
    zero.

    On CUDA tensors this launches csrc/merge.cu (merge_streams); on CPU
    tensors it runs `merge_streams_plain`."""
    if words.dim() != 3 or bits.shape != (words.shape[0], words.shape[2]):
        raise ValueError(f"bad slot-major shapes: words "
                         f"{tuple(words.shape)}, bits {tuple(bits.shape)}")
    if words.device.type == "cpu":
        return merge_streams_plain(words, bits)
    _build.require_cuda(words, "words", torch.int32)
    _build.require_cuda(bits, "bits", torch.int32)
    e, cap, m = words.shape
    out = torch.empty((e * cap, m), dtype=torch.int32, device=words.device)
    out_bits = torch.empty((m,), dtype=torch.int32, device=words.device)
    P, I = ctypes.c_void_p, ctypes.c_int
    _build.launch(
        "merge", "merge_streams", (P, P, I, I, I, P, P),
        words.data_ptr(), bits.data_ptr(), e, cap, m, out.data_ptr(),
        out_bits.data_ptr(), device=words.device,
    )
    return out, out_bits


def merge_streams_plain(words: torch.Tensor, bits: torch.Tensor):
    """Plain PyTorch K6 (any device), the same function as the kernel:
    every word of stream s deposited at the exclusive prefix sum of the
    bit counts before s (K4 stores the words past a block's bits as zero,
    so every word may be deposited)."""
    e, cap, m = words.shape
    b = bits.to(torch.int64).clamp(max=cap * 32).T  # [M, E]
    excl = torch.cumsum(b, dim=1) - b
    offs = excl[..., None] + 32 * torch.arange(cap, device=words.device)
    vals = (words.to(torch.int64) & 0xFFFFFFFF).permute(2, 0, 1)  # [M, E, cap]
    out = deposit(vals.reshape(m, -1),
                  torch.full_like(offs, 32).reshape(m, -1),
                  offs.reshape(m, -1), e * cap)
    return to_int32(out.T.contiguous()), b.sum(dim=1).to(torch.int32)
