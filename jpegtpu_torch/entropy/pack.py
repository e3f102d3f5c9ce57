"""K4: fused symbolize + Huffman pack (counterpart of
`jpegtpu/entropy/pallas_pack.py: encode_blocks_pallas`, static table).

Levels [64, nb] int32 (coefficient-major, raster block order) and DC
differences [nb] -> per-block MSB-first streams: words [cap, nb] and bit
counts [nb]. Stream words travel in int32 tensors holding the uint32 bit
patterns (`.numpy().view(np.uint32)` reads them back); torch's uint32
lacks shifts and scatters on the CPU. At most `cap` words are kept per
block, words past its bits are zero, and the bit count is always the full
one: bits > cap * 32 flags overflow.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import _build, tables

_MASK32 = 0xFFFFFFFF


def encode_blocks(levels: torch.Tensor, dc_diff: torch.Tensor,
                  huff: torch.Tensor, cap: int):
    """-> (words [cap, nb] int32, bits [nb] int32).

    On CUDA tensors this launches csrc/pack.cu; on CPU tensors it runs
    `encode_blocks_plain`."""
    nb = levels.shape[1]
    if levels.shape[0] != 64 or dc_diff.shape != (nb,) or huff.shape != (
        tables.HUFF_SIZE,
    ):
        raise ValueError(
            f"bad shapes: levels {tuple(levels.shape)}, dc_diff "
            f"{tuple(dc_diff.shape)}, huff {tuple(huff.shape)}"
        )
    if levels.device.type == "cpu":
        return encode_blocks_plain(levels, dc_diff, huff, cap)
    for t, name in ((levels, "levels"), (dc_diff, "dc_diff"), (huff, "huff")):
        _build.require_cuda(t, name, torch.int32)
    words = torch.empty((cap, nb), dtype=torch.int32, device=levels.device)
    bits = torch.empty((nb,), dtype=torch.int32, device=levels.device)
    P, I = ctypes.c_void_p, ctypes.c_int
    _build.launch(
        "pack", "encode_blocks", (P, P, P, I, I, P, P),
        levels.data_ptr(), dc_diff.data_ptr(), huff.data_ptr(), nb, cap,
        words.data_ptr(), bits.data_ptr(), device=levels.device,
    )
    return words, bits


def to_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding uint32 values -> int32 with the same bit pattern."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _bit_length(mag: torch.Tensor) -> torch.Tensor:
    """Size category: bit length of a non-negative int64 (< 2^31)."""
    size = torch.zeros_like(mag)
    for k in range(31):
        size += (mag >= (1 << k)).to(mag.dtype)
    return size


def _amplitude(v: torch.Tensor, size: torch.Tensor) -> torch.Tensor:
    """v, or v - 1 for negative v, masked to size bits."""
    return torch.where(v > 0, v, v - 1) & ((torch.ones_like(size) << size) - 1)


def deposit(vals, lens, offs, n_words: int):
    """Deposit codes (vals [..., n] int64 < 2^lens, lens <= 32) MSB-first at
    bit offsets offs along the last axis of a zeroed [..., n_words] int64
    word array. Codes never share bits, so the OR is a sum (index_add_).
    Bits past n_words are dropped."""
    lead = vals.shape[:-1]
    msb = vals << (32 - lens)  # left-aligned in 32 bits (len 0: val 0)
    r = offs & 31
    hi = msb >> r
    lo = torch.where(r > 0, (msb << (32 - r).clamp(max=31)) & _MASK32, 0)
    # each row gets two spare words that collect what falls past n_words
    width = n_words + 2
    rows = math.prod(lead)
    base = (torch.arange(rows, device=vals.device) * width).reshape(*lead, 1)
    idx = (base + (offs >> 5).clamp(max=n_words)).reshape(-1)
    flat = torch.zeros(rows * width, dtype=torch.int64, device=vals.device)
    flat.index_add_(0, idx, hi.reshape(-1))
    flat.index_add_(0, idx + 1, lo.reshape(-1))
    return flat.reshape(*lead, width)[..., :n_words]


def encode_blocks_plain(levels: torch.Tensor, dc_diff: torch.Tensor,
                        huff: torch.Tensor, cap: int):
    """Plain PyTorch K4 (any device), the same function as the kernel.

    Every block's emission order is laid out as slots: DC, then per AC
    coefficient up to three ZRLs and its (run, size) code, then EOB. Slot
    bit offsets are a cumulative sum; `deposit` places them in words."""
    dev = levels.device
    h = huff.to(dev, torch.int64)
    lv = levels.to(torch.int64).T  # [nb, 64]
    nb = lv.shape[0]

    d = dc_diff.to(torch.int64)
    dsize = _bit_length(d.abs())
    dpk = h[tables.HUFF_DC + torch.where(dsize <= 11, dsize, 0)]
    dc_val = ((dpk >> 6) << dsize) | _amplitude(d, dsize)
    dc_len = (dpk & 63) + dsize

    ac = lv[:, 1:]  # [nb, 63]
    nz = ac != 0
    pos = torch.arange(1, 64, device=dev).expand(nb, 63)
    last = torch.cummax(torch.where(nz, pos, 0), dim=1).values
    prev = torch.cat([torch.zeros(nb, 1, dtype=torch.int64, device=dev),
                      last[:, :-1]], dim=1)
    run = pos - prev - 1  # zeros since the previous nonzero (or DC)
    size = _bit_length(ac.abs())
    pk = h[tables.HUFF_AC + (run & 15) * 11 + torch.where(size <= 10, size, 0)]
    sym_val = torch.where(nz, ((pk >> 6) << size) | _amplitude(ac, size), 0)
    sym_len = torch.where(nz, (pk & 63) + size, 0)
    n_zrl = torch.where(nz, run >> 4, 0)
    zrl = torch.stack(
        [torch.where(n_zrl > z, h[tables.HUFF_ZRL + 1], 0) for z in range(3)],
        dim=-1,
    )  # [nb, 63, 3] lengths
    eob_len = torch.where(ac[:, 62] == 0, h[tables.HUFF_EOB + 1], 0)

    lens = torch.cat([
        dc_len[:, None],
        torch.cat([zrl, sym_len[..., None]], dim=-1).reshape(nb, 63 * 4),
        eob_len[:, None],
    ], dim=1)
    vals = torch.cat([
        dc_val[:, None],
        torch.cat([torch.where(zrl > 0, h[tables.HUFF_ZRL], 0),
                   sym_val[..., None]], dim=-1).reshape(nb, 63 * 4),
        torch.where(eob_len > 0, h[tables.HUFF_EOB], 0)[:, None],
    ], dim=1)
    offs = torch.cumsum(lens, dim=1) - lens
    words = deposit(vals, lens, offs, cap)
    bits = lens.sum(dim=1)
    return to_int32(words.T.contiguous()), bits.to(torch.int32)
