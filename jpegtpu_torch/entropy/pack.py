"""K4: fused symbolize + Huffman pack (counterpart of
`jpegtpu/entropy/pallas_pack.py: encode_blocks_pallas`, static and
runtime tables), and K7: the pack of pre-fused elements (counterpart of
`pallas_pack.py: pack_blocks_pallas`, the staged entropy path's packer).

Levels [64, nb] int32 (coefficient-major, raster block order), DC
differences [nb] and a [192] table (tables.huffman_table: Annex K, or
the 2-pass optimal codes of up to 16 bits, whose worst block fits 53
words: csrc/pack.cu) -> per-block MSB-first streams: words [cap, nb] and
bit counts [nb]. Stream words travel in int32 tensors holding the uint32
bit patterns (`.numpy().view(np.uint32)` reads them back); torch's uint32
lacks shifts and scatters on the CPU. At most `cap` words are kept per
block (`encode_blocks` takes caps up to MAX_WORDS_PER_BLOCK = 53), words
past its bits are zero, and the bit count is always the full one: bits >
cap * 32 flags overflow.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import _build, tables

_MASK32 = 0xFFFFFFFF

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
    if not 0 <= cap <= MAX_WORDS_PER_BLOCK:
        raise ValueError(f"cap {cap}: expected 0 to {MAX_WORDS_PER_BLOCK} "
                         "words, the most a block of the tables takes")
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


def pack_blocks(words_t: torch.Tensor, bits_t: torch.Tensor, cap: int):
    """K7: fused elements words_t [3, E, nb] int32 (uint32 patterns,
    MSB-aligned, zero past each element's bits) + bits_t [E, nb] int32
    (<= 96 each) -> (words [cap, nb] int32, bits [nb] int32, overflow, a
    0-dim bool tensor), as pack_blocks_pallas returns them: each block's
    elements back to back, MSB first, at most cap words kept (words past a
    block's bits are zero), the bit count always the full one, and
    overflow where a block has more than cap * 32 bits.

    On CUDA tensors this launches csrc/pack.cu (pack_blocks); on CPU
    tensors it runs `pack_blocks_plain`."""
    c0, e, nb = words_t.shape
    if c0 != 3 or bits_t.shape != (e, nb) or cap < 1:
        raise ValueError(f"bad shapes: words_t {tuple(words_t.shape)}, "
                         f"bits_t {tuple(bits_t.shape)}, cap {cap}")
    if words_t.device.type == "cpu":
        return pack_blocks_plain(words_t, bits_t, cap)
    _build.require_cuda(words_t, "words_t", torch.int32)
    _build.require_cuda(bits_t, "bits_t", torch.int32)
    words = torch.empty((cap, nb), dtype=torch.int32, device=words_t.device)
    bits = torch.empty((nb,), dtype=torch.int32, device=words_t.device)
    P, I = ctypes.c_void_p, ctypes.c_int
    _build.launch(
        "pack", "pack_blocks", (P, P, I, I, I, P, P),
        words_t.data_ptr(), bits_t.data_ptr(), e, nb, cap, words.data_ptr(),
        bits.data_ptr(), device=words_t.device,
    )
    return words, bits, (bits > cap * 32).any()


def pack_blocks_plain(words_t: torch.Tensor, bits_t: torch.Tensor, cap: int):
    """Plain PyTorch K7 (any device), the same function as the kernel:
    element offsets are an exclusive cumulative sum of the element bits,
    and `deposit` places every element word at its offset."""
    c0, e, nb = words_t.shape
    lens = bits_t.to(torch.int64).T  # [nb, E]
    offs = torch.cumsum(lens, dim=1) - lens
    vals = (words_t.to(torch.int64) & _MASK32).permute(2, 1, 0)  # [nb, E, 3]
    woffs = offs[..., None] + 32 * torch.arange(c0, device=words_t.device)
    words = deposit(vals.reshape(nb, -1),
                    torch.full_like(woffs, 32).reshape(nb, -1),
                    woffs.reshape(nb, -1), cap)
    bits = lens.sum(dim=1).to(torch.int32)
    return to_int32(words.T.contiguous()), bits, (bits > cap * 32).any()
