"""JPEG constant tables, canonical Huffman codes, and the encoder state.

Counterpart of `jpegtpu/tables.py` (its standard tables): the ITU-T T.81
Annex-K luminance and chrominance quantization and Huffman tables,
IJG quality scaling, the zigzag permutation, and both DCT bases. These
are numpy, as in jpegtpu; `encoder_state_from_numpy` turns them into the
small device tensors the port's kernels read.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Quantization table (Annex K; raster order, row-major u*8+v)
# ---------------------------------------------------------------------------

STD_LUMINANCE_QUANT = np.array(
    [
        16, 11, 10, 16, 24, 40, 51, 61,
        12, 12, 14, 19, 26, 58, 60, 55,
        14, 13, 16, 24, 40, 57, 69, 56,
        14, 17, 22, 29, 51, 87, 80, 62,
        18, 22, 37, 56, 68, 109, 103, 77,
        24, 35, 55, 64, 81, 104, 113, 92,
        49, 64, 78, 87, 103, 121, 120, 101,
        72, 92, 95, 98, 112, 100, 103, 99,
    ],
    dtype=np.uint8,
).reshape(8, 8)

STD_CHROMINANCE_QUANT = np.array(
    [
        17, 18, 24, 47, 99, 99, 99, 99,
        18, 21, 26, 66, 99, 99, 99, 99,
        24, 26, 56, 99, 99, 99, 99, 99,
        47, 66, 99, 99, 99, 99, 99, 99,
        99, 99, 99, 99, 99, 99, 99, 99,
        99, 99, 99, 99, 99, 99, 99, 99,
        99, 99, 99, 99, 99, 99, 99, 99,
        99, 99, 99, 99, 99, 99, 99, 99,
    ],
    dtype=np.uint8,
).reshape(8, 8)


def quality_scaled_table(base: np.ndarray, quality: int) -> np.ndarray:
    """IJG quality scaling: maps Q in [1, 100] onto a base table.

    Q50 returns the base table unchanged. Entries are clamped to [1, 255]
    (8-bit DQT precision).
    """
    if not 1 <= quality <= 100:
        raise ValueError(f"quality must be in [1, 100], got {quality}")
    if quality < 50:
        scale = 5000 // quality
    else:
        scale = 200 - 2 * quality
    tbl = (base.astype(np.int32) * scale + 50) // 100
    return np.clip(tbl, 1, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# Zigzag permutation: ZIGZAG_ORDER[i] = raster index of the i-th
# coefficient in zigzag scan order.
# ---------------------------------------------------------------------------

def _make_zigzag_order() -> np.ndarray:
    order = np.empty(64, dtype=np.int32)
    r = c = 0
    for i in range(64):
        order[i] = r * 8 + c
        if (r + c) % 2 == 0:  # moving up-right
            if c == 7:
                r += 1
            elif r == 0:
                c += 1
            else:
                r -= 1
                c += 1
        else:  # moving down-left
            if r == 7:
                c += 1
            elif c == 0:
                r += 1
            else:
                r += 1
                c -= 1
    return order


ZIGZAG_ORDER = _make_zigzag_order()

# ---------------------------------------------------------------------------
# Huffman table specifications (Annex K): bits[l] = number of codes of
# length l+1, values = symbols in canonical order.
# ---------------------------------------------------------------------------

STD_DC_LUMINANCE_BITS = np.array(
    [0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], dtype=np.uint8
)
STD_DC_LUMINANCE_VALUES = np.arange(12, dtype=np.uint8)

STD_AC_LUMINANCE_BITS = np.array(
    [0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], dtype=np.uint8
)
STD_AC_LUMINANCE_VALUES = np.array(
    [
        0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12,
        0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07,
        0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08,
        0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0,
        0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16,
        0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
        0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
        0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49,
        0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
        0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69,
        0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79,
        0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
        0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98,
        0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7,
        0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
        0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5,
        0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4,
        0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
        0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA,
        0xF1, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8,
        0xF9, 0xFA,
    ],
    dtype=np.uint8,
)

STD_DC_CHROMINANCE_BITS = np.array(
    [0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], dtype=np.uint8
)
STD_DC_CHROMINANCE_VALUES = np.arange(12, dtype=np.uint8)

STD_AC_CHROMINANCE_BITS = np.array(
    [0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], dtype=np.uint8
)
STD_AC_CHROMINANCE_VALUES = np.array(
    [
        0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21,
        0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71,
        0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
        0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0,
        0x15, 0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34,
        0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26,
        0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38,
        0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48,
        0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
        0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68,
        0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78,
        0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
        0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96,
        0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5,
        0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4,
        0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3,
        0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2,
        0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA,
        0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9,
        0xEA, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8,
        0xF9, 0xFA,
    ],
    dtype=np.uint8,
)


def canonical_codes(bits: np.ndarray, values: np.ndarray, table_size: int = 256):
    """Canonical Huffman codes from a (bits, values) spec (T.81 Annex C).

    Returns (codes, lengths) as uint32/uint8 arrays of `table_size` entries
    indexed by symbol byte. Unused symbols have length 0.
    """
    codes = np.zeros(table_size, dtype=np.uint32)
    lengths = np.zeros(table_size, dtype=np.uint8)
    code = 0
    idx = 0
    for length in range(1, 17):
        for _ in range(int(bits[length - 1])):
            sym = int(values[idx])
            codes[sym] = code
            lengths[sym] = length
            code += 1
            idx += 1
        code <<= 1
    return codes, lengths


@functools.lru_cache(maxsize=None)
def huffman_luts():
    """The four standard tables as dense (codes, lengths) LUTs, keyed
    'dc_lum', 'ac_lum', 'dc_chrom', 'ac_chrom' (jpegtpu.tables.huffman_luts'
    keys)."""
    return {
        "dc_lum": canonical_codes(STD_DC_LUMINANCE_BITS, STD_DC_LUMINANCE_VALUES),
        "ac_lum": canonical_codes(STD_AC_LUMINANCE_BITS, STD_AC_LUMINANCE_VALUES),
        "dc_chrom": canonical_codes(STD_DC_CHROMINANCE_BITS,
                                    STD_DC_CHROMINANCE_VALUES),
        "ac_chrom": canonical_codes(STD_AC_CHROMINANCE_BITS,
                                    STD_AC_CHROMINANCE_VALUES),
    }


# ---------------------------------------------------------------------------
# DCT bases
# ---------------------------------------------------------------------------

def dct_basis(dtype=np.float32) -> np.ndarray:
    """Orthonormal 8-point DCT-II basis T with F = T @ X @ T.T.

    T[u, x] = 0.5 * c(u) * cos((2x+1) u pi / 16), c(0) = 1/sqrt(2).
    Computed in float64 then cast.
    """
    u = np.arange(8, dtype=np.float64)[:, None]
    x = np.arange(8, dtype=np.float64)[None, :]
    t = 0.5 * np.cos((2.0 * x + 1.0) * u * np.pi / 16.0)
    t[0] *= 1.0 / np.sqrt(2.0)
    return t.astype(dtype)


# The reference encoder's cosine LUT: cosf((2x+1) u pi/16) printed to 6
# decimals, indexed [x][u]. Its last-digit asymmetries (e.g. -0.382684 vs
# 0.382683) matter for bit-parity of the quantized coefficients, so it is
# an explicit constant rather than derived.
_REFERENCE_COS_LUT = np.array(
    [
        [1.0, 0.980785, 0.923880, 0.831470, 0.707107, 0.555570, 0.382683, 0.195090],
        [1.0, 0.831470, 0.382683, -0.195090, -0.707107, -0.980785, -0.923880, -0.555570],
        [1.0, 0.555570, -0.382683, -0.980785, -0.707107, 0.195090, 0.923880, 0.831470],
        [1.0, 0.195090, -0.923880, -0.555570, 0.707107, 0.831470, -0.382683, -0.980785],
        [1.0, -0.195090, -0.923880, 0.555570, 0.707107, -0.831470, -0.382684, 0.980785],
        [1.0, -0.555570, -0.382684, 0.980785, -0.707107, -0.195090, 0.923880, -0.831470],
        [1.0, -0.831470, 0.382684, 0.195091, -0.707107, 0.980785, -0.923879, 0.555570],
        [1.0, -0.980785, 0.923880, -0.831470, 0.707107, -0.555570, 0.382684, -0.195090],
    ],
    dtype=np.float64,
)


def dct_basis_reference(dtype=np.float32) -> np.ndarray:
    """DCT basis folding in the reference encoder's exact LUT values:
    T[u, x] = 0.5 * C_LUT[u] * COS_LUT[x][u] with its 6-decimal literals."""
    c = np.full(8, 1.0, dtype=np.float64)
    c[0] = 0.707107
    t = 0.5 * c[:, None] * _REFERENCE_COS_LUT.T
    return t.astype(dtype)


# ---------------------------------------------------------------------------
# Encoder state: the tensors the kernels read
# ---------------------------------------------------------------------------

INT_FRAC = 11  # fixed-point bits of the int32-mode DCT basis

# Layout of the packed Huffman table (jpegtpu pallas_pack.pack_runtime_tables):
# entry = (code << 6) | length.
HUFF_AC = 0      # [176]: (run, size) at run * 11 + size
HUFF_DC = 176    # [12]: DC size category
HUFF_ZRL = 188   # ZRL code, then its length at 189
HUFF_EOB = 190   # EOB code, then its length at 191
HUFF_SIZE = 192


class EncoderState(NamedTuple):
    """What the kernels read, on one device.

    quant: int32 [64] luminance quantization table, raster order.
    basis: float32 [8, 8] DCT basis (float mode).
    basis_int: int32 [8, 8] = round(basis * 2^11) (int32 mode).
    huff: int32 [192] packed luminance Huffman table (layout above).
    chroma_quant: int32 [64] chrominance quantization table.
    huff_chroma: int32 [192] packed chrominance Huffman table.
    """

    quant: torch.Tensor
    basis: torch.Tensor
    basis_int: torch.Tensor
    huff: torch.Tensor
    chroma_quant: torch.Tensor
    huff_chroma: torch.Tensor


def pack_huffman_table(dc_codes, dc_lens, ac_codes, ac_lens) -> np.ndarray:
    """One table class's (codes, lengths) LUTs -> the [192] int32 layout."""
    out = np.zeros(HUFF_SIZE, np.int32)
    for r in range(16):
        for sz in range(11):
            sym = (r << 4) | sz
            out[HUFF_AC + r * 11 + sz] = (int(ac_codes[sym]) << 6) | int(ac_lens[sym])
    for sz in range(12):
        out[HUFF_DC + sz] = (int(dc_codes[sz]) << 6) | int(dc_lens[sz])
    out[HUFF_ZRL] = int(ac_codes[0xF0])
    out[HUFF_ZRL + 1] = int(ac_lens[0xF0])
    out[HUFF_EOB] = int(ac_codes[0x00])
    out[HUFF_EOB + 1] = int(ac_lens[0x00])
    return out


def encoder_state_from_numpy(luma_quant, chroma_quant, dct_basis, luts,
                             device) -> EncoderState:
    """numpy tables (as jpegtpu computes them) -> the kernels' tensors.

    luma_quant, chroma_quant: [8, 8] or [64] quantization tables, raster
      order.
    dct_basis: float [8, 8] basis; the int32-mode basis is derived from
      it as round(basis * 2^11), in float64.
    luts: {'dc_lum', 'ac_lum', 'dc_chrom', 'ac_chrom'} -> (codes, lengths):
      a DC class LUT has >= 12 entries (by size category), an AC class
      LUT 256 (by symbol byte).
    """
    def dense(a, dtype):
        # torch.tensor keeps a numpy array's strides; the kernels read
        # row-major memory (the reference basis is a transposed view)
        return torch.tensor(np.ascontiguousarray(a, dtype), device=device)

    def huff(kind):
        return dense(pack_huffman_table(*luts[f"dc_{kind}"],
                                        *luts[f"ac_{kind}"]), np.int32)

    basis64 = np.asarray(dct_basis, np.float64).reshape(8, 8)
    return EncoderState(
        quant=dense(np.asarray(luma_quant).reshape(64), np.int32),
        basis=dense(basis64, np.float32),
        basis_int=dense(np.round(basis64 * (1 << INT_FRAC)), np.int32),
        huff=huff("lum"),
        chroma_quant=dense(np.asarray(chroma_quant).reshape(64), np.int32),
        huff_chroma=huff("chrom"),
    )


def encoder_state(config, device) -> EncoderState:
    """The state for one EncodeConfig, from this module's own tables."""
    basis = (dct_basis_reference if config.bitexact else dct_basis)(np.float64)
    return encoder_state_from_numpy(config.luma_quant, config.chroma_quant,
                                    basis, huffman_luts(), device=device)
