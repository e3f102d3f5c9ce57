"""Host entropy coder: RLE symbolization + Huffman bit packing (numpy).

Counterpart of `jpegtpu/entropy/host.py` for one scan without restart
intervals, gray or color (a DC predictor chain per component, luminance
or chrominance tables per block); it serves `entropy="host"`. Semantics
(T.81 and the reference's rle.c / huffman.c):
  * magnitude category = bit length of |v|,
  * negative amplitudes encoded as v-1 masked to `size` bits,
  * ZRL 0xF0 per 16 zeros, symbol byte (run<<4)|size, EOB 0x00 when the
    block's tail is zero,
  * DC is a running difference along the scan, one chain per component,
  * canonical Huffman codes, MSB-first bit packing, 0xFF -> 0xFF 00 byte
    stuffing, final partial byte padded with 1s or 0s.
"""
from __future__ import annotations

import numpy as np

from .. import native, tables

_ZRL = 0xF0
_EOB = 0x00


def magnitude_category(v: np.ndarray) -> np.ndarray:
    """Bit length of |v| (0 for 0). v: any signed int array, |v| < 2^15."""
    mag = np.abs(v.astype(np.int32)).astype(np.uint32)
    sz = np.zeros(v.shape, dtype=np.uint8)
    for k in range(16):
        sz += (mag >= (1 << k)).astype(np.uint8)
    return sz


def amplitude_code(v: np.ndarray, size: np.ndarray) -> np.ndarray:
    """JPEG amplitude bits: v if v > 0 else v - 1, masked to `size` bits."""
    v = v.astype(np.int64)
    raw = np.where(v > 0, v, v - 1).astype(np.int64)
    mask = (np.int64(1) << size.astype(np.int64)) - 1
    return (raw & mask).astype(np.uint32)


def dc_differences(dc: np.ndarray, comp_id: np.ndarray | None = None
                   ) -> np.ndarray:
    """Per-block DC difference along scan order; comp_id [nb] gives each
    component its own predictor chain (T.81 F.1.1.5.1). None = one."""
    dc = dc.astype(np.int32)
    comp = np.zeros(dc.shape[0]) if comp_id is None else comp_id
    diff = np.empty(dc.shape[0], dtype=np.int32)
    for c in np.unique(comp):
        m = comp == c
        diff[m] = np.concatenate([dc[m][:1], np.diff(dc[m])])
    return diff


def symbolize(zz: np.ndarray, comp_id: np.ndarray | None = None):
    """[nb, 64] zigzag coefficients -> the scan's symbol stream in emission
    order: per block DC, then ascending AC with ZRLs before each escaped
    value, then EOB if the tail is zero. Returns (symbols u8, amplitudes
    u32, amp_bits u8, is_dc bool, block_of_symbol i64)."""
    zz = np.asarray(zz)
    nb = zz.shape[0]
    lanes = np.arange(64)

    dc_diff = dc_differences(zz[:, 0], comp_id)
    dc_size = magnitude_category(dc_diff)
    dc_amp = amplitude_code(dc_diff, dc_size)

    ac = zz[:, 1:]  # [nb, 63]
    nz = ac != 0
    last_nz = np.max(np.where(nz, lanes[1:], 0), axis=1)  # 0 if none
    # previous nonzero lane before lane k (DC lane 0 counts as nonzero)
    pos = np.where(nz, lanes[1:], 0)
    prev = np.maximum.accumulate(
        np.concatenate([np.zeros((nb, 1), np.int64), pos], axis=1), axis=1
    )[:, :-1]
    run = lanes[1:][None, :] - prev - 1
    emit = nz & (lanes[1:][None, :] <= last_nz[:, None])
    zrl_cnt = np.where(emit, run >> 4, 0).astype(np.int64)
    rem = (run & 15).astype(np.uint8)
    ac_size = magnitude_category(ac)
    ac_sym = ((rem << 4) | ac_size).astype(np.uint8)
    ac_amp = amplitude_code(ac, ac_size)
    eob = last_nz < 63

    # per-lane slots: lane 0 = DC; lanes 1..63 = (ZRLs, sym); lane 64 = EOB
    cnt = np.zeros((nb, 65, 2), dtype=np.int64)
    cnt[:, 0, 1] = 1
    cnt[:, 1:64, 0] = zrl_cnt
    cnt[:, 1:64, 1] = emit
    cnt[:, 64, 1] = eob
    sym = np.zeros((nb, 65, 2), dtype=np.uint8)
    amp = np.zeros((nb, 65, 2), dtype=np.uint32)
    bits = np.zeros((nb, 65, 2), dtype=np.uint8)
    sym[:, :, 0] = _ZRL
    sym[:, 0, 1] = dc_size  # DC symbol byte == size category
    amp[:, 0, 1] = dc_amp
    bits[:, 0, 1] = dc_size
    sym[:, 1:64, 1] = ac_sym
    amp[:, 1:64, 1] = ac_amp
    bits[:, 1:64, 1] = ac_size
    sym[:, 64, 1] = _EOB

    flat_cnt = cnt.reshape(-1)
    is_dc = np.broadcast_to(
        (np.arange(65) == 0)[None, :, None], (nb, 65, 2)
    ).reshape(-1)
    block = np.broadcast_to(np.arange(nb)[:, None, None], (nb, 65, 2))
    return (
        np.repeat(sym.reshape(-1), flat_cnt),
        np.repeat(amp.reshape(-1), flat_cnt),
        np.repeat(bits.reshape(-1), flat_cnt),
        np.repeat(is_dc, flat_cnt),
        np.repeat(block.reshape(-1), flat_cnt),
    )


def pack_bits(values: np.ndarray, lengths: np.ndarray, pad_ones: bool = True) -> bytes:
    """MSB-first concatenation of variable-length codes, with byte stuffing."""
    values = values.astype(np.uint64)
    lengths = lengths.astype(np.int64)
    total = int(lengths.sum())
    if total == 0:
        return b""
    offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    within = np.arange(total, dtype=np.int64) - np.repeat(offsets, lengths)
    shift = np.repeat(lengths, lengths) - 1 - within
    bitvals = ((np.repeat(values, lengths) >> shift.astype(np.uint64)) & 1).astype(np.uint8)
    pad = (-total) % 8
    if pad:
        bitvals = np.concatenate(
            [bitvals, np.full(pad, 1 if pad_ones else 0, dtype=np.uint8)]
        )
    return stuff_bytes(np.packbits(bitvals))


def stuff_bytes(raw: np.ndarray) -> bytes:
    """JPEG byte stuffing: every 0xFF is followed by 0x00. Native when the
    C++ runtime builds, else numpy (the same bytes)."""
    if native.available():
        return native.stuff_bytes(raw)
    is_ff = raw == 0xFF
    n_ff = int(is_ff.sum())
    if n_ff == 0:
        return raw.tobytes()
    out = np.zeros(raw.size + n_ff, dtype=np.uint8)
    idx = np.arange(raw.size) + np.concatenate([[0], np.cumsum(is_ff)[:-1]])
    out[idx] = raw
    return out.tobytes()


def encode_scan(zz: np.ndarray, table_sel: np.ndarray | None = None,
                comp_id: np.ndarray | None = None,
                pad_ones: bool = True) -> bytes:
    """Entropy-code one scan with the standard tables: [nb, 64] zigzag
    levels in scan order -> stuffed, padded entropy bytes.

    table_sel: [nb] 0 = luminance tables, 1 = chrominance (None: all 0).
    comp_id: [nb] component of each block (see dc_differences)."""
    symbols, amplitudes, amp_bits, is_dc, block = symbolize(zz, comp_id)
    sel = (np.zeros(symbols.shape, np.int64) if table_sel is None
           else np.asarray(table_sel, np.int64)[block])
    luts = tables.huffman_luts()
    codes = np.empty(symbols.shape, dtype=np.uint32)
    lens = np.empty(symbols.shape, dtype=np.uint8)
    for flag, cls in ((True, "dc"), (False, "ac")):
        for t, kind in ((0, "lum"), (1, "chrom")):
            c, l = luts[f"{cls}_{kind}"]
            m = (is_dc == flag) & (sel == t)
            codes[m] = c[symbols[m]]
            lens[m] = l[symbols[m]]
    # (huffman code || amplitude) per symbol, <= 27 bits
    total_vals = (codes.astype(np.uint64) << amp_bits.astype(np.uint64)) | amplitudes
    total_lens = lens.astype(np.int64) + amp_bits
    return pack_bits(total_vals, total_lens, pad_ones)
