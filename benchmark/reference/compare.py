"""The comparison of a file with the reference's encode of the same image.

Outside the entropy-coded data the file has to equal the reference's
bytes. Inside, the float DCT of a program may round a coefficient that
lies within rounding of a half-step the other way than the float64
reference does, so the scan is compared by its levels: where the bits of
an MCU equal the reference's, so do its levels (the codes are prefix
free); where they differ, the MCU is decoded from the file and its
levels are compared with the reference's one by one. Stuffing (no
marker may stand in the scan: the configurations state no restart
interval), the MCU count, the byte padding and EOI are checked exactly on
the way. Decoding is plain Python and slow, so a file with more than
`budget` differing MCUs stops there and counts as cut short: no sound
file comes near it.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from . import encoder, tables


@dataclasses.dataclass
class Counts:
    """What the comparison of some files found."""
    header_mismatch: int = 0  # files whose bytes outside the scan differ
    scan_faults: int = 0      # files whose scan does not decode as stated
    cut_short: int = 0        # files with more than `budget` MCUs differing
    coefficients: int = 0     # levels compared
    off_by_one: int = 0       # levels 1 away from the reference's
    off_by_more: int = 0      # levels further away

    def add(self, other: "Counts") -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, getattr(self, f.name)
                    + getattr(other, f.name))


class _Fault(Exception):
    pass


_LUTS: dict = {}


def _lut(spec) -> list:
    """A 16-bit lookahead decode table: (symbol << 8) | code length, 0
    where no code starts."""
    key = (tuple(spec[0]), tuple(spec[1]))
    if key not in _LUTS:
        lut = np.zeros(1 << 16, np.int64)
        for sym, (code, n) in tables.codes(spec).items():
            lo = code << (16 - n)
            lut[lo:lo + (1 << (16 - n))] = (sym << 8) | n
        _LUTS[key] = lut.tolist()
    return _LUTS[key]


def _scan_start(data: bytes):
    """Offset of the first byte after the SOS segment, or None."""
    if data[:2] != b"\xff\xd8":
        return None
    i = 2
    while i + 4 <= len(data):
        if data[i] != 0xFF:
            return None
        n = int.from_bytes(data[i + 2:i + 4], "big")
        if data[i + 1] == 0xDA:
            return i + 2 + n
        i += 2 + n
    return None


def _unstuff(scan: bytes) -> np.ndarray:
    """Stuffed scan bytes -> its unstuffed bytes, checking that every 0xFF
    is followed by a stuffed 0x00."""
    b = np.frombuffer(scan, np.uint8)
    ff = np.flatnonzero(b == 0xFF)
    if ff.size and ff[-1] == len(b) - 1:
        raise _Fault("0xFF at the end of the scan")
    if np.any(b[ff + 1] != 0):
        raise _Fault("an unstuffed 0xFF or a marker in the scan")
    keep = np.ones(len(b), bool)
    keep[ff + 1] = False
    return b[keep]


def _first_mismatch(p: np.ndarray, op: int, r: np.ndarray, r0: int,
                    r1: int):
    """The first i in [r0, r1) where p[op + i - r0] != r[i] (or p ends),
    else None; windows double, so matching runs cost little."""
    i, width = r0, 4096
    while i < r1:
        j = min(r1, i + width)
        have = min(j, r0 + len(p) - op)
        d = np.flatnonzero(p[op + i - r0:op + have - r0] != r[i:have])
        if d.size:
            return i + int(d[0])
        if have < j:
            return have
        i, width = j, width * 2
    return None


def _decode_mcu(buf: bytes, pos: int, end: int, luts, preds: list,
                comp) -> tuple:
    """Decode one MCU from bit `pos`: its [blocks, 64] zigzag levels (DC
    absolute, from `preds`, which it updates) and the bit after it."""
    out = np.zeros((len(luts), 64), np.int64)

    def peek(p, n):
        word = int.from_bytes(buf[p >> 3:(p >> 3) + 4], "big")
        return (word >> (32 - (p & 7) - n)) & ((1 << n) - 1)

    def value(p, s):
        v = peek(p, s) if s else 0
        return v if s == 0 or v >> (s - 1) else v - (1 << s) + 1

    for blk, (dc_lut, ac_lut) in enumerate(luts):
        e = dc_lut[peek(pos, 16)]
        if not e or (e >> 8) > 11:
            raise _Fault("no DC code")
        pos += e & 0xFF
        s = e >> 8
        c = comp[blk]
        preds[c] += value(pos, s)
        pos += s
        out[blk, 0] = preds[c]
        k = 1
        while k < 64:
            e = ac_lut[peek(pos, 16)]
            if not e:
                raise _Fault("no AC code")
            pos += e & 0xFF
            rs = e >> 8
            r, s = rs >> 4, rs & 15
            if s == 0:
                if r == 0:
                    break
                if r != 15:
                    raise _Fault("an AC symbol of size 0")
                k += 16
                continue
            k += r
            if k > 63:
                raise _Fault("AC run past the block")
            out[blk, k] = value(pos, s)
            pos += s
            k += 1
        if k > 64:
            raise _Fault("ZRL past the block")
        if pos > end:
            raise _Fault("the scan ends inside an MCU")
    return out, pos


def _scan(p: np.ndarray, ref: encoder.Encoded, budget: int,
          counts: Counts) -> None:
    """Compare the scan's unstuffed bits with the reference's."""
    comp, levels, pad_bit = ref.slot_comp, ref.levels, int(ref.pad_ones)
    luts = [(_lut(ref.huffman[("dc", min(int(c), 1))]),
             _lut(ref.huffman[("ac", min(int(c), 1))])) for c in comp]
    n_comp = int(comp.max()) + 1
    last_of = [int(np.flatnonzero(comp == c)[-1]) for c in range(n_comp)]
    starts, r = ref.mcu_starts, ref.bits
    n_mcu = len(starts) - 1
    lv = levels
    buf = np.packbits(p).tobytes() + bytes(4)
    m = op = decoded = 0
    delta = [0] * n_comp  # file's DC predictor minus the reference's
    while m < n_mcu:
        if not any(delta):
            k = _first_mismatch(p, op, r, int(starts[m]), int(starts[-1]))
            if k is None:
                op += int(starts[-1] - starts[m])
                m = n_mcu
                break
            m2 = min(int(np.searchsorted(starts, k, "right")) - 1, n_mcu - 1)
            op += int(starts[m2] - starts[m])
            m = m2
        if decoded == budget:
            counts.cut_short += 1
            counts.coefficients += m * lv.shape[1] * 64
            return
        preds = [(int(lv[m - 1, last_of[c], 0]) if m else 0) + delta[c]
                 for c in range(n_comp)]
        got, op = _decode_mcu(buf, op, len(p), luts, preds, comp)
        d = np.abs(got - lv[m])
        counts.off_by_one += int((d == 1).sum())
        counts.off_by_more += int((d > 1).sum())
        delta = [int(got[last_of[c], 0] - lv[m, last_of[c], 0])
                 for c in range(n_comp)]
        decoded += 1
        m += 1
    counts.coefficients += lv.size
    rest = p[op:]
    if len(rest) >= 8 or np.any(rest != pad_bit):
        raise _Fault("bits past the last MCU are not the byte padding")


def compare(data: bytes, ref: encoder.Encoded, budget: int = 2000
            ) -> Counts:
    """Compare one file with the reference's encode of its image."""
    counts = Counts()
    if data == ref.file:
        counts.coefficients = ref.levels.size
        return counts
    if data[:ref.header_len] != ref.file[:ref.header_len]:
        counts.header_mismatch = 1
    start = _scan_start(data)
    try:
        if start is None or data[-2:] != b"\xff\xd9":
            raise _Fault("no SOS or no EOI")
        _scan(np.unpackbits(_unstuff(data[start:-2])), ref, budget, counts)
    except _Fault:
        counts.scan_faults = 1
    return counts
