"""A plain baseline JPEG encoder in NumPy, written from T.81 and JFIF for
the benchmark's comparison: it imports nothing of the program under test
and is handed the same host images.

What the benchmark's configurations state (4:2:0 color, `bitexact`, no
restart interval, the Annex K tables at a quality) it does the plain
way: edge-replicate padding to the MCU, JFIF YCbCr in 16-bit fixed point
(libjpeg's weights and rounding), 2 x 2 box subsampling rounded to
nearest, level shift, the DCT F = T X T^T in float64 with the natural_c
reference's 6-decimal cosine literals, a true division by the table
rounded half away from zero, zigzag, the Annex K Huffman tables with
per-component DC prediction, 1-bit (or 0-bit) byte padding, 0xFF00
stuffing, and the JFIF marker set (APP0, DQT, SOF0, DHT, SOS, EOI).
`check_spec` refuses anything else: another subsampling, the true DCT
basis or restart markers need code of their own.

`precision="bfloat16"` computes the DCT in bfloat16 (torch): the control
that the comparison has to reject.
"""
from __future__ import annotations

import dataclasses
import struct

import numpy as np

from . import tables

# natural_c's cos((2x + 1) u pi / 16) literals, [x][u], with
# C[0] = 0.707107 and T[u, x] = C[u] / 2 * COS[x][u]
COS_LITERALS = np.array([
    [1.0, 0.980785, 0.923880, 0.831470, 0.707107, 0.555570, 0.382683, 0.195090],
    [1.0, 0.831470, 0.382683, -0.195090, -0.707107, -0.980785, -0.923880, -0.555570],
    [1.0, 0.555570, -0.382683, -0.980785, -0.707107, 0.195090, 0.923880, 0.831470],
    [1.0, 0.195090, -0.923880, -0.555570, 0.707107, 0.831470, -0.382683, -0.980785],
    [1.0, -0.195090, -0.923880, 0.555570, 0.707107, -0.831470, -0.382684, 0.980785],
    [1.0, -0.555570, -0.382684, 0.980785, -0.707107, -0.195090, 0.923880, -0.831470],
    [1.0, -0.831470, 0.382684, 0.195091, -0.707107, 0.980785, -0.923879, 0.555570],
    [1.0, -0.980785, 0.923880, -0.831470, 0.707107, -0.555570, 0.382684, -0.195090],
])

# the four tables by (class, kind): code dicts, and as arrays for numpy
_SPECS = {("dc", 0): tables.DC_LUMA, ("ac", 0): tables.AC_LUMA,
          ("dc", 1): tables.DC_CHROMA, ("ac", 1): tables.AC_CHROMA}


def _code_arrays(spec):
    code = np.zeros(256, np.int64)
    length = np.zeros(256, np.int64)
    for sym, (c, n) in tables.codes(spec).items():
        code[sym], length[sym] = c, n
    return code, length


CODE_ARRAYS = {key: _code_arrays(spec) for key, spec in _SPECS.items()}
_SIZE = np.array([int(v).bit_length() for v in range(1 << 16)], np.int64)


@dataclasses.dataclass
class Encoded:
    """A file and what the comparison reads from it."""
    file: bytes
    header_len: int
    levels: np.ndarray      # [M, blocks per MCU, 64] int64, zigzag
    slot_comp: np.ndarray   # component of each block of an MCU
    bits: np.ndarray        # the scan's bits, unstuffed, padding included
    mcu_starts: np.ndarray  # each MCU's first bit, then the last's end
    pad_ones: bool
    huffman: dict           # (class, kind) -> (bits, values)


def dct_basis() -> np.ndarray:
    c = np.ones(8)
    c[0] = 0.707107
    return 0.5 * c[:, None] * COS_LITERALS.T


def _pad(image: np.ndarray, mh: int, mw: int) -> np.ndarray:
    h, w = image.shape[:2]
    pad = [(0, -h % mh), (0, -w % mw)] + [(0, 0)] * (image.ndim - 2)
    return np.pad(image, pad, mode="edge")


def planes(image: np.ndarray) -> list:
    """The Y, Cb and Cr planes of an RGB image, padded to whole 16 x 16
    MCUs, chroma subsampled 2 x 2, int64."""
    px = _pad(image, 16, 16).astype(np.int64)
    r, g, b = px[..., 0], px[..., 1], px[..., 2]
    half = 1 << 15
    y = (19595 * r + 38470 * g + 7471 * b + half) >> 16
    cb = np.clip(((-11059 * r - 21709 * g + 32768 * b + half) >> 16) + 128,
                 0, 255)
    cr = np.clip(((32768 * r - 27439 * g - 5329 * b + half) >> 16) + 128,
                 0, 255)
    out = [y]
    for c in (cb, cr):
        h, w = c.shape
        out.append((c.reshape(h // 2, 2, w // 2, 2).sum((1, 3)) + 2) >> 2)
    return out


def block_levels(plane: np.ndarray, quant: np.ndarray, basis: np.ndarray,
                 precision: str = "float64") -> np.ndarray:
    """[H, W] samples -> [H / 8, W / 8, 64] quantized levels in zigzag
    order."""
    h, w = plane.shape
    x = (plane - 128).reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)
    if precision == "float64":
        # two large products: rows k of every block, then columns
        xk = x.astype(np.float64).transpose(2, 0, 1, 3).reshape(8, -1)
        y = (basis @ xk).reshape(8, h // 8, w // 8, 8)  # [u, by, bx, x]
        f = (y.reshape(-1, 8) @ basis.T).reshape(8, h // 8, w // 8, 8)
        f = f.transpose(1, 2, 0, 3)  # [by, bx, u, v]
    elif precision == "bfloat16":
        import torch
        dev = "cuda" if torch.cuda.is_available() else "cpu"
        t = torch.from_numpy(basis).to(dev, torch.bfloat16)
        xb = torch.from_numpy(np.ascontiguousarray(x)).to(dev, torch.bfloat16)
        f = (t @ xb @ t.T).to(torch.float64).cpu().numpy()
    else:
        raise ValueError(f"unknown precision {precision!r}")
    s = f / quant.reshape(8, 8)
    lv = np.sign(s) * np.floor(np.abs(s) + 0.5)
    return lv.reshape(h // 8, w // 8, 64)[..., tables.ZIGZAG].astype(np.int64)


def mcu_levels(image: np.ndarray, spec: dict, precision: str = "float64"):
    """Levels in scan order, [M, 6, 64] (four Y blocks, Cb, Cr), and the
    component of each block of an MCU."""
    basis = dct_basis()
    q = spec["quality"]
    quants = [tables.scaled_quant(tables.LUMA_QUANT, q),
              tables.scaled_quant(tables.CHROMA_QUANT, q)]
    lv = [block_levels(p, quants[min(i, 1)], basis, precision)
          for i, p in enumerate(planes(image))]
    nmh, nmw = lv[1].shape[:2]
    y = lv[0].reshape(nmh, 2, nmw, 2, 64).transpose(0, 2, 1, 3, 4)
    y = y.reshape(nmh, nmw, 4, 64)
    mcus = np.concatenate([y, lv[1][:, :, None], lv[2][:, :, None]], axis=2)
    return mcus.reshape(nmh * nmw, 6, 64), np.array([0, 0, 0, 0, 1, 2])


def _fields(blocks: np.ndarray, comp: np.ndarray):
    """Huffman fields of a run of blocks [n, 64] (zigzag) whose components
    are `comp` [n], DC predicted from 0: (values, lengths, index of each
    block's first field)."""
    n = blocks.shape[0]
    kind = np.minimum(comp, 1)
    dc = blocks[:, 0]
    diff = np.empty(n, np.int64)
    for c in np.unique(comp):
        idx = np.flatnonzero(comp == c)
        diff[idx] = np.diff(dc[idx], prepend=0)
    ac = blocks[:, 1:]
    bi, ki = np.nonzero(ac)
    v = ac[bi, ki]
    k = ki + 1
    first = np.ones(len(bi), bool)
    first[1:] = bi[1:] != bi[:-1]
    prev = np.where(first, 0, np.roll(k, 1))
    run = k - prev - 1
    nzrl = run // 16
    per_nz = nzrl + 1
    is_last = np.ones(len(bi), bool)
    is_last[:-1] = bi[1:] != bi[:-1]
    last = np.zeros(n, np.int64)
    last[bi[is_last]] = k[is_last]
    eob = last < 63
    nz_count = np.bincount(bi, weights=per_nz, minlength=n).astype(np.int64)
    counts = 1 + nz_count + eob
    block_first = np.cumsum(counts) - counts
    total = int(counts.sum())
    vals = np.zeros(total, np.int64)
    lens = np.zeros(total, np.int64)

    def amp(x, size):
        return np.where(x >= 0, x, x + (1 << size) - 1)

    for kd in (0, 1):
        code, length = CODE_ARRAYS[("dc", kd)]
        sel = np.flatnonzero(kind == kd)
        size = _SIZE[np.abs(diff[sel])]
        if size.size and size.max() > 11:
            raise ValueError("a DC difference is out of baseline range")
        pos = block_first[sel]
        vals[pos] = (code[size] << size) | amp(diff[sel], size)
        lens[pos] = length[size] + size
    # each nonzero's fields start after its block's DC field and the
    # fields of the block's earlier nonzeros
    cum = np.cumsum(per_nz) - per_nz
    start = block_first[bi] + 1 + cum - cum[np.flatnonzero(first)][
        np.cumsum(first) - 1]
    size = _SIZE[np.abs(v)]
    if size.size and size.max() > 10:
        raise ValueError("an AC level is out of baseline range")
    nz_kind = kind[bi]
    for kd in (0, 1):
        code, length = CODE_ARRAYS[("ac", kd)]
        sel = np.flatnonzero(nz_kind == kd)
        sym = (run[sel] % 16) * 16 + size[sel]
        pos = start[sel] + nzrl[sel]
        vals[pos] = (code[sym] << size[sel]) | amp(v[sel], size[sel])
        lens[pos] = length[sym] + size[sel]
        zsel = sel[nzrl[sel] > 0]
        reps = nzrl[zsel]
        zpos = np.repeat(start[zsel], reps) + (
            np.arange(reps.sum()) - np.repeat(np.cumsum(reps) - reps, reps))
        vals[zpos] = code[0xF0]
        lens[zpos] = length[0xF0]
        esel = np.flatnonzero(eob & (kind == kd))
        epos = block_first[esel] + counts[esel] - 1
        vals[epos] = code[0x00]
        lens[epos] = length[0x00]
    return vals, lens, block_first


def _bits(vals: np.ndarray, lens: np.ndarray) -> tuple:
    """Fields -> one bit per uint8, MSB first, and each field's offset."""
    off = np.cumsum(lens) - lens
    total = int(lens.sum())
    fld = np.repeat(np.arange(len(lens)), lens)
    pos = np.arange(total) - off[fld]
    bits = ((vals[fld] >> (lens[fld] - 1 - pos)) & 1).astype(np.uint8)
    return bits, off


def stuff(raw: np.ndarray) -> bytes:
    """Insert a 0x00 after every 0xFF byte (T.81 B.1.1.5)."""
    ff = raw == 0xFF
    out = np.zeros(len(raw) + int(ff.sum()), np.uint8)
    pos = np.arange(len(raw)) + np.cumsum(ff) - ff
    out[pos] = raw
    return out.tobytes()


def headers(width: int, height: int, spec: dict) -> bytes:
    """SOI through SOS, in the JFIF marker order of natural_c's writer."""
    q = spec["quality"]
    out = [b"\xff\xd8",
           b"\xff\xe0" + struct.pack(">H5sHBHHBB", 16, b"JFIF\x00", 0x0101,
                                     1, 96, 96, 0, 0)]
    for t in (0, 1):
        base = tables.LUMA_QUANT if t == 0 else tables.CHROMA_QUANT
        zz = tables.scaled_quant(base, q)[tables.ZIGZAG].astype(np.uint8)
        out.append(b"\xff\xdb" + struct.pack(">HB", 67, t) + zz.tobytes())
    comps = [(1, 2, 2, 0), (2, 1, 1, 1), (3, 1, 1, 1)]
    body = struct.pack(">BHHB", 8, height, width, len(comps))
    for cid, h, v, tq in comps:
        body += struct.pack(">BBB", cid, (h << 4) | v, tq)
    out.append(b"\xff\xc0" + struct.pack(">H", 2 + len(body)) + body)
    for t in (0, 1):
        for cls, name in enumerate(("dc", "ac")):
            bits, values = _SPECS[(name, t)]
            body = bytes([(cls << 4) | t]) + bytes(bits) + bytes(values)
            out.append(b"\xff\xc4" + struct.pack(">H", 2 + len(body)) + body)
    sel = [(1, 0, 0), (2, 1, 1), (3, 1, 1)]
    body = bytes([len(sel)])
    for cid, td, ta in sel:
        body += struct.pack(">BB", cid, (td << 4) | ta)
    body += bytes([0, 63, 0])
    out.append(b"\xff\xda" + struct.pack(">H", 2 + len(body)) + body)
    return b"".join(out)


def check_spec(spec: dict) -> None:
    """Refuse what this encoder does not implement."""
    if spec.get("optimize_huffman"):
        raise NotImplementedError("2-pass tables need a reference of their own")
    if np.dtype(spec.get("dct_dtype", "float32")).kind != "f":
        raise NotImplementedError("the fixed-point DCT needs a reference of "
                                  "its own")
    if spec["subsampling"] != "420":
        raise NotImplementedError("only 4:2:0 is implemented")
    if not spec.get("bitexact", True):
        raise NotImplementedError("only natural_c's DCT literals are "
                                  "implemented")
    if spec.get("restart_interval", 0):
        raise NotImplementedError("restart markers are not implemented")


def encode(image: np.ndarray, spec: dict, precision: str = "float64"
           ) -> Encoded:
    """Encode one uint8 RGB image [H, W, 3] as `spec` states."""
    check_spec(spec)
    levels, comp = mcu_levels(image, spec, precision)
    return encode_levels(levels, comp, image.shape[1], image.shape[0], spec)


def encode_levels(levels: np.ndarray, comp: np.ndarray, width: int,
                  height: int, spec: dict) -> Encoded:
    """The file of scan-order levels [M, blocks per MCU, 64]."""
    n_mcu, bpm = levels.shape[:2]
    pad_ones = spec.get("pad_ones", True)
    head = headers(width, height, spec)
    vals, lens, block_first = _fields(levels.reshape(-1, 64),
                                      np.tile(comp, n_mcu))
    bits, off = _bits(vals, lens)
    starts = np.append(off[block_first[::bpm]], len(bits))
    bits = np.concatenate([bits, np.full(-len(bits) % 8, int(pad_ones),
                                         np.uint8)])
    file = head + stuff(np.packbits(bits)) + b"\xff\xd9"
    return Encoded(file, len(head), levels, comp, bits, starts, pad_ones,
                   _SPECS)
