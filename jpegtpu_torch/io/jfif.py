"""JFIF/JPEG marker-segment serialization for one baseline scan, gray or
YCbCr color (counterpart of `jpegtpu/io/jfif.py`).

Produces the reference writer's marker set (APP0/DQT/SOF0/DHT/SOS/EOI),
with DRI and RSTn markers for restart intervals and optional custom
Huffman specs (2-pass optimal tables). SOF0 carries the ORIGINAL image
dimensions while the entropy stream encodes padded block content, as
decoders consume ceil(dim/8) MCUs.
"""
from __future__ import annotations

import struct
from typing import Sequence

import numpy as np

from .. import tables
from ..config import EncodeConfig

SOI = b"\xff\xd8"
EOI = b"\xff\xd9"


def app0() -> bytes:
    return b"\xff\xe0" + struct.pack(
        ">H5sHBHHBB", 16, b"JFIF\x00", 0x0101, 1, 96, 96, 0, 0
    )


def dqt(table: np.ndarray, table_id: int) -> bytes:
    """One 8-bit quantization table segment. `table` is [8,8] raster order;
    serialized in zigzag order per T.81."""
    zz = table.reshape(64)[tables.ZIGZAG_ORDER].astype(np.uint8)
    return b"\xff\xdb" + struct.pack(">HB", 67, table_id) + zz.tobytes()


def sof0(width: int, height: int, components) -> bytes:
    """Baseline frame header. `components` = [(id, h_samp, v_samp,
    qtbl_id)]. T.81 B.2.2: each dimension must be in [1, 65535]."""
    for name, v in (("width", width), ("height", height)):
        if not 1 <= v <= 0xFFFF:
            raise ValueError(
                f"JPEG {name} must be in [1, 65535] (T.81 16-bit SOF "
                f"field), got {v}"
            )
    body = struct.pack(">BHHB", 8, height, width, len(components))
    for cid, h, v, q in components:
        body += struct.pack(">BBB", cid, (h << 4) | v, q)
    return b"\xff\xc0" + struct.pack(">H", 2 + len(body)) + body


def dht(bits: np.ndarray, values: np.ndarray, table_class: int, table_id: int) -> bytes:
    """One Huffman table segment. table_class: 0=DC, 1=AC."""
    body = bytes([(table_class << 4) | table_id]) + bytes(bits) + bytes(values)
    return b"\xff\xc4" + struct.pack(">H", 2 + len(body)) + body


def dri(interval: int) -> bytes:
    """Define Restart Interval (MCUs between RSTn markers)."""
    return b"\xff\xdd" + struct.pack(">HH", 4, interval)


def rst(n: int) -> bytes:
    """RSTn marker, n in [0, 7] cycling."""
    return bytes([0xFF, 0xD0 + (n & 7)])


def sos(components) -> bytes:
    """Scan header. `components` = [(id, dc_tbl, ac_tbl)]."""
    body = bytes([len(components)])
    for cid, dc, ac in components:
        body += struct.pack(">BB", cid, (dc << 4) | ac)
    body += struct.pack(">BBB", 0, 63, 0)
    return b"\xff\xda" + struct.pack(">H", 2 + len(body)) + body


_STD_SPECS = {
    "dc_lum": (tables.STD_DC_LUMINANCE_BITS, tables.STD_DC_LUMINANCE_VALUES),
    "ac_lum": (tables.STD_AC_LUMINANCE_BITS, tables.STD_AC_LUMINANCE_VALUES),
    "dc_chrom": (tables.STD_DC_CHROMINANCE_BITS,
                 tables.STD_DC_CHROMINANCE_VALUES),
    "ac_chrom": (tables.STD_AC_CHROMINANCE_BITS,
                 tables.STD_AC_CHROMINANCE_VALUES),
}


def _dhts(kinds, huffman_specs) -> list:
    """DHT segments of the given table classes (table id = position),
    from huffman_specs where it has the class, else Annex K."""
    specs = huffman_specs or {}
    return [dht(*specs.get(f"{cls}_{kind}", _STD_SPECS[f"{cls}_{kind}"]),
                table_class, table_id)
            for table_id, kind in enumerate(kinds)
            for table_class, cls in enumerate(("dc", "ac"))]


def _restart(config: EncodeConfig) -> list:
    return [dri(config.restart_interval)] if config.restart_interval else []


def grayscale_headers(width: int, height: int, config: EncodeConfig,
                      huffman_specs=None) -> bytes:
    """All segments up to (and including) SOS for a 1-component scan.
    huffman_specs: optional per-class (bits, values) overrides (2-pass
    optimal tables)."""
    return b"".join([
        SOI,
        app0(),
        dqt(config.luma_quant, 0),
        sof0(width, height, [(1, 1, 1, 0)]),
        *_dhts(("lum",), huffman_specs),
        *_restart(config),
        sos([(1, 0, 0)]),
    ])


def color_headers(width: int, height: int, config: EncodeConfig,
                  huffman_specs=None) -> bytes:
    """All segments up to SOS for a 3-component YCbCr scan (420/422/444):
    Y on table 0, Cb and Cr on table 1."""
    ysamp = {"420": (2, 2), "422": (2, 1)}.get(config.subsampling, (1, 1))
    return b"".join([
        SOI,
        app0(),
        dqt(config.luma_quant, 0),
        dqt(config.chroma_quant, 1),
        sof0(width, height,
             [(1, ysamp[0], ysamp[1], 0), (2, 1, 1, 1), (3, 1, 1, 1)]),
        *_dhts(("lum", "chrom"), huffman_specs),
        *_restart(config),
        sos([(1, 0, 0), (2, 1, 1), (3, 1, 1)]),
    ])


def assemble(width: int, height: int, config: EncodeConfig,
             entropy_segments: Sequence[bytes], huffman_specs=None) -> bytes:
    """Full JFIF file: headers (gray or color, by the config's component
    count) + the entropy segments joined by cycling RST0..RST7 markers
    + EOI. One segment may itself hold a whole RST-delimited scan (the
    device paths finish restart scans that way)."""
    if len(entropy_segments) > 1 and not config.restart_interval:
        raise ValueError("multiple entropy segments require a restart_interval")
    headers = grayscale_headers if config.n_components == 1 else color_headers
    parts = [headers(width, height, config, huffman_specs)]
    for i, seg in enumerate(entropy_segments):
        if i:
            parts.append(rst(i - 1))
        parts.append(bytes(seg))
    parts.append(EOI)
    return b"".join(parts)
