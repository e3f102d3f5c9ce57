"""JFIF/JPEG marker-segment serialization for one baseline scan, gray or
YCbCr color (counterpart of `jpegtpu/io/jfif.py`: grayscale_headers,
color_headers, assemble).

Produces the reference writer's marker set (APP0/DQT/SOF0/DHT/SOS/EOI).
SOF0 carries the ORIGINAL image dimensions while the entropy stream
encodes padded block content, as decoders consume ceil(dim/8) MCUs.
"""
from __future__ import annotations

import struct

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


def sos(components) -> bytes:
    """Scan header. `components` = [(id, dc_tbl, ac_tbl)]."""
    body = bytes([len(components)])
    for cid, dc, ac in components:
        body += struct.pack(">BB", cid, (dc << 4) | ac)
    body += struct.pack(">BBB", 0, 63, 0)
    return b"\xff\xda" + struct.pack(">H", 2 + len(body)) + body


def grayscale_headers(width: int, height: int, config: EncodeConfig) -> bytes:
    """All segments up to (and including) SOS for a 1-component scan."""
    return b"".join([
        SOI,
        app0(),
        dqt(config.luma_quant, 0),
        sof0(width, height, [(1, 1, 1, 0)]),
        dht(tables.STD_DC_LUMINANCE_BITS, tables.STD_DC_LUMINANCE_VALUES, 0, 0),
        dht(tables.STD_AC_LUMINANCE_BITS, tables.STD_AC_LUMINANCE_VALUES, 1, 0),
        sos([(1, 0, 0)]),
    ])


def color_headers(width: int, height: int, config: EncodeConfig) -> bytes:
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
        dht(tables.STD_DC_LUMINANCE_BITS, tables.STD_DC_LUMINANCE_VALUES, 0, 0),
        dht(tables.STD_AC_LUMINANCE_BITS, tables.STD_AC_LUMINANCE_VALUES, 1, 0),
        dht(tables.STD_DC_CHROMINANCE_BITS, tables.STD_DC_CHROMINANCE_VALUES,
            0, 1),
        dht(tables.STD_AC_CHROMINANCE_BITS, tables.STD_AC_CHROMINANCE_VALUES,
            1, 1),
        sos([(1, 0, 0), (2, 1, 1), (3, 1, 1)]),
    ])


def assemble(width: int, height: int, config: EncodeConfig, scan: bytes) -> bytes:
    """Full JFIF file: headers (gray or color, by the config's component
    count) + the stuffed entropy scan + EOI."""
    headers = grayscale_headers if config.n_components == 1 else color_headers
    return headers(width, height, config) + bytes(scan) + EOI
