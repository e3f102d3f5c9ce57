"""JFIF/JPEG marker-segment serialization for a grayscale baseline scan
(counterpart of `jpegtpu/io/jfif.py`: grayscale_headers, assemble).

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


def sof0(width: int, height: int) -> bytes:
    """Baseline frame header of one component (id 1, 1x1, table 0).
    T.81 B.2.2: each dimension must be in [1, 65535]."""
    for name, v in (("width", width), ("height", height)):
        if not 1 <= v <= 0xFFFF:
            raise ValueError(
                f"JPEG {name} must be in [1, 65535] (T.81 16-bit SOF "
                f"field), got {v}"
            )
    body = struct.pack(">BHHB", 8, height, width, 1) + struct.pack(">BBB", 1, 0x11, 0)
    return b"\xff\xc0" + struct.pack(">H", 2 + len(body)) + body


def dht(bits: np.ndarray, values: np.ndarray, table_class: int, table_id: int) -> bytes:
    """One Huffman table segment. table_class: 0=DC, 1=AC."""
    body = bytes([(table_class << 4) | table_id]) + bytes(bits) + bytes(values)
    return b"\xff\xc4" + struct.pack(">H", 2 + len(body)) + body


def sos() -> bytes:
    """Scan header of component 1 with tables 0/0."""
    body = bytes([1]) + struct.pack(">BB", 1, 0x00) + struct.pack(">BBB", 0, 63, 0)
    return b"\xff\xda" + struct.pack(">H", 2 + len(body)) + body


def grayscale_headers(width: int, height: int, config: EncodeConfig) -> bytes:
    """All segments up to (and including) SOS for a 1-component scan."""
    return b"".join([
        SOI,
        app0(),
        dqt(config.luma_quant, 0),
        sof0(width, height),
        dht(tables.STD_DC_LUMINANCE_BITS, tables.STD_DC_LUMINANCE_VALUES, 0, 0),
        dht(tables.STD_AC_LUMINANCE_BITS, tables.STD_AC_LUMINANCE_VALUES, 1, 0),
        sos(),
    ])


def assemble(width: int, height: int, config: EncodeConfig, scan: bytes) -> bytes:
    """Full JFIF file: headers + the stuffed entropy scan + EOI."""
    return grayscale_headers(width, height, config) + bytes(scan) + EOI
