"""Debug observability: the stages of one 8x8 block (counterpart of
`jpegtpu/debug.py`).

The reference's debugging workflow prints the first 8x8 block of each
intermediate (natural_c jpeg_handler.c:168-175; the DSP client's
print_debug_block, main.c:519-525). Here `first_block_report` returns
the stages of any block as numpy arrays, computed by the stage functions
that K1's plain version is built from (ops.transform), so the report and
the encoder share one DCT.
"""
from __future__ import annotations

import numpy as np

from . import tables
from .config import EncodeConfig
from .io import transfer
from .ops import color
from .ops.transform import (dct_float, dct_int, level_shift_blocks,
                            quantize_float, quantize_int, zigzag)
from .pipeline import _check_image, resolve_device


def first_block_report(image: np.ndarray, config: EncodeConfig | None = None,
                       block: int = 0, *, device=None
                       ) -> dict[str, np.ndarray]:
    """The stages of one 8x8 block (block 0 by default, the reference's
    debug buffer) of a grayscale encode, blocks in raster order over the
    edge-padded image; RGB input goes through the gray path's luma.

    Returns {"y": uint8 [8, 8], "centered": int32 [8, 8], "dct": [8, 8],
    "quant": int32 [8, 8], "zigzag": int32 [64]}. "dct" is float32 for
    the float configs (the encoder's float32 path, whatever float
    dct_dtype names) and, with dct_dtype="int32", the int32 coefficients
    of the integer DCT that the encoder runs. The stages run on
    resolve_device(device)."""
    config = config or EncodeConfig()
    _check_image(image, tensors=False)
    dev = resolve_device(device)
    h, w = image.shape[:2]
    x = transfer.stage([image], (-(-h // 8) * 8, -(-w // 8) * 8,
                                 *image.shape[2:]), dev)
    y = color.rgb_to_y_reference(x) if image.ndim == 3 else x
    nb = (y.shape[0] // 8) * (y.shape[1] // 8)
    if not -nb <= block < nb:
        raise IndexError(f"block {block} out of range for {nb} blocks")
    centered = level_shift_blocks(y)[block][None]
    state = tables.encoder_state(config, dev)
    if config.dct_dtype == "int32":
        coeffs = dct_int(centered, state.basis_int)
        levels = quantize_int(coeffs, state.quant)
    else:
        coeffs = dct_float(centered, state.basis)
        levels = quantize_float(coeffs, state.quant)
    stages = {
        "y": centered + 128,
        "centered": centered,
        "dct": coeffs,
        "quant": levels,
        "zigzag": zigzag(levels),
    }
    out = {k: v[0].cpu().numpy() for k, v in stages.items()}
    out["y"] = out["y"].astype(np.uint8)
    return out


def format_block_report(report: dict[str, np.ndarray]) -> str:
    """Text rendering, the analog of print_debug_block (dsp main.c:177-203)."""
    out = []
    for name, arr in report.items():
        out.append(f"--- {name} ---")
        if arr.ndim == 2:
            for row in arr:
                out.append(
                    " ".join(
                        f"{v:8.2f}" if arr.dtype.kind == "f" else f"{int(v):6d}"
                        for v in row
                    )
                )
        else:
            out.append(" ".join(str(int(v)) for v in arr))
    return "\n".join(out)
