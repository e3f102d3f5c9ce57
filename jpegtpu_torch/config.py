"""Encoder configuration (counterpart of `jpegtpu/config.py`).

The same frozen dataclass, field for field, so a config means the same
encode in both packages. The port serves the grayscale, single-scan
subset; `check_supported` names the ROADMAP.md item for the rest.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from . import tables


@dataclasses.dataclass(frozen=True)
class EncodeConfig:
    """Configuration for one encode.

    Attributes:
      quality: IJG quality factor in [1, 100]. 50 = Annex-K base tables.
      subsampling: "gray" (1 component); "420", "422" or "444" for color.
      restart_interval: MCUs between RSTn markers. 0 = none.
      pad_ones: pad the final partial byte with 1s (T.81) or 0s.
      bitexact: use the reference's 6-decimal DCT basis literals
        (tables.dct_basis_reference); otherwise the true orthonormal basis.
      dct_dtype: "float32" (true division, round half away from zero) or
        "int32" (11-bit fixed-point DCT, exact integer quantizer; the same
        levels on every backend).
      entropy: "device" runs symbolize + pack + concat on the card;
        "host" uses the numpy coder (entropy.host).
      capacity_words_per_block: first rung of the per-block output
        capacity (uint32 words) of the device packer; overflow retries
        at the next rung (pipeline.capacity_ladder).
      stuff: where 0xFF byte stuffing runs ("host" or "device").
      optimize_huffman: 2-pass optimal Huffman tables.
    """

    quality: int = 50
    subsampling: str = "gray"
    restart_interval: int = 0
    pad_ones: bool = True
    bitexact: bool = True
    dct_dtype: str = "float32"
    entropy: str = "device"
    capacity_words_per_block: int = 8
    stuff: str = "host"
    optimize_huffman: bool = False

    def __post_init__(self):
        if not 1 <= self.quality <= 100:
            raise ValueError(f"quality must be in [1, 100], got {self.quality}")
        if not 0 <= self.restart_interval <= 0xFFFF:
            # DRI's interval payload is a 16-bit field (T.81 B.2.4.4).
            raise ValueError(
                f"restart_interval must be in [0, 65535], got {self.restart_interval}"
            )
        if self.subsampling not in ("gray", "420", "422", "444"):
            raise ValueError(f"unknown subsampling {self.subsampling!r}")
        if self.entropy not in ("device", "host"):
            raise ValueError(f"unknown entropy backend {self.entropy!r}")
        if self.stuff not in ("host", "device"):
            raise ValueError(f"unknown stuffing mode {self.stuff!r}")
        if self.dct_dtype not in ("float32", "int32"):
            raise ValueError(f"unknown dct_dtype {self.dct_dtype!r}")

    @property
    def luma_quant(self) -> np.ndarray:
        return tables.quality_scaled_table(tables.STD_LUMINANCE_QUANT, self.quality)

    def check_supported(self) -> None:
        """Raise NotImplementedError for what this port does not serve yet,
        naming the ROADMAP.md item that will port it."""
        if self.subsampling != "gray":
            raise NotImplementedError(
                "color encodes are not ported yet (ROADMAP.md M2)")
        if self.restart_interval:
            raise NotImplementedError(
                "restart intervals are not ported yet (ROADMAP.md M3)")
        if self.optimize_huffman:
            raise NotImplementedError(
                "2-pass optimal Huffman tables are not ported yet "
                "(ROADMAP.md M4)")
        if self.stuff == "device":
            raise NotImplementedError(
                'device byte stuffing (stuff="device") is not ported yet '
                "(ROADMAP.md M10)")
