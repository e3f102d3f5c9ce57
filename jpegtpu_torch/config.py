"""Encoder configuration (counterpart of `jpegtpu/config.py`).

The same frozen dataclass, field for field, so a config means the same
encode in both packages. The port serves every field's values that
jpegtpu serves (batch sharding across devices, a `mesh` argument of the
batch encoders, is not a field and is refused there).
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
      dct_dtype: "int32" (11-bit fixed-point DCT, exact integer quantizer;
        the same levels on every backend), or any other name numpy's
        np.dtype parses ("float32", "float64", "float16", ...), which all
        take the float32 path (true division, round half away from zero),
        as in jpegtpu. "bfloat16" parses only where the ml_dtypes package
        is importable (it registers the type with numpy); jpegtpu imports
        it with JAX.
      entropy: "device" runs symbolize + pack + concat on the card;
        "host" uses the numpy coder (entropy.host).
      capacity_words_per_block: first rung of the per-block output
        capacity (uint32 words) of the device packer; overflow retries
        at the next rung (pipeline.capacity_ladder).
      stuff: where 0xFF byte stuffing runs ("host" or "device"). It is
        read where jpegtpu reads it, by the single-segment encodes (gray
        and color, single-pass and 2-pass); restart, batch and host
        entropy stuff on the host whatever it says, as in jpegtpu.
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
        _parse_dtype(self.dct_dtype)

    @property
    def luma_quant(self) -> np.ndarray:
        return tables.quality_scaled_table(tables.STD_LUMINANCE_QUANT, self.quality)

    @property
    def chroma_quant(self) -> np.ndarray:
        return tables.quality_scaled_table(tables.STD_CHROMINANCE_QUANT, self.quality)

    @property
    def n_components(self) -> int:
        return 1 if self.subsampling == "gray" else 3

    def dct_basis(self) -> np.ndarray:
        """The [8, 8] DCT basis (the reference's literals with bitexact)
        cast to dct_dtype, as jpegtpu's EncodeConfig.dct_basis. The
        kernels take their bases from tables.encoder_state."""
        dt = _parse_dtype(self.dct_dtype)
        if self.bitexact:
            return tables.dct_basis_reference(dt)
        return tables.dct_basis(dt)


def _parse_dtype(name: str) -> np.dtype:
    """np.dtype(name), after importing ml_dtypes where numpy does not know
    the name yet (it registers "bfloat16"); ValueError if neither does."""
    try:
        return np.dtype(name)
    except TypeError:
        pass
    try:
        import ml_dtypes  # noqa: F401  (registers its types with numpy)
        return np.dtype(name)
    except (ImportError, TypeError):
        raise ValueError(f"unknown dct_dtype {name!r}") from None
