"""Single-image color encode, 4:2:0, 4:2:2 and 4:4:4 (counterpart of
`jpegtpu/color_pipeline.py`: encode_color, color_coefficients,
_scan_layout, and the device body _fused_raw_planes +
_color_merged_raw + _color_encode_body_raw).

One MCU holds fy x fx luma blocks, one Cb and one Cr block (T.81 A.2.3);
luma uses table 0, chroma table 1, and each component has its own DC
predictor chain. The main path at EncodeConfig(subsampling="420") runs
six kernels on the card: K2 luma and K3 chroma transform of the
interleaved RGB (ops.transform) -> DC differences (luma along the scan's
luma chain, Cb and Cr each along the MCU raster) -> K4 twice, with the
luminance and the chrominance table (entropy.pack) -> K5 per-MCU
interleave (entropy.merge) -> K8 + K9 over the MCU streams
(entropy.concat) -> tail padding. The host reads (overflow, total bits),
then the valid word prefix, and stuffs it. An overflow retries the
entropy chain at the next rung of the capacity ladder; the transforms run
once. Every rung runs the same kernels (jpegtpu leaves its Pallas chain
at cap 53; K4 here takes any cap).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import tables
from .config import EncodeConfig
from .entropy import host as entropy_host
from .entropy.device import dc_differences, y_dc_differences
from .entropy.merge import mcu_luma_blocks, merge_mcu
from .entropy.pack import encode_blocks
from .io import jfif
from .ops.blocks import mcu_dims, pad_edge, sampling_factors
from .ops.transform import transform_rgb_chroma, transform_rgb_y
from .pipeline import (_check_image, capacity_ladder, finish_scan,
                       record_cap, resolve_device)


@functools.lru_cache(maxsize=64)
def _scan_layout(ph: int, pw: int, subsampling: str):
    """The interleaved scan's block slots for a padded shape, as numpy:
      gather_idx [nslots]: index into [luma blocks (raster) | Cb blocks |
        Cr blocks],
      table_sel [nslots]: 0 luma / 1 chroma,
      comp_id [nslots]: 0/1/2 (distinct DC chains, T.81 F.1.1.5.1)."""
    fy, fx = sampling_factors(subsampling)
    nmch, nmcw = ph // (8 * fy), pw // (8 * fx)
    nmcu = nmch * nmcw
    ny = fy * fx * nmcu
    mcu = np.arange(nmcu)
    slots = np.concatenate([
        mcu_luma_blocks(nmch, nmcw, subsampling).numpy(),
        (ny + mcu)[None], (ny + nmcu + mcu)[None],
    ]).T.reshape(-1)
    kind = np.array([0] * (fy * fx) + [1, 2])
    return (slots.astype(np.int64), np.tile(np.minimum(kind, 1), nmcu)
            .astype(np.int32), np.tile(kind, nmcu).astype(np.int64))


def component_levels(image: np.ndarray, config: EncodeConfig,
                     dev: torch.device):
    """Host edge-pad to the MCU -> device -> K2 and K3. Returns (luma
    levels [64, ny], chroma levels [64, 2 * nmcu] (Cb then Cr), encoder
    state, padded (ph, pw))."""
    config.check_supported()
    if config.n_components != 3:
        raise ValueError("encode_color needs a color subsampling "
                         "(420, 422 or 444); use encode_grayscale for gray")
    _check_image(image)
    if image.ndim == 2:
        image = np.repeat(image[..., None], 3, axis=-1)
    padded = np.ascontiguousarray(
        pad_edge(image, *mcu_dims(config.subsampling)))
    rgb = torch.from_numpy(padded).to(dev)
    state = tables.encoder_state(config, dev)
    int_mode = config.dct_dtype == "int32"
    return (transform_rgb_y(rgb, state, int_mode),
            transform_rgb_chroma(rgb, state, int_mode, config.subsampling),
            state, padded.shape[:2])


def color_coefficients(image: np.ndarray, config: EncodeConfig | None = None,
                       *, device=None):
    """Interleaved levels of a color encode, in scan order, with their
    layout (the host coder's input and the tests' oracle).

    image: uint8 [H, W, 3] RGB, or [H, W] gray (promoted to 3 channels).
    Returns (zz [nslots, 64] int32, table_sel [nslots], comp_id [nslots])."""
    config = config or EncodeConfig(subsampling="420")
    ly, lc, _, (ph, pw) = component_levels(image, config,
                                           resolve_device(device))
    gather, table_sel, comp_id = _scan_layout(ph, pw, config.subsampling)
    allz = torch.cat([ly, lc], dim=1).T
    zz = allz[torch.from_numpy(gather).to(allz.device)]
    return zz.cpu().numpy(), table_sel, comp_id


def encode_color(image: np.ndarray, config: EncodeConfig | None = None,
                 *, device=None) -> bytes:
    """Encode an image (uint8 [H, W, 3] RGB, or [H, W] gray promoted to
    RGB) as a baseline YCbCr JFIF byte string, byte-identical to
    jpegtpu's. The default config is 4:2:0 at Q50."""
    config = config or EncodeConfig(subsampling="420")
    dev = resolve_device(device)
    h, w = image.shape[:2]
    if config.entropy == "host":
        zz, table_sel, comp_id = color_coefficients(image, config, device=dev)
        scan = entropy_host.encode_scan(zz, table_sel, comp_id,
                                        pad_ones=config.pad_ones)
    else:
        ly, lc, state, (ph, pw) = component_levels(image, config, dev)
        fy, fx = sampling_factors(config.subsampling)
        scan = encode_color_levels(ly, lc, state, ph // (8 * fy),
                                   pw // (8 * fx), config,
                                   key=(ph, pw, config, "color"))
    return jfif.assemble(w, h, config, scan)


def encode_color_levels(luma: torch.Tensor, chroma: torch.Tensor,
                        state: tables.EncoderState, nmch: int, nmcw: int,
                        config: EncodeConfig, key=None) -> bytes:
    """The entropy half of the color device encode: luma levels [64, ny]
    and chroma levels [64, 2 * nmcu] on a device -> stuffed scan bytes,
    climbing the capacity ladder on overflow. `key` names the encode site
    for capacity_ladder."""
    ss = config.subsampling
    fy, fx = sampling_factors(ss)
    dcd_y = y_dc_differences(luma[0].reshape(fy * nmch, fx * nmcw),
                             ss).reshape(-1)
    dcd_c = dc_differences(chroma[0].reshape(2, -1)).reshape(-1)
    for cap in capacity_ladder(config, key):
        wy, by = encode_blocks(luma, dcd_y, state.huff, cap)
        wc, bc = encode_blocks(chroma, dcd_c, state.huff_chroma, cap)
        merged, mbits = merge_mcu(wy, by, wc, bc, nmch, nmcw, ss)
        scan = finish_scan(merged, mbits, torch.cat([by, bc]) > cap * 32,
                           nmch, nmcw, config.pad_ones)
        if scan is not None:
            record_cap(key, cap)
            return scan
    raise RuntimeError("worst-case entropy capacity overflowed (bug)")
