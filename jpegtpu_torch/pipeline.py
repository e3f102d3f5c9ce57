"""End-to-end grayscale encode (counterpart of `jpegtpu/pipeline.py`:
grayscale_coefficients, encode_grayscale, _encode_segment_device,
_gray_raw_front + _gray_encode_body_raw, capacity_ladder, record_cap,
encode_file), and the helpers the color path (color_pipeline) shares.

The main path at the default EncodeConfig runs four kernels on the card:
K1 transform (ops.transform) -> DC differences -> K4 symbolize + pack
(entropy.pack) -> K8 row merge + K9 stream concat (entropy.concat) ->
tail padding. The host reads (overflow, total bits), then the valid word
prefix, and stuffs it with the native runtime. A block that overflows
the per-block capacity retries the entropy chain at the next rung of the
capacity ladder (8 -> 16 -> 53 words); the transform runs once.
"""
from __future__ import annotations

import numpy as np
import torch

from . import native, tables
from .config import EncodeConfig
from .entropy import host as entropy_host
from .entropy.concat import apply_tail_padding, concat_stream
from .entropy.device import MAX_WORDS_PER_BLOCK, dc_differences
from .entropy.pack import encode_blocks
from .io import bmp, jfif
from .ops import color
from .ops.blocks import pad_edge
from .ops.transform import transform


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Nothing falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "jpegtpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch versions"
        )
    return dev


def _check_image(image: np.ndarray) -> None:
    if image.dtype != np.uint8 or not (
        image.ndim == 2 or (image.ndim == 3 and image.shape[2] == 3)
    ):
        raise ValueError(
            f"expected uint8 [H, W] or [H, W, 3], got {image.dtype} "
            f"{image.shape}"
        )


def _levels(image: np.ndarray, config: EncodeConfig, dev: torch.device):
    """Host edge-pad -> device -> luma -> K1. Returns (levels [64, nb]
    int32, encoder state, nbh, nbw)."""
    config.check_supported()
    if config.n_components != 1:
        raise ValueError(f"subsampling={config.subsampling!r} is a color "
                         "config: use encode_color")
    _check_image(image)
    padded = np.ascontiguousarray(pad_edge(image))
    x = torch.from_numpy(padded).to(dev)
    y = color.rgb_to_y_reference(x) if image.ndim == 3 else x
    state = tables.encoder_state(config, dev)
    levels = transform(y.contiguous(), state, config.dct_dtype == "int32")
    return levels, state, padded.shape[0] // 8, padded.shape[1] // 8


def grayscale_coefficients(image: np.ndarray, config: EncodeConfig | None = None,
                           *, device=None) -> np.ndarray:
    """Run the transform of a grayscale encode.

    image: uint8 [H, W] luma or [H, W, 3] RGB.
    Returns zigzag levels [nb, 64] int32 (blocks in raster order)."""
    config = config or EncodeConfig()
    levels = _levels(image, config, resolve_device(device))[0]
    return levels.T.cpu().numpy()


def encode_grayscale(image: np.ndarray, config: EncodeConfig | None = None,
                     *, device=None) -> bytes:
    """Encode an image (uint8 [H, W] or [H, W, 3] RGB) as a baseline
    grayscale JFIF byte string, byte-identical to jpegtpu's."""
    config = config or EncodeConfig()
    dev = resolve_device(device)
    h, w = image.shape[:2]
    if config.entropy == "host":
        zz = grayscale_coefficients(image, config, device=dev)
        scan = entropy_host.encode_scan(zz, pad_ones=config.pad_ones)
    else:
        scan = _encode_segment_device(image, config, dev)
    return jfif.assemble(w, h, config, scan)


def _encode_segment_device(image: np.ndarray, config: EncodeConfig,
                           dev: torch.device) -> bytes:
    """Single-segment device encode with capacity-overflow retry."""
    levels, state, nbh, nbw = _levels(image, config, dev)
    return encode_levels(levels, state.huff, nbh, nbw, config,
                         key=(nbh, nbw, config, image.ndim == 3))


def encode_levels(levels: torch.Tensor, huff: torch.Tensor, nbh: int,
                  nbw: int, config: EncodeConfig, key=None) -> bytes:
    """The entropy half of the device encode: levels [64, nb] int32 on a
    device -> stuffed scan bytes, climbing the capacity ladder on
    overflow. `key` names the encode site for capacity_ladder."""
    dcd = dc_differences(levels[0])
    for cap in capacity_ladder(config, key):
        words, bits = encode_blocks(levels, dcd, huff, cap)
        scan = finish_scan(words, bits, bits > cap * 32, nbh, nbw,
                           config.pad_ones)
        if scan is not None:
            record_cap(key, cap)
            return scan
    raise RuntimeError("worst-case entropy capacity overflowed (bug)")


def finish_scan(words: torch.Tensor, bits: torch.Tensor,
                overflow: torch.Tensor, nbh: int, nbw: int,
                pad_ones: bool) -> bytes | None:
    """Streams [cap, nb] + bits [nb] of an nbh x nbw grid in scan order
    -> K8 + K9 -> tail padding -> one readback of (any overflow, total
    bits), then of the valid word prefix -> stuffed scan bytes; None if
    `overflow` holds anywhere (the caller retries at the next rung)."""
    stream, total = concat_stream(words, bits, nbh, nbw)
    stream, total = apply_tail_padding(stream, total, pad_ones)
    overflowed, total_bits = torch.stack(
        [overflow.any().to(torch.int64), total]
    ).tolist()
    if overflowed:
        return None
    nwords = (total_bits + 31) // 32
    words_np = stream[:nwords].cpu().numpy().view(np.uint32)
    if native.available():
        return native.words_to_stuffed(words_np, total_bits)
    raw = np.frombuffer(words_np.astype(">u4").tobytes(), np.uint8)
    return entropy_host.stuff_bytes(raw[: total_bits // 8])


_CAP_HISTORY_MAX = 4096
_CAP_DECAY_PERIOD = 32  # encodes between one-rung-lower probes
_cap_history: dict = {}  # encode-site key -> [last rung that fit, uses]


def capacity_ladder(config: EncodeConfig, key=None) -> tuple[int, ...]:
    """Overflow-retry capacity schedule (words per block): the configured
    rung, then 16, then the worst case MAX_WORDS_PER_BLOCK. Every rung
    runs the same kernels.

    key: optional encode-site key (shape + config). When content at this
    site overflowed the first rung before, the ladder starts at the rung
    that fit (`record_cap`), so recurring pathological content pays the
    retry once. The remembered rung decays: every _CAP_DECAY_PERIOD
    encodes the ladder probes one rung lower."""
    start = config.capacity_words_per_block
    if key is not None:
        ent = _cap_history.get(key)
        if ent is not None:
            rung, uses = ent
            ent[1] = uses + 1
            if rung > start and uses % _CAP_DECAY_PERIOD == _CAP_DECAY_PERIOD - 1:
                rung = _rung_below(rung, start)
            start = max(start, rung)
    ladder = [start]
    if ladder[-1] < 16:
        ladder.append(16)
    if ladder[-1] < MAX_WORDS_PER_BLOCK:
        ladder.append(MAX_WORDS_PER_BLOCK)
    return tuple(ladder)


def _rung_below(rung: int, start: int) -> int:
    """The ladder rung one below `rung` for a config whose first rung is
    `start` (the ladder is start < 16 < MAX_WORDS_PER_BLOCK)."""
    if rung > 16:
        return max(16, start)
    return start


def record_cap(key, cap: int) -> None:
    """Remember the capacity rung that fit at this encode site (LRU
    bounded). A success at a lower rung than remembered (the decay probe)
    overwrites it."""
    if key is None:
        return
    ent = _cap_history.pop(key, None)
    uses = ent[1] if ent is not None else 0
    _cap_history[key] = [cap, uses]
    while len(_cap_history) > _CAP_HISTORY_MAX:
        _cap_history.pop(next(iter(_cap_history)))


def encode_file(input_path: str, output_path: str,
                config: EncodeConfig | None = None, *, device=None) -> int:
    """BMP in, JPEG out: grayscale, or color for a color config. Returns
    the number of bytes written."""
    config = config or EncodeConfig()
    config.check_supported()
    rgb = bmp.read(input_path)
    if config.n_components == 1:
        data = encode_grayscale(rgb, config, device=device)
    else:
        from .color_pipeline import encode_color

        data = encode_color(rgb, config, device=device)
    with open(output_path, "wb") as f:
        f.write(data)
    return len(data)
