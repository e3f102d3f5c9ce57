"""End-to-end grayscale encode (counterpart of `jpegtpu/pipeline.py`:
grayscale_coefficients, encode_grayscale, _encode_segment_device,
_gray_raw_front + _gray_encode_body_raw, the restart path
_encode_restart_segments_device + _gray_restart_body_raw + fetch_stitched
+ scan_from_stitched, the 2-pass paths _encode_grayscale_optimized_device
and _encode_grayscale_optimized_restart_device, capacity_ladder,
record_cap, encode_file), and the helpers the color path (color_pipeline)
shares.

The main path at the default EncodeConfig stages the image on the card
(io.transfer.stage) and runs four kernels there: K1 transform
(ops.transform) -> DC differences -> K4 symbolize + pack (entropy.pack)
-> K8 row merge + K9 stream concat with the tail padding
(entropy.concat). Frames whose stream buffer is past jpegtpu's resident
budget (gray_concat_mode; the 7680 x 4320 frame at every rung) take
K10's tiled concat in place of K9. The host reads (overflow, total
bits), then the valid word prefix, and stuffs it with the native runtime
(io.transfer.read_segments; with stuff="device" the card stuffs it, and
the host reads the stuffed bytes). A block that overflows the per-block
capacity retries the entropy chain at the next rung of the capacity
ladder (8 -> 16 -> 53 words; a configured first rung past 53 runs the
kernels at 53, kernel_cap); the transform runs once.

With restart_interval the DC chain resets at every segment and K12
(entropy.stitch) takes the place of K8 + K9: it lays the byte-aligned,
padded segments back to back in one buffer, and the host stuffs them
and puts RSTn between in one pass (entropy.host.scan_from_words).

With optimize_huffman the levels and DC differences are computed once
and stay on the card: symbol_histograms counts their symbols, the host
reads the counts (~3 KB), builds package-merge tables, and K4 encodes
the same levels with them as runtime tables, at every rung (the TPU
reference leaves for its host coder past cap 16).
"""
from __future__ import annotations

import numpy as np
import torch

from . import tables
from .config import EncodeConfig
from .entropy import host as entropy_host
from .entropy.concat import column_groups, concat_mode, concat_stream
from .entropy.device import (MAX_WORDS_PER_BLOCK, assemble_histograms,
                             dc_differences, stuff_bytes_device,
                             symbol_histograms)
from .entropy.pack import encode_blocks
from .entropy.stitch import stitch_segments
from .io import bmp, jfif, transfer
from .ops import color
from .ops.transform import transform
from .tracing import span


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


def _check_image(image, tensors: bool = True) -> None:
    """A uint8 [H, W] or [H, W, 3] image: a numpy array or, where
    `tensors`, a torch tensor on any device with any strides."""
    if isinstance(image, torch.Tensor):
        if not tensors:
            raise ValueError("this entry takes numpy arrays, not tensors")
        ok = image.dtype == torch.uint8
    else:
        ok = image.dtype == np.uint8
    if not ok or not (
        image.ndim == 2 or (image.ndim == 3 and image.shape[2] == 3)
    ):
        raise ValueError(
            f"expected uint8 [H, W] or [H, W, 3], got {image.dtype} "
            f"{tuple(image.shape)}"
        )


def _levels(image, config: EncodeConfig, dev: torch.device):
    """Edge-pad and stage on dev (io.transfer.stage: the ring, or K13 for
    an image on the device) -> luma -> K1. Returns (levels [64, nb] int32,
    encoder state, nbh, nbw)."""
    if config.n_components != 1:
        raise ValueError(f"subsampling={config.subsampling!r} is a color "
                         "config: use encode_color")
    _check_image(image)
    h, w = image.shape[:2]
    x = transfer.stage([image], (-(-h // 8) * 8, -(-w // 8) * 8,
                                 *image.shape[2:]), dev)
    with span("orch.tables"):
        state = tables.encoder_state(config, dev)
    with span("orch.front"):
        y = color.rgb_to_y_reference(x) if x.dim() == 3 else x
        levels = transform(y.contiguous(), state, config.dct_dtype == "int32")
    return levels, state, x.shape[0] // 8, x.shape[1] // 8


def grayscale_coefficients(image, config: EncodeConfig | None = None,
                           *, device=None) -> np.ndarray:
    """Run the transform of a grayscale encode.

    image: uint8 [H, W] luma or [H, W, 3] RGB, a numpy array or a tensor.
    Returns zigzag levels [nb, 64] int32 (blocks in raster order)."""
    config = config or EncodeConfig()
    levels = _levels(image, config, resolve_device(device))[0]
    return levels.T.cpu().numpy()


def encode_grayscale(image, config: EncodeConfig | None = None,
                     *, device=None) -> bytes:
    """Encode an image (uint8 [H, W] or [H, W, 3] RGB) as a baseline
    grayscale JFIF byte string, byte-identical to jpegtpu's. The image is
    a numpy array or a torch tensor; one on the encode's device is staged
    there (io.transfer.stage_on_card), with the same bytes."""
    with span("entry.single"):
        config = config or EncodeConfig()
        dev = resolve_device(device)
        h, w = image.shape[:2]
        if config.entropy == "host":
            zz = grayscale_coefficients(image, config, device=dev)
            segments, specs = host_scan(zz, config, ("lum",))
        else:
            levels, state, nbh, nbw = _levels(image, config, dev)
            scan, specs = gray_scan(levels, state, nbh, nbw, config,
                                    key=(nbh, nbw, config, image.ndim == 3))
            segments = [scan]
        with span("io.jfif"):
            return jfif.assemble(w, h, config, segments, huffman_specs=specs)


def gray_scan(levels: torch.Tensor, state: tables.EncoderState, nbh: int,
              nbw: int, config: EncodeConfig, key=None):
    """The entropy half of a gray device encode: levels [64, nb] on a
    device -> (scan bytes, optimal specs for the header or None). The DC
    differences are computed once; with optimize_huffman pass 1 counts
    the symbols of exactly these levels and differences, and pass 2
    encodes them with the optimal tables."""
    with span("orch.front"):
        dcd = dc_differences(levels[0], config.restart_interval)
    huff, specs = state.huff, None
    if config.optimize_huffman:
        with span("orch.tables"):
            specs, (huff,) = optimal_tables(symbol_histograms(levels, dcd),
                                            ("lum",), levels.device)
    return encode_levels(levels, huff, nbh, nbw, config, key, dcd), specs


def host_scan(zz: np.ndarray, config: EncodeConfig, kinds,
              table_sel=None, comp_id=None, mcu_slots: int = 1):
    """entropy="host": levels [nslots, 64] in scan order -> (entropy
    segments, optimal specs or None) by the numpy coder, with restart
    segments of restart_interval MCUs of mcu_slots blocks and, for
    optimize_huffman, floored 2-pass tables of the given classes."""
    seg_ids = None
    if config.restart_interval:
        seg_ids = (np.arange(zz.shape[0]) // mcu_slots
                   // config.restart_interval)
    specs = luts = None
    if config.optimize_huffman:
        specs = _optimal_specs(entropy_host.symbol_frequencies(
            zz, table_sel, comp_id, seg_ids), kinds)
        luts = tables.huffman_luts_from_specs(specs)
    return entropy_host.encode_scan(zz, table_sel, comp_id, seg_ids,
                                    config.pad_ones, luts), specs


def _optimal_specs(freqs: dict, kinds) -> dict:
    """Package-merge (bits, values) specs of the given table classes
    ("lum", "chrom") from 256-bin histograms, floored as every 2-pass
    path floors them (tables.floor_frequencies)."""
    freqs = tables.floor_frequencies(freqs)
    return {k: tables.optimal_spec(freqs[k])
            for kind in kinds for k in (f"dc_{kind}", f"ac_{kind}")}


def optimal_tables(counts: torch.Tensor, kinds, device):
    """The host step between the passes of a 2-pass encode: symbol counts
    on the card (entropy.device.symbol_histograms) -> one readback ->
    package-merge specs of the given table classes -> (specs for the JFIF
    header, one [192] K4 table per class on `device`)."""
    specs = _optimal_specs(assemble_histograms(counts), kinds)
    luts = tables.huffman_luts_from_specs(specs)
    return specs, tuple(tables.huffman_table(luts, kind, device)
                        for kind in kinds)


def encode_levels(levels: torch.Tensor, huff: torch.Tensor, nbh: int,
                  nbw: int, config: EncodeConfig, key=None,
                  dcd: torch.Tensor | None = None) -> bytes:
    """The entropy half of the device encode: levels [64, nb] int32 on a
    device (and their DC differences, computed here when None) -> stuffed
    scan bytes, RST-delimited with restart_interval, climbing the
    capacity ladder on overflow. `key` names the encode site for
    capacity_ladder."""
    if dcd is None:
        with span("orch.front"):
            dcd = dc_differences(levels[0], config.restart_interval)
    for cap in capacity_ladder(config, key):
        kcap = kernel_cap(cap)
        with span("orch.entropy"):  # the waits and reads inside are spans
            words, bits = encode_blocks(levels, dcd, huff, kcap)
            scan = finish_streams(words, bits, bits > kcap * 32, nbh, nbw,
                                  config, cap)
        if scan is not None:
            record_cap(key, cap)
            return scan
    raise RuntimeError("worst-case entropy capacity overflowed (bug)")


def finish_streams(words: torch.Tensor, bits: torch.Tensor,
                   overflow: torch.Tensor, nbh: int, nbw: int,
                   config: EncodeConfig, rung_words: int) -> bytes | None:
    """Streams of an nbh x nbw grid (blocks or MCUs) in scan order ->
    the scan bytes: restart segments of restart_interval streams
    (finish_restart_scan), else one segment (finish_scan, stuffed on the
    card with stuff="device"). rung_words: words per stream at the
    ladder's rung (see concat_stream)."""
    if config.restart_interval:
        return finish_restart_scan(words, bits, overflow,
                                   config.restart_interval, config.pad_ones)
    return finish_scan(words, bits, overflow, nbh, nbw, config.pad_ones,
                       rung_words, config.stuff == "device")


def kernel_cap(cap: int) -> int:
    """Words per block the kernels run at on ladder rung `cap`. No block
    is longer than MAX_WORDS_PER_BLOCK words, so a rung past it gives the
    same streams in fewer words, and K8's segments stay within the card's
    shared memory. The rules of jpegtpu's output and kernel choice (the
    concat decision, the batch's table sharing and merge route) read the
    rung itself."""
    return min(cap, MAX_WORDS_PER_BLOCK)


def gray_concat_mode(ph: int, pw: int, cap: int) -> str:
    """jpegtpu's concat mode for a gray frame padded to ph x pw at `cap`
    words per block (jpegtpu.pipeline.gray_concat_mode): K9 serves
    "pallas-resident", K10 the other modes."""
    return concat_mode(ph // 8, pw // 8, cap, column_groups(pw // 8))


def finish_scan(words: torch.Tensor, bits: torch.Tensor,
                overflow: torch.Tensor, nbh: int, nbw: int,
                pad_ones: bool, rung_words: int | None = None,
                stuff_on_device: bool = False) -> bytes | None:
    """Streams [cap, nb] + bits [nb] of an nbh x nbw grid in scan order
    -> K8 + K9 (K10 past jpegtpu's resident budget at rung_words words
    per stream), which pad the tail too -> one readback of (any overflow,
    total bits), then of the valid word prefix -> stuffed scan bytes; None if
    `overflow` holds anywhere (the caller retries at the next rung). With
    stuff_on_device the stream is stuffed on its device
    (stuff_bytes_device) and only the stuffed bytes are read back."""
    stream, head = scan_stream(words, bits, overflow, nbh, nbw, pad_ones,
                               rung_words, stuff_on_device)
    with span("orch.wait"):
        overflowed, count = head.tolist()
    if overflowed:
        return None
    return read_scan(stream, count, stuff_on_device)


def scan_stream(words: torch.Tensor, bits: torch.Tensor,
                overflow: torch.Tensor, nbh: int, nbw: int, pad_ones: bool,
                rung_words: int | None = None,
                stuff_on_device: bool = False):
    """The device half of finish_scan, with no host sync: -> (the padded
    scan stream, head [2] int64 on its device: any overflow, then the
    total bits, or the stuffed bytes with stuff_on_device)."""
    stream, total = concat_stream(words, bits, nbh, nbw, rung_words,
                                  pad_ones)
    if stuff_on_device:  # -> (stuffed bytes, their count)
        stream, total = stuff_bytes_device(stream, total)
    return stream, torch.stack([overflow.any().to(torch.int64), total])


def read_scan(stream: torch.Tensor, count: int,
              stuff_on_device: bool = False) -> bytes:
    """The host half of finish_scan: the valid prefix of a scan_stream
    (count: its head's total) -> stuffed scan bytes
    (io.transfer.read_segments), or with stuff_on_device one readback of
    the bytes stuffed on the device."""
    if stuff_on_device:
        with span("io.readback"):
            return stream[:count].cpu().numpy().tobytes()
    return transfer.read_segments(stream[None], [count])[0]


def finish_restart_scan(words: torch.Tensor, bits: torch.Tensor,
                        overflow: torch.Tensor, seg_len: int,
                        pad_ones: bool) -> bytes | None:
    """Streams [C, n] + bits [n] in scan order -> K12 (segments of
    seg_len streams, byte-aligned and padded, back to back) -> one
    readback of (any overflow, total bits), then of the valid word prefix
    and the segment totals -> the RST-delimited stuffed scan; None if
    `overflow` holds anywhere."""
    stream, seg_tot, total = stitch_segments(words, bits, seg_len, pad_ones)
    head = torch.stack([overflow.any().to(torch.int64), total])
    with span("orch.wait"):
        overflowed, total_bits = head.tolist()
    if overflowed:
        return None
    return transfer.read_restart_scan(stream, seg_tot, total_bits)


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
    rgb = bmp.read(input_path)
    if config.n_components == 1:
        data = encode_grayscale(rgb, config, device=device)
    else:
        from .color_pipeline import encode_color

        data = encode_color(rgb, config, device=device)
    with open(output_path, "wb") as f:
        f.write(data)
    return len(data)
