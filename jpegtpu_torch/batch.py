"""Batch encode: many images per call (counterpart of `jpegtpu/batch.py`:
encode_grayscale_batch and encode_color_batch, their bodies
_batch_encode_fn and color_batch_raw_body, the stats passes
_batch_gray_stats_fn and _batch_color_stats_fn, the shared-table paths
_encode_gray_batch_optimized and _encode_color_batch_optimized, and the
geometry rules _slot_geom, _gray_raw_ok and _color_raw_ok).

Images are grouped by padded shape, as jpegtpu groups them, and each
group runs as one stack. jpegtpu packs narrow images side by side into
128-lane tiles, because a TPU tile is 128 lanes wide. Here the images of a
group stack vertically and the single-image kernels run on the stack
unchanged: gray [B * ph, pw] -> K1, color [B * ph, pw, 3] -> K2 + K3
(heights are MCU multiples, so no block and no 2 x 2 chroma box crosses
an image). Levels come out image after image in raster order, and each
image's DC chains are the restart chains with one segment per image. K4
runs once over every block (color: with both tables, then K5 over every
MCU); K8 at the batch's segment width cuts the block (MCU) rows into
segments that never cross an image, and K11 lays each image's segments
back to back in a slab of its own and pads its final byte
(entropy.concat.concat_segments). A share's images reach its device
through io.transfer.stage (the process's pinned ring, or one K13 launch
for images already on the device). The host reads (any overflow, every
image's total bits) once, then the valid words of all images in one copy
(io.transfer.read_segments), and stuffs and assembles each file. An
overflow climbs the capacity ladder with the same kernels; the transform
runs once. jpegtpu pads each group with blank images to a power of two to
bound its recompiles; nothing compiles here, so no image is added.

With optimize_huffman a group shares one set of 2-pass tables: the
symbols of the whole stack are counted once, and K4 encodes the stack
with the floored package-merge tables. Which groups share is part of
jpegtpu's output, so the port keeps its rule (shares_gray_tables,
color_raw_ok); every other image gets its own 2-pass tables from the
single-image encoders. A restart interval or host entropy sends every
image to the single-image encoders, as in jpegtpu.

A color group merges its MCU streams where jpegtpu does: K5 on jpegtpu's
raw route (color_raw_ok) and above cap 16, K6 on slot-major streams
(color_pipeline.mcu_streams_slot_major) at the other rungs up to 16: a
batch of 12 MPix photos at every rung, any shape at rung 16. Both give
the same bytes. The kernels run at pipeline.kernel_cap of each rung;
the rules read the rung.
"""
from __future__ import annotations

import itertools

import torch

from . import tables
from .color_pipeline import (color_dc_differences, color_tables, encode_color,
                             mcu_streams, mcu_streams_slot_major)
from .config import EncodeConfig
from .entropy.concat import LANES, concat_segments, segment_width
from .entropy.device import dc_differences, symbol_histograms
from .entropy.pack import encode_blocks
from .io import jfif, transfer
from .ops import color
from .ops.blocks import padded_dims_color, sampling_factors, slots_per_mcu
from .ops.transform import transform, transform_rgb_chroma, transform_rgb_y
from .pipeline import (_check_image, capacity_ladder, encode_grayscale,
                       kernel_cap, optimal_tables, resolve_device)
from .tracing import count, span

# jpegtpu's transform tile height in pixels (pallas_transform.TILE_H), which
# its table-sharing rule counts in.
_TILE_H = 64

def shares_gray_tables(ph: int, pw: int, cap: int) -> bool:
    """Whether jpegtpu encodes a gray optimize_huffman group of padded
    shape ph x pw at rung `cap` with tables shared by the group
    (_gray_raw_ok); elsewhere it gives each image its own 2-pass tables.

    The rule reproduces the reference's output, which it decides: the
    budgets are its TPU kernel's (cap <= 16, at most 256 kernel rows per
    image segment, a 12 MiB stream buffer in VMEM), not a limit of this
    card."""
    nbw = pw // 8
    seg_rows = -(-ph // _TILE_H) * (_TILE_H // 8) * -(-nbw // LANES)
    nb = (ph // 8) * nbw
    return (cap <= 16 and seg_rows <= 256
            and (nb * cap // LANES + cap + 8) * 512 <= 12 << 20)


def color_raw_ok(ph: int, pw: int, subsampling: str, cap: int) -> bool:
    """jpegtpu's _color_raw_ok on a bucketed batch (bucketing makes the
    batch a multiple of its packing ratio): whether it encodes a color
    group of MCU-padded shape ph x pw at rung `cap` by its all-Pallas raw
    body. Where it does, an optimize_huffman group shares its 2-pass
    tables and the MCU merge is K5; elsewhere each image gets its own
    tables, and the merge is K6 up to cap 16 (its slot-major route) and
    K5 above. The test: cap <= 8, at most 256 kernel rows per image
    segment, and one image's stream buffer plus two steps of row segments
    within 12 MiB of VMEM. Like shares_gray_tables, a rule of the
    reference's output and kernel choice, not a limit of this card."""
    fy, fx = sampling_factors(subsampling)
    nmch, nmcw = ph // (8 * fy), pw // (8 * fx)
    seg_rows = -(-(ph // fy) // _TILE_H) * (_TILE_H // 8) * -(-nmcw // LANES)
    mcap = slots_per_mcu(subsampling) * cap
    out_rows = -(-(nmch * nmcw * mcap) // LANES) + mcap + 8
    ws = segment_width(nmcw)
    step_bytes = seg_rows * -(-(ws * mcap + mcap + 2) // LANES) * LANES * 4
    return (cap <= 8 and seg_rows <= 256
            and out_rows * 512 + 2 * step_bytes <= 12 << 20)


def _prepare(images, config: EncodeConfig, mesh, n_components: int,
             device) -> list:
    """Check the batch; returns its devices: the mesh's, or [device]."""
    if config.n_components != n_components:
        raise ValueError(
            f"subsampling={config.subsampling!r} does not fit this batch "
            "encoder: gray goes to encode_grayscale_batch, color to "
            "encode_color_batch")
    for image in images:
        _check_image(image)
    if mesh is not None:
        return [resolve_device(d) for d in mesh]
    return [resolve_device(device)]


def _shares(n_images: int, devs: list, nbw: int) -> list:
    """A group's images across the mesh, as jpegtpu splits its batch axis:
    the group padded to a power of two, then to a multiple of
    r * len(devs) (r: the images jpegtpu packs side by side, rows of nbw
    blocks or MCUs), in equal contiguous shares; (device, first, stop)
    for every device whose share holds an image. The split changes no
    byte."""
    m = len(devs)
    if m == 1:
        return [(devs[0], 0, n_images)]
    unit = LANES // segment_width(nbw) * m
    local = -(-(1 << (n_images - 1).bit_length()) // unit) * unit // m
    return [(dev, j * local, min((j + 1) * local, n_images))
            for j, dev in enumerate(devs) if j * local < n_images]


def _groups(images, key) -> dict:
    """Input indices by key(image), in order of first appearance."""
    groups: dict = {}
    for i, image in enumerate(images):
        groups.setdefault(key(image), []).append(i)
    return groups


def _encode_stacks(parts, caps, nbh: int, nbw: int, pad_ones: bool):
    """The entropy finish of a group's stacks (one a device), each of
    n_images images of an nbh x nbw grid of blocks (or MCUs): for each
    rung, every part's streams_at(cap) -> (words [C, n], bits [n],
    per-block overflow flags), then K8 + K11, one readback of (any
    overflow, every image's total bits) and, once no part overflowed, one
    of the valid words of all its images. parts: [(streams_at, n_images)].
    Returns every image's stuffed scan, in order, or None when every rung
    overflowed."""
    ws = segment_width(nbw)
    count("batch.groups")
    for cap in caps:
        count("orch.rungs")
        outs = []
        with span("orch.entropy"):
            for streams_at, n_images in parts:
                words, bits, overflow = streams_at(cap)
                streams, totals = concat_segments(words, bits, n_images * nbh,
                                                  nbw, n_images, ws, pad_ones)
                outs.append((streams, torch.cat(
                    [overflow.any().to(torch.int64).reshape(1), totals])))
        with span("orch.wait"):
            heads = [head.tolist() for _, head in outs]
        if any(h[0] for h in heads):
            continue
        scans = []
        for (streams, _), h in zip(outs, heads):
            scans += transfer.read_segments(streams, h[1:])
        return scans
    return None


def _gray_group(images: list, ph: int, pw: int, config: EncodeConfig,
                devs: list) -> list:
    """One group of a gray batch (padded shape ph x pw, all [H, W] or all
    RGB) -> its files in order. Its images split across devs."""
    if config.optimize_huffman and not shares_gray_tables(ph, pw, 8):
        return [encode_grayscale(image, config, device=devs[0])
                for image in images]
    nbh, nbw = ph // 8, pw // 8
    fronts = []
    for dev, lo, hi in _shares(len(images), devs, nbw):
        plane = transfer.stage(images[lo:hi],
                               (ph, pw, *images[0].shape[2:]), dev)
        with span("orch.tables"):
            state = tables.encoder_state(config, dev)
        with span("orch.front"):
            if plane.dim() == 3:
                plane = color.rgb_to_y_reference(plane)
            levels = transform(plane.contiguous(), state,
                               config.dct_dtype == "int32")
            fronts.append((levels, dc_differences(levels[0], nbh * nbw),
                           state.huff, hi - lo))
    specs, caps = None, capacity_ladder(config)
    if config.optimize_huffman:
        # one set of tables from the counts of every share
        with span("orch.tables"):
            specs, (huff,) = optimal_tables(
                sum(symbol_histograms(lv, d).cpu() for lv, d, _, _ in fronts),
                ("lum",), "cpu")
            fronts = [(lv, d, huff.to(lv.device), b)
                      for lv, d, _, b in fronts]
        caps = itertools.takewhile(
            lambda cap: shares_gray_tables(ph, pw, cap), caps)

    def part(levels, dcd, huff):
        def streams_at(cap):
            kcap = kernel_cap(cap)
            words, bits = encode_blocks(levels, dcd, huff, kcap)
            return words, bits, bits > kcap * 32
        return streams_at

    scans = _encode_stacks([(part(lv, d, hf), b) for lv, d, hf, b in fronts],
                           caps, nbh, nbw, config.pad_ones)
    if scans is None:
        if not config.optimize_huffman:
            raise RuntimeError("worst-case entropy capacity overflowed (bug)")
        # past the shared rungs jpegtpu gives each image its own tables
        return [encode_grayscale(image, config, device=devs[0])
                for image in images]
    with span("io.jfif"):
        return [jfif.assemble(image.shape[1], image.shape[0], config, [scan],
                              huffman_specs=specs)
                for image, scan in zip(images, scans)]


def _color_group(images: list, ph: int, pw: int, config: EncodeConfig,
                 devs: list) -> list:
    """One group of a color batch (MCU-padded shape ph x pw) -> its files
    in order. Its images split across devs."""
    ss = config.subsampling
    if config.optimize_huffman and not color_raw_ok(ph, pw, ss, 8):
        return [encode_color(image, config, device=devs[0])
                for image in images]
    fy, fx = sampling_factors(ss)
    nmch, nmcw = ph // (8 * fy), pw // (8 * fx)
    int_mode = config.dct_dtype == "int32"
    fronts = []
    for dev, lo, hi in _shares(len(images), devs, nmcw):
        b = hi - lo
        rgb = transfer.stage(images[lo:hi], (ph, pw, 3), dev)
        with span("orch.tables"):
            state = tables.encoder_state(config, dev)
        with span("orch.front"):
            luma = transform_rgb_y(rgb, state, int_mode)
            chroma = transform_rgb_chroma(rgb, state, int_mode, ss)
            dcd = color_dc_differences(luma, chroma, b * nmch, nmcw, ss,
                                       nmch * nmcw)
        fronts.append((luma, chroma, dcd, state, b))
    specs, caps = None, capacity_ladder(config)
    if config.optimize_huffman:
        # one set of tables from the counts of every share
        with span("orch.tables"):
            specs, (hl, hc) = optimal_tables(
                sum(symbol_histograms(lu, d[0], 0).cpu()
                    + symbol_histograms(ch, d[1], 1).cpu()
                    for lu, ch, d, _, _ in fronts), ("lum", "chrom"), "cpu")
            fronts = [(lu, ch, d, st._replace(huff=hl.to(lu.device),
                                              huff_chroma=hc.to(lu.device)),
                       b) for lu, ch, d, st, b in fronts]
        caps = itertools.takewhile(
            lambda cap: color_raw_ok(ph, pw, ss, cap), caps)

    def part(luma, chroma, dcd, state, b):
        def streams_at(cap):
            slot_major = cap <= 16 and not color_raw_ok(ph, pw, ss, cap)
            streams = mcu_streams_slot_major if slot_major else mcu_streams
            return streams(luma, chroma, dcd, state, b * nmch, nmcw, ss,
                           kernel_cap(cap))
        return streams_at

    scans = _encode_stacks([(part(*f), f[-1]) for f in fronts], caps, nmch,
                           nmcw, config.pad_ones)
    if scans is None:
        if not config.optimize_huffman:
            raise RuntimeError("worst-case entropy capacity overflowed (bug)")
        # past the shared rung jpegtpu gives each image its own tables
        return [encode_color(image, config, device=devs[0])
                for image in images]
    with span("io.jfif"):
        return [jfif.assemble(image.shape[1], image.shape[0], config, [scan],
                              huffman_specs=specs)
                for image, scan in zip(images, scans)]


def encode_grayscale_batch(images: list, config: EncodeConfig | None = None,
                           mesh=None, *, device=None) -> list:
    """Encode uint8 images ([H, W] luma or [H, W, 3] RGB; numpy arrays or
    torch tensors, which may be mixed: see io.transfer.source_image) as
    baseline grayscale JFIF byte strings, in input order, byte-identical to
    jpegtpu's batch.encode_grayscale_batch (and so to its single-image
    encodes, apart from the tables that optimize_huffman shares). mesh:
    a list of devices (parallel.sharding.make_mesh) that each shape
    group's images split across, as jpegtpu splits its batch axis, with
    shared 2-pass tables from the counts of every share; the files do not
    change."""
    with span("entry.batch"):
        config = config or EncodeConfig()
        devs = _prepare(images, config, mesh, 1, device)
        if config.restart_interval or config.entropy != "device":
            return [encode_grayscale(image, config, device=devs[0])
                    for image in images]
        out: list = [None] * len(images)
        groups = _groups(images, lambda image: (
            -(-image.shape[0] // 8) * 8, -(-image.shape[1] // 8) * 8,
            image.ndim == 3))
        for (ph, pw, _), idxs in groups.items():
            with span("batch.group"):
                files = _gray_group([images[i] for i in idxs], ph, pw, config,
                                    devs)
            for i, data in zip(idxs, files):
                out[i] = data
        return out


def encode_color_batch(images: list, config: EncodeConfig | None = None,
                       mesh=None, *, device=None) -> list:
    """Encode uint8 images ([H, W, 3] RGB, or [H, W] gray promoted to RGB;
    numpy arrays or torch tensors, as in encode_grayscale_batch) as
    baseline YCbCr JFIF byte strings, in input order, byte-identical to
    jpegtpu's batch.encode_color_batch. The default config is 4:2:0 at
    Q50. mesh as in encode_grayscale_batch."""
    with span("entry.batch"):
        config = config or EncodeConfig(subsampling="420")
        devs = _prepare(images, config, mesh, 3, device)
        if config.restart_interval or config.entropy != "device":
            return [encode_color(image, config, device=devs[0])
                    for image in images]
        out: list = [None] * len(images)
        # 2-D and RGB images of one padded shape share a group (both
        # encode as RGB), as in jpegtpu
        groups = _groups(images, lambda image: padded_dims_color(
            *image.shape[:2], config.subsampling))
        for (ph, pw), idxs in groups.items():
            with span("batch.group"):
                files = _color_group([images[i] for i in idxs], ph, pw,
                                     config, devs)
            for i, data in zip(idxs, files):
                out[i] = data
        return out
