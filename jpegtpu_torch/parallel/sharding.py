"""Sharded encode: one image in bands of whole MCU rows, one band a
device (counterpart of `jpegtpu/parallel/sharding.py`: make_mesh,
shard_padded_dims, restart_subsegments, sharded_stitch_plan,
encode_grayscale_sharded and its stitched and per-segment routes).

A shard is a restart segment (or k of them, where a shard holds more
MCUs than DRI's 16-bit interval): its DC chains reset at its first
block, and its bytes are aligned, so each device encodes its band alone
and the host joins the bands with RST markers between. The mesh is an
ordered list of torch.devices, one a shard (make_mesh); several shards
may name one device. In one process the shards run one after another,
each on its device, and a rung's reads wait until every shard's kernels
are queued. Across processes (parallel.multihost) each process encodes
its own shards and the processes exchange the stuffed segments.

jpegtpu's rules decide the output and the kernels, so they stay:
  * the ladder starts at the config's first rung on every call (no site
    key, no history);
  * one process takes the stitched route at rungs <= 16 where jpegtpu's
    stitch plan is feasible at rungs 8 and 16: K12 lays each shard's
    segments back to back, and the host stuffs them with RST markers
    (phase (i * k) & 7, one after every shard but the last). Past rung
    16, across processes and where the plan fails, the per-segment
    route: each shard's segments by K8 + K11 (entropy.concat.
    encode_segments), each stuffed alone;
  * 2-pass symbol counts are summed over every shard (and process),
    floored, and every shard codes with the same tables; past rung 16
    the tables are dropped for the standard ones, as jpegtpu drops them;
  * the header's config is `restart_config`.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import tables
from ..config import EncodeConfig
from ..entropy.concat import LANES, encode_segments, stitch_plan
from ..entropy.device import (assemble_histograms, dc_differences,
                              symbol_histograms)
from ..entropy.pack import encode_blocks
from ..entropy.stitch import stitch_segments
from ..io import jfif, transfer
from ..ops import color
from ..ops.transform import transform
from ..pipeline import (_check_image, _optimal_specs, capacity_ladder,
                        kernel_cap, resolve_device)
from . import multihost


def make_mesh(n_devices: int | None = None, devices=None) -> list:
    """The mesh: an ordered list of torch.devices, one a shard. devices
    defaults to every CUDA device of this process; n_devices takes the
    first n. A device may repeat (make_mesh(4, devices=["cuda:0"] * 4):
    four shards on one card)."""
    devices = list(devices) if devices is not None else \
        multihost.local_devices()
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"{n_devices} shards asked of "
                             f"{len(devices)} devices")
        devices = devices[:n_devices]
    return [resolve_device(d) for d in devices]


def resolve_mesh(mesh=None, device=None) -> list:
    """The mesh an entry point runs on: `mesh` as given; else one shard on
    `device`, or make_mesh() (global_mesh() across processes)."""
    if mesh is not None:
        return [resolve_device(d) for d in mesh]
    devices = None if device is None else [device]
    if multihost.process_count() > 1:
        return multihost.global_mesh(devices)
    return make_mesh(devices=devices)


def shard_padded_dims(h: int, w: int, n_shards: int) -> tuple[int, int]:
    """Pad dims so width is a block multiple and height splits into
    n_shards equal bands of whole MCU rows."""
    ph = (h + 8 * n_shards - 1) // (8 * n_shards) * (8 * n_shards)
    pw = (w + 7) // 8 * 8
    return ph, pw


def restart_subsegments(rows_per_shard: int, mcus_per_row: int) -> int:
    """Restart interval R for equal shards of rows_per_shard MCU rows.
    DRI's payload is 16 bits (T.81 B.2.4.4), so a shard of more than
    65535 MCUs emits several segments, and R divides the shard so every
    segment boundary stays periodic. A whole-row R (mcus_per_row times a
    divisor of rows_per_shard) always exists; a larger plain divisor of
    the shard is preferred when a bounded search finds one."""
    total = rows_per_shard * mcus_per_row
    if total <= 0xFFFF:
        return total
    best = 0
    kmax = min(0xFFFF // mcus_per_row, rows_per_shard)
    for k in range(kmax, 0, -1):
        if rows_per_shard % k == 0:
            best = mcus_per_row * k
            break
    k = -(-total // 0xFFFF)
    for _ in range(4096):  # bounded: give up rather than scan O(total)
        if total % k == 0:
            best = max(best, total // k)
            break
        k += 1
    if best < 1:
        raise ValueError(f"no legal restart interval for shard geometry "
                         f"{rows_per_shard}x{mcus_per_row}")
    return best


def stitch_geometry(nb: int, seg_len: int, cap: int) -> tuple[int, int]:
    """(segments, segments per chunk) of jpegtpu's restart stitch for nb
    streams in segments of seg_len at cap words
    (jpegtpu.pipeline.stitch_geometry); 0 per chunk = infeasible."""
    n_seg = -(-nb // seg_len)
    seg128 = -(-seg_len // LANES) * LANES
    return n_seg, stitch_plan(n_seg, seg128, cap)


def sharded_stitch_plan(ph: int, pw: int, n: int, cap: int):
    """(k restart segments per shard, segments per chunk) of jpegtpu's
    stitched gray route for a padded ph x pw on n shards; 0 per chunk ->
    the per-segment route."""
    nb_local = (ph // n // 8) * (pw // 8)
    seg = restart_subsegments(ph // n // 8, pw // 8)
    k = nb_local // seg
    if k == 1:
        return 1, 1
    return k, stitch_geometry(nb_local, seg, cap)[1]


def restart_config(config: EncodeConfig, interval: int) -> EncodeConfig:
    """The config a sharded file's header is written with: the caller's
    quality, sampling and padding at the shards' restart interval."""
    return EncodeConfig(quality=config.quality,
                        subsampling=config.subsampling,
                        restart_interval=interval, pad_ones=config.pad_ones,
                        bitexact=config.bitexact)


def band(image: np.ndarray, i: int, n: int, ph: int, pw: int,
         device) -> torch.Tensor:
    """Shard i of n (whole rows) of the image edge-padded to ph x pw, on
    `device`: its rows of the image (the last row where the band starts
    below it) staged by io.transfer.stage."""
    ih = image.shape[0]
    r0, r1 = i * ph // n, (i + 1) * ph // n
    rows = image[r0:min(r1, ih)] if r0 < ih else image[ih - 1:]
    return transfer.stage([rows], (r1 - r0, pw, *image.shape[2:]),
                          torch.device(device))


class Shard(NamedTuple):
    index: int     # position in the mesh
    device: torch.device
    front: tuple   # what the caller's hist and streams read


def encode_shards(shards, config: EncodeConfig, n: int, k: int,
                  seg_len: int, stitched: bool, kinds, hist, streams):
    """The entropy half of a sharded encode, for this process's shards:
    climb the capacity ladder from the config's first rung, every shard
    at one rung, and return (the entropy segments for jfif.assemble, the
    2-pass specs or None).

    hist(front) -> symbol counts [2, HIST_SIZE] of a shard (2-pass);
    streams(front, cap, huffs, per_segment) -> (streams [C, k * seg_len],
    bits, per-stream overflow) at kernel cap `cap`, with K4 tables
    `huffs` (one a class of `kinds`, None for the standard ones) and the
    route (per_segment: the per-segment route's merge)."""
    specs = luts = None
    if config.optimize_huffman:
        counts = multihost.all_reduce_sum(
            sum(hist(s.front).cpu() for s in shards))
        specs = _optimal_specs(assemble_histograms(counts), kinds)
        luts = tables.huffman_luts_from_specs(specs)
    for cap in capacity_ladder(config):
        if specs is not None and cap > 16:
            specs = luts = None  # jpegtpu's tables ride rungs <= 16 only
        per_segment = not (stitched and cap <= 16)
        out = []
        for s in shards:
            huffs = None if luts is None else tuple(
                tables.huffman_table(luts, kind, s.device) for kind in kinds)
            words, bits, overflow = streams(s.front, kernel_cap(cap), huffs,
                                            per_segment)
            flag = overflow.any().to(torch.int64).reshape(1)
            if per_segment:
                st, totals = encode_segments(words, bits, seg_len,
                                             config.pad_ones)
                out.append((st, totals, torch.cat([flag, totals])))
            else:
                st, seg_tot, total = stitch_segments(words, bits, seg_len,
                                                     config.pad_ones)
                out.append((st, seg_tot, torch.cat([flag, total.reshape(1)])))
        heads = [head.tolist() for *_, head in out]
        overflowed = any(h[0] for h in heads)
        if not per_segment:
            if overflowed:
                continue
            parts = [transfer.read_restart_scan(
                st, seg_tot, h[1], rst_phase=(s.index * k) & 7,
                trailing=s.index < n - 1)
                for s, (st, seg_tot, _), h in zip(shards, out, heads)]
            return [b"".join(parts)], specs
        if multihost.any_process(overflowed):
            continue
        ids, segments = [], []
        for s, (st, _, _), h in zip(shards, out, heads):
            segments += transfer.read_segments(st, h[1:])
            ids += range(s.index * k, (s.index + 1) * k)
        return multihost.gather_segments(ids, segments, n * k), specs
    raise RuntimeError("worst-case entropy capacity overflowed (bug)")


def encode_grayscale_sharded(image: np.ndarray,
                             config: EncodeConfig | None = None, mesh=None,
                             orig_shape: tuple[int, int] | None = None, *,
                             device=None) -> bytes:
    """Encode an image (uint8 [H, W] or [H, W, 3] RGB) in len(mesh) shards
    as a grayscale JFIF whose scan is n * k restart segments, byte-
    identical to jpegtpu's encode_grayscale_sharded on a mesh of n (and so
    to a single-device encode at that restart interval). Across processes
    every process passes the whole image and returns the whole file.

    orig_shape: the (height, width) for the header when `image` is
    already padded by the caller. mesh: a list of devices (make_mesh);
    None: one shard on `device`, or make_mesh()."""
    config = config or EncodeConfig()
    mesh = resolve_mesh(mesh, device)
    n = len(mesh)
    _check_image(image, tensors=False)
    h, w = orig_shape if orig_shape is not None else image.shape[:2]
    ph, pw = shard_padded_dims(h, w, n)
    rows, nbw = ph // n // 8, pw // 8
    seg = restart_subsegments(rows, nbw)
    stitched = multihost.process_count() == 1 and all(
        sharded_stitch_plan(ph, pw, n, c)[1] > 0 for c in (8, 16))
    int_mode = config.dct_dtype == "int32"
    shards = []
    for i in multihost.local_shard_indices(mesh):
        x = band(image, i, n, ph, pw, mesh[i])
        y = color.rgb_to_y_reference(x) if image.ndim == 3 else x
        state = tables.encoder_state(config, mesh[i])
        levels = transform(y.contiguous(), state, int_mode)
        shards.append(Shard(i, mesh[i], (levels, dc_differences(levels[0],
                                                                 seg), state)))

    def hist(front):
        return symbol_histograms(front[0], front[1])

    def streams(front, cap, huffs, per_segment):
        levels, dcd, state = front
        words, bits = encode_blocks(levels, dcd,
                                    state.huff if huffs is None else huffs[0],
                                    cap)
        return words, bits, bits > cap * 32

    scan, specs = encode_shards(shards, config, n, rows * nbw // seg, seg,
                                stitched, ("lum",), hist, streams)
    return jfif.assemble(w, h, restart_config(config, seg), scan,
                         huffman_specs=specs)
