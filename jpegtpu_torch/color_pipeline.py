"""Single-image color encode, 4:2:0, 4:2:2 and 4:4:4 (counterpart of
`jpegtpu/color_pipeline.py`: encode_color, color_coefficients,
_scan_layout, the device body _fused_raw_planes + _color_merged_raw +
_color_encode_body_raw, the restart body _color_restart_body_raw, the
2-pass paths _color_stats_fn + _encode_color_optimized_device and
_encode_color_optimized_restart_device, and the sharded encode
encode_color_sharded with sharded_color_stitch_plan).

One MCU holds fy x fx luma blocks, one Cb and one Cr block (T.81 A.2.3);
luma uses table 0, chroma table 1, and each component has its own DC
predictor chain. The main path at EncodeConfig(subsampling="420") runs
six kernels on the card: K2 luma and K3 chroma transform of the
interleaved RGB (ops.transform) -> DC differences (luma along the scan's
luma chain, Cb and Cr each along the MCU raster) -> K4 twice, with the
luminance and the chrominance table (entropy.pack) -> K5 per-MCU
interleave (entropy.merge) -> K8 + K9 over the MCU streams
(entropy.concat; K10 in place of K9 past jpegtpu's resident budget,
color_concat_mode) -> tail padding. The host reads (overflow, total bits),
then the valid word prefix, and stuffs it. An overflow retries the
entropy chain at the next rung of the capacity ladder; the transforms run
once. Every rung runs the same kernels (jpegtpu leaves its Pallas chain
at cap 53; K4 here takes any cap).

With restart_interval (MCUs) every DC chain resets at each segment's
first MCU and K12 stitches the MCU streams into byte-aligned segments in
place of K8 + K9 (see pipeline). With optimize_huffman the levels and DC
chains are computed once: symbol_histograms counts the luma blocks into
the luminance classes and the chroma blocks into the chrominance ones,
and K4 encodes with the four optimal tables (all four go in the header).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import tables
from .config import EncodeConfig
from .entropy.concat import column_groups, concat_mode
from .entropy.device import (dc_differences, symbol_histograms,
                             y_dc_differences)
from .entropy.merge import (mcu_luma_blocks, merge_mcu, merge_streams,
                            slot_major_streams)
from .entropy.pack import encode_blocks
from .io import jfif, transfer
from .ops.blocks import (mcu_dims, padded_dims_color, sampling_factors,
                         slots_per_mcu)
from .ops.transform import transform_rgb_chroma, transform_rgb_y
from .parallel import multihost, sharding
from .pipeline import (_check_image, capacity_ladder, finish_streams,
                       host_scan, kernel_cap, optimal_tables, record_cap,
                       resolve_device)
from .tracing import span


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


def color_concat_mode(ph: int, pw: int, subsampling: str, cap: int) -> str:
    """jpegtpu's concat mode for a color frame padded to the MCU, ph x pw,
    at `cap` words per block: concat_mode of the MCU grid at the MCU
    streams' E * cap words, as its color body asks it
    (jpegtpu.color_pipeline._color_encode_body_raw). K9 serves
    "pallas-resident", K10 the other modes."""
    fy, fx = sampling_factors(subsampling)
    nmch, nmcw = ph // (8 * fy), pw // (8 * fx)
    return concat_mode(nmch, nmcw, slots_per_mcu(subsampling) * cap,
                       column_groups(nmcw))


def component_levels(image, config: EncodeConfig, dev: torch.device):
    """Edge-pad to the MCU and stage on dev as RGB (io.transfer.stage:
    the ring, or K13 for an image on the device) -> K2 and K3. Returns
    (luma levels [64, ny], chroma levels [64, 2 * nmcu] (Cb then Cr),
    encoder state, padded (ph, pw))."""
    if config.n_components != 3:
        raise ValueError("encode_color needs a color subsampling "
                         "(420, 422 or 444); use encode_grayscale for gray")
    _check_image(image)
    rgb = transfer.stage([image], (*padded_dims_color(
        *image.shape[:2], config.subsampling), 3), dev)
    with span("orch.tables"):
        state = tables.encoder_state(config, dev)
    int_mode = config.dct_dtype == "int32"
    with span("orch.front"):
        return (transform_rgb_y(rgb, state, int_mode),
                transform_rgb_chroma(rgb, state, int_mode, config.subsampling),
                state, tuple(rgb.shape[:2]))


def color_coefficients(image, config: EncodeConfig | None = None,
                       *, device=None):
    """Interleaved levels of a color encode, in scan order, with their
    layout (the host coder's input and the tests' oracle).

    image: uint8 [H, W, 3] RGB, or [H, W] gray (promoted to 3 channels),
    a numpy array or a tensor.
    Returns (zz [nslots, 64] int32, table_sel [nslots], comp_id [nslots])."""
    config = config or EncodeConfig(subsampling="420")
    ly, lc, _, (ph, pw) = component_levels(image, config,
                                           resolve_device(device))
    gather, table_sel, comp_id = _scan_layout(ph, pw, config.subsampling)
    allz = torch.cat([ly, lc], dim=1).T
    zz = allz[torch.from_numpy(gather).to(allz.device)]
    return zz.cpu().numpy(), table_sel, comp_id


def encode_color(image, config: EncodeConfig | None = None,
                 *, device=None) -> bytes:
    """Encode an image (uint8 [H, W, 3] RGB, or [H, W] gray promoted to
    RGB) as a baseline YCbCr JFIF byte string, byte-identical to
    jpegtpu's. The default config is 4:2:0 at Q50. The image is a numpy
    array or a torch tensor; one on the encode's device is staged there
    (io.transfer.stage_on_card), with the same bytes."""
    with span("entry.single"):
        config = config or EncodeConfig(subsampling="420")
        dev = resolve_device(device)
        h, w = image.shape[:2]
        if config.entropy == "host":
            zz, table_sel, comp_id = color_coefficients(image, config,
                                                        device=dev)
            segments, specs = host_scan(
                zz, config, ("lum", "chrom"), table_sel.astype(np.int64),
                comp_id, slots_per_mcu(config.subsampling))
        else:
            ly, lc, state, (ph, pw) = component_levels(image, config, dev)
            fy, fx = sampling_factors(config.subsampling)
            scan, specs = color_scan(ly, lc, state, ph // (8 * fy),
                                     pw // (8 * fx), config,
                                     key=(ph, pw, config, "color"))
            segments = [scan]
        with span("io.jfif"):
            return jfif.assemble(w, h, config, segments, huffman_specs=specs)


def color_scan(luma: torch.Tensor, chroma: torch.Tensor,
               state: tables.EncoderState, nmch: int, nmcw: int,
               config: EncodeConfig, key=None):
    """The entropy half of a color device encode: luma levels [64, ny]
    and chroma levels [64, 2 * nmcu] on a device -> (scan bytes, optimal
    specs for the header or None). The DC differences are computed once;
    with optimize_huffman pass 1 counts the luma blocks' symbols into the
    luminance classes and the chroma blocks' into the chrominance ones,
    and pass 2 encodes the same levels with the four optimal tables."""
    with span("orch.front"):
        dcd = color_dc_differences(luma, chroma, nmch, nmcw,
                                   config.subsampling, config.restart_interval)
    specs = None
    if config.optimize_huffman:
        with span("orch.tables"):
            specs, state = color_tables(luma, chroma, dcd, state)
    return encode_color_levels(luma, chroma, state, nmch, nmcw, config, key,
                               dcd), specs


def color_tables(luma: torch.Tensor, chroma: torch.Tensor, dcd,
                 state: tables.EncoderState):
    """Pass 1 of a color 2-pass encode: the luma blocks' symbols counted
    into the luminance classes and the chroma blocks' into the
    chrominance ones -> (the four optimal specs for the header, state
    with the optimal K4 tables)."""
    counts = (symbol_histograms(luma, dcd[0], 0)
              + symbol_histograms(chroma, dcd[1], 1))
    specs, (hl, hc) = optimal_tables(counts, ("lum", "chrom"), luma.device)
    return specs, state._replace(huff=hl, huff_chroma=hc)


def color_dc_differences(luma: torch.Tensor, chroma: torch.Tensor,
                         nmch: int, nmcw: int, subsampling: str,
                         seg_mcus: int = 0):
    """(luma DC differences [ny] along the scan's luma chain, Cb then Cr
    DC differences [2 * nmcu]), each chain reset at every seg_mcus-th MCU
    (a restart segment's first, or a stacked batch image's; 0 = never)."""
    fy, fx = sampling_factors(subsampling)
    dcd_y = y_dc_differences(luma[0].reshape(fy * nmch, fx * nmcw),
                             subsampling, seg_mcus)
    dcd_c = dc_differences(chroma[0].reshape(2, -1), seg_mcus)
    return dcd_y.reshape(-1), dcd_c.reshape(-1)


def encode_color_levels(luma: torch.Tensor, chroma: torch.Tensor,
                        state: tables.EncoderState, nmch: int, nmcw: int,
                        config: EncodeConfig, key=None, dcd=None) -> bytes:
    """The entropy half of the color device encode: luma levels [64, ny]
    and chroma levels [64, 2 * nmcu] on a device (and their DC
    differences, computed here when None) -> stuffed scan bytes,
    RST-delimited with restart_interval, climbing the capacity ladder on
    overflow. The tables are state.huff and state.huff_chroma. `key`
    names the encode site for capacity_ladder."""
    if dcd is None:
        with span("orch.front"):
            dcd = color_dc_differences(luma, chroma, nmch, nmcw,
                                       config.subsampling,
                                       config.restart_interval)
    ss = config.subsampling
    for cap in capacity_ladder(config, key):
        with span("orch.entropy"):  # the waits and reads inside are spans
            scan = finish_streams(*mcu_streams(luma, chroma, dcd, state,
                                               nmch, nmcw, ss,
                                               kernel_cap(cap)),
                                  nmch, nmcw, config, slots_per_mcu(ss) * cap)
        if scan is not None:
            record_cap(key, cap)
            return scan
    raise RuntimeError("worst-case entropy capacity overflowed (bug)")


def mcu_streams(luma: torch.Tensor, chroma: torch.Tensor, dcd,
                state: tables.EncoderState, nmch: int, nmcw: int,
                subsampling: str, cap: int):
    """K4 with the luminance and the chrominance table, then K5: levels
    and their DC differences -> (MCU streams [E * cap, nmcu], bits
    [nmcu], per-block overflow flags)."""
    wy, by = encode_blocks(luma, dcd[0], state.huff, cap)
    wc, bc = encode_blocks(chroma, dcd[1], state.huff_chroma, cap)
    merged, mbits = merge_mcu(wy, by, wc, bc, nmch, nmcw, subsampling)
    return merged, mbits, torch.cat([by, bc]) > cap * 32


def mcu_streams_slot_major(luma: torch.Tensor, chroma: torch.Tensor, dcd,
                           state: tables.EncoderState, nmch: int, nmcw: int,
                           subsampling: str, cap: int):
    """mcu_streams by jpegtpu's slot-major route (_mcu_streams_fused): K4
    with each table in raster order, a gather of its streams into
    slot-major planes [E, cap, nmcu] (entropy.merge.slot_major_streams:
    cap words a block, not 64 levels), then K6. nmch counts the MCU rows
    of a whole batch stacked vertically. The same outputs as
    mcu_streams."""
    wy, by = encode_blocks(luma, dcd[0], state.huff, cap)
    wc, bc = encode_blocks(chroma, dcd[1], state.huff_chroma, cap)
    merged, mbits = merge_streams(*slot_major_streams(
        wy, by, wc, bc, nmch, nmcw, subsampling))
    return merged, mbits, torch.cat([by, bc]) > cap * 32


def sharded_color_stitch_plan(ph: int, pw: int, cfg: EncodeConfig, n: int,
                              cap: int):
    """(k restart segments per shard, segments per chunk) of jpegtpu's
    stitched color route for an MCU-padded ph x pw on n shards; 0 per
    chunk -> the per-segment route."""
    mh, mw = mcu_dims(cfg.subsampling)
    rows, nmcw = ph // n // mh, pw // mw
    seg = sharding.restart_subsegments(rows, nmcw)
    k = rows * nmcw // seg
    if k == 1:
        return 1, 1
    return k, sharding.stitch_geometry(
        rows * nmcw, seg, slots_per_mcu(cfg.subsampling) * cap)[1]


def encode_color_sharded(image: np.ndarray, config: EncodeConfig | None = None,
                         mesh=None, orig_shape: tuple[int, int] | None = None,
                         *, device=None) -> bytes:
    """Encode an image (uint8 [H, W, 3] RGB, or [H, W] gray promoted to
    RGB) in len(mesh) shards of whole MCU rows as a YCbCr JFIF whose scan
    is n * k restart segments, byte-identical to jpegtpu's
    encode_color_sharded: each shard transforms its band (16 pixel rows
    an MCU row at 4:2:0, 8 at 4:4:4), resets its Y, Cb and Cr DC chains
    at its first MCU and codes its own segments (parallel.sharding holds
    the routes and rules). Each shard's MCU streams come from K4 with
    both tables and K5; jpegtpu's per-segment route with one segment a
    shard merges by K6 at rungs <= 16 (its slot-major route), as here.
    orig_shape, mesh and device as in encode_grayscale_sharded."""
    config = config or EncodeConfig(subsampling="420")
    if config.n_components != 3:
        raise ValueError("encode_color_sharded needs a color subsampling")
    mesh = sharding.resolve_mesh(mesh, device)
    n = len(mesh)
    _check_image(image, tensors=False)
    if image.ndim == 2:
        image = np.repeat(image[..., None], 3, axis=-1)
    ss = config.subsampling
    h, w = orig_shape if orig_shape is not None else image.shape[:2]
    mh, mw = mcu_dims(ss)
    ph = -(-h // (mh * n)) * mh * n
    pw = -(-w // mw) * mw
    rows, nmcw = ph // n // mh, pw // mw
    seg = sharding.restart_subsegments(rows, nmcw)
    k = rows * nmcw // seg
    stitched = multihost.process_count() == 1 and all(
        sharded_color_stitch_plan(ph, pw, config, n, c)[1] > 0
        for c in (8, 16))
    int_mode = config.dct_dtype == "int32"
    shards = []
    for i in multihost.local_shard_indices(mesh):
        rgb = sharding.band(image, i, n, ph, pw, mesh[i])
        state = tables.encoder_state(config, mesh[i])
        luma = transform_rgb_y(rgb, state, int_mode)
        chroma = transform_rgb_chroma(rgb, state, int_mode, ss)
        dcd = color_dc_differences(luma, chroma, rows, nmcw, ss, seg)
        shards.append(sharding.Shard(i, mesh[i], (luma, chroma, dcd, state)))

    def hist(front):
        luma, chroma, dcd, _ = front
        return (symbol_histograms(luma, dcd[0], 0)
                + symbol_histograms(chroma, dcd[1], 1))

    def streams(front, cap, huffs, per_segment):
        luma, chroma, dcd, state = front
        if huffs is not None:
            state = state._replace(huff=huffs[0], huff_chroma=huffs[1])
        slot_major = per_segment and k == 1 and cap <= 16
        return (mcu_streams_slot_major if slot_major else mcu_streams)(
            luma, chroma, dcd, state, rows, nmcw, ss, cap)

    scan, specs = sharding.encode_shards(shards, config, n, k, seg, stitched,
                                         ("lum", "chrom"), hist, streams)
    return jfif.assemble(w, h, sharding.restart_config(config, seg), scan,
                         huffman_specs=specs)
