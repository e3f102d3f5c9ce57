"""Smoke run of the jpegtpu_torch port on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written kernels from jpegtpu_torch/csrc and drives the
main paths at the reference's own image size, 3024 x 4032:
  gray   (encode_grayscale, EncodeConfig()): K1, K4, K8, K9;
  color  (encode_color, EncodeConfig(subsampling="420")): K2, K3, K4 with
         both tables, K5, K8, K9;
  gray restart (restart_interval=504, one block row per segment): K1, K4,
         K12;
  4:2:0 restart (restart_interval=252, one MCU row): K2, K3, K4, K5, K12;
  gray 2-pass (optimize_huffman=True): K1, K4 with runtime tables, K8, K9;
  4:2:0 restart 2-pass: K2, K3, K4 with runtime tables, K5, K12;
and the batch paths at the reference's batch configuration, 1024 images
of 512 x 512:
  gray batch (encode_grayscale_batch): K1, K4, K8 at segment width 64,
         K11;
  4:2:0 batch (encode_color_batch): K2, K3, K4, K5, K8 at width 32, K11;
  and both with shared 2-pass tables;
then the 8K frame, 7680 x 4320, gray and 4:2:0 (K10 in place of K9); the
staged levels -> scan entry point (encode_scan_device(fused=False): K7);
the configs that once failed (first rungs past K8's shared memory,
dct_dtype float64 / float16, stuff="device"); and the color batch of 16
images of 3024 x 4032 at 4:2:0, which merges its MCU streams by
jpegtpu's slot-major route: K2, K3, K4, a gather, K6, K8, K11. Then the
paths that run those kernels in new ways: serving (encode_stream of 16
distinct 3024 x 4032 images, gray and 4:2:0, at depths 1, 2 and 3: no
host sync in submit, files equal to single encodes, MPix/s, the
program's spans at depths 1 and 2, an overflowing image's fallback); sharded
(3024 x 4032 gray and 4:2:0 on 4 shards of the card, 1- and 2-pass: K12
per shard, int32 files equal to the CPU path); multiprocess (two
processes on the card over gloo, one shard each, started as
`chip_smoke.py --worker PORT RANK DIR`: K8 + K11, K6 for 4:2:0, files
equal to one process); batch_mesh (1024 x 512 x 512 gray on a mesh
of the card twice, files equal to no mesh); and on_card (64 planar
1080 x 1920 frames already on the card, read through .permute(1, 2, 0):
K13 against its plain version, RGB, gray and 70 mixed images, one launch
a 64, timed beside its bound and its twin; encode_color_batch at Q75
4:2:0 on the frames equal to the numpy input's files, with K13 and with
its twin). Last, tooling: the command
line (jpegtpu_torch.cli encode with and without --sharded and
--entropy host, encode-dir batched and --pipeline 2, profile) at 3024 x
4032 gray and 4:2:0, every file equal to the port's CPU path; the stage
profiles (profiling.format_report's tables, printed as they are); the
block report (debug.first_block_report) on the card equal to the CPU's
and to K1's levels; and the quality metrics (analysis.mse, psnr, ssim)
of each luma against its reconstruction from K1's levels.
Every source is built anew; the build line lists each kernel's registers,
spills and shared memory, and the run fails if a kernel of transform.cu,
pack.cu, merge.cu or concat.cu (K1-K11) spills. Right after the build,
one torch.profiler session counts the device kernels of one K13, K12,
K11, K10, K9, K8, K7 and K5 wrapper call (two for K12, one each), and the
kernel_edges phase holds K1-K5 and K7-K10 against their plain
versions, equal to the last level and word, on
tests/kernel_edge_cases.py's adversarial blocks, ragged grids, fused
elements, MCUs, rows (K8 at every segment width) and segments (K9 and
K10 with and without the tail padding) and on the main paths' images. K9 and K10 are timed as the
paths call them, with the tail padding inside.
For each path
it holds every kernel against its plain PyTorch version at the path's
shapes (K12 also at restart_interval 1, with a ragged last segment, and
on seeded streams at intervals 1, 2, 37 and n with both pads; K8 and K11
also at the top rung, K11 also with the pad left 0, on a 2-image batch
and on the K6 route, where it is timed too; K8 is timed at 8K and on
the K6 route as well), encodes end to end through
the entry point (launch counts reset just before and read just after),
checks the bytes against the port's CPU path (a batch file also against
its single-image encode), climbs the capacity ladder, and times each
kernel beside its bound. The color path also checks 4:2:2 and 4:4:4 at
1024 x 1536. Every timing line carries the card's name and power limit.
The line before the last lists the kernels as JSON, one entry per kernel
and path; the last line is the JSON {"ok": true, "device": {...}}. Any
failure exits non-zero before it. Needs one CUDA card; imports nothing of
JAX or of jpegtpu.
"""
from __future__ import annotations

import ctypes
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from jpegtpu_torch import (EncodeConfig, _build, batch, color_pipeline,
                           native, pipeline, tables, tracing)
from jpegtpu_torch.entropy import concat, device, merge, pack, stitch
from jpegtpu_torch.entropy import host as entropy_host
from jpegtpu_torch.entropy import treepack
from jpegtpu_torch.entropy.device import (MAX_WORDS_PER_BLOCK,
                                          assemble_histograms, dc_differences,
                                          symbol_histograms, y_dc_differences)
from jpegtpu_torch.io import transfer
from jpegtpu_torch.ops import stage, transform

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "tests"))
from kernel_edge_cases import (K7_CAPS, K8_CASES, K9_CASES,  # noqa: E402
                               K10_CASES, k4_blocks, k5_streams, k7_elements,
                               k8_case, k9_case, k10_case, transform_image)

H, W = 3024, 4032  # 12.19 MPix, the reference's image size
LADDER_H, LADDER_W = 512, 512
SIDE_H, SIDE_W = 1024, 1536  # the 4:2:2 and 4:4:4 checks
# the reference's batch configuration (bench.py:354-416): 1024 x 512 x 512
BATCH_N, BATCH_H, BATCH_W = 1024, 512, 512
TOP_N = 128  # images of the top-rung K8 / K11 checks
BIG_H, BIG_W = 4320, 7680  # the 8K frame, 33.2 MPix (bench.py:521-575)
K6_N = 16  # 3024 x 4032 images of the batch K6 phase
K6_RUNG16_N = 64  # 512 x 512 images of its rung-16 check
# the video frames of on_card_phases: 64 planar 1080 x 1920 frames a call,
# stacked at 1088 rows (whole 4:2:0 MCUs), and the mixed K13 case's count
VIDEO_N, VIDEO_H, VIDEO_W, VIDEO_PH = 64, 1080, 1920, 1088
STAGE_MIXED_N = 70  # two K13 launches: 64 + 6
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
REPS = 10
# sources whose kernels must build without spill stores (K1-K11)
NO_SPILL_SOURCES = ("transform", "pack", "merge", "concat")
# K10's segment counts at 8K, cap 8: gray (4,320 row segments of 128
# blocks) and 4:2:0 (1,080 of 128 MCUs)
K10_8K_SEGMENTS = {"8k_gray": 4320, "8k_420": 1080}
# K8's (segment width, words a block) on the paths: gray and 4:2:0 MCU
# streams at ws 128, the batches' ws 64 / 32, the 4:2:0 top rung
K8_WIDTH_CAPS = ((128, 8), (128, 48), (64, 8), (32, 48), (128, 318))
# transform_kernel's kinds (csrc/transform.cu)
TRANSFORM_KINDS = ("gray", "jfif_luma", "reference_luma", "chroma_420",
                   "chroma_422", "chroma_444")
SPIN_CYCLES = 20_000_000  # ~10 ms at the H100's ~1.98 GHz boost clock


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def ptxas_lines(report: str) -> list:
    """nvcc -Xptxas=-v's lines that name a kernel or give its registers,
    shared memory and spills."""
    return [ln.strip() for ln in report.splitlines()
            if "entry function" in ln or "registers" in ln or "spill" in ln]


def blocks_per_sm() -> dict:
    """Thread blocks one SM holds of each transform kind (256 threads), of
    K4 and K7 (128 threads, at any cap), of K5 (128 threads, at caps 8,
    16 and 53: its stage grows to 16 words a block), of K8 (max(ws, 32)
    threads, at K8_WIDTH_CAPS: its segment is in shared memory), of K9
    (512 threads, the 3024 x 4032 gray scan's 1,512 segment counts in
    shared memory) and of K10 (1024 threads, the 8K frame's segment
    counts): the CUDA runtime's occupancy
    calculator on the built kernels."""
    return {
        "merge_rows_kernel": {
            f"ws{ws}_cap{c}": _build.query(
                "concat", "merge_rows_per_sm", (ctypes.c_int, ctypes.c_int),
                ws, c) for ws, c in K8_WIDTH_CAPS},
        "merge_mcu_kernel": {
            cap: _build.query("merge", "merge_mcu_per_sm", (ctypes.c_int,),
                              cap) for cap in (8, 16, MAX_WORDS_PER_BLOCK)},
        "stream_concat_kernel": _build.query(
            "concat", "stream_concat_per_sm", (ctypes.c_int, ctypes.c_int),
            (H // 8) * (W // 8) // 128, 0),
        "transform_kernel": {
            kind: _build.query("transform", "transform_blocks_per_sm",
                               (ctypes.c_int,), i)
            for i, kind in enumerate(TRANSFORM_KINDS)},
        "encode_blocks_kernel": _build.query("pack", "encode_blocks_per_sm",
                                             ()),
        "pack_blocks_kernel": _build.query("pack", "pack_blocks_per_sm", ()),
        "stream_concat_chunked_kernel": {
            path: _build.query("concat", "stream_concat_chunked_per_sm",
                               (ctypes.c_int, ctypes.c_int), n, 0)
            for path, n in K10_8K_SEGMENTS.items()},
    }


def make_image(h: int, w: int) -> np.ndarray:
    """Photographic-complexity synthetic: smooth gradient + structured
    texture + noise, from a fixed seed."""
    rng = np.random.default_rng(42)
    yy, xx = np.mgrid[0:h, 0:w]
    grad = (xx + yy) * (255.0 / (h + w))
    tex = 20.0 * np.sin(xx / 3.1) * np.cos(yy / 2.7)
    noise = rng.normal(0, 6.0, (h, w))
    return np.clip(grad + tex + noise, 0, 255).astype(np.uint8)


def make_color_image(h: int, w: int) -> np.ndarray:
    """The color twin of make_image (bench.py's make_image(color=True)):
    G is the gray image, R and B lean the gradient and texture apart."""
    rng = np.random.default_rng(42)
    yy, xx = np.mgrid[0:h, 0:w]
    grad = (xx + yy) * (255.0 / (h + w))
    tex = 20.0 * np.sin(xx / 3.1) * np.cos(yy / 2.7)
    g = np.clip(grad + tex + rng.normal(0, 6.0, (h, w)), 0, 255)
    r = np.clip(grad * 0.9 + tex + rng.normal(0, 6.0, (h, w)), 0, 255)
    b = np.clip(grad * 1.1 - tex + rng.normal(0, 6.0, (h, w)), 0, 255)
    return np.stack([r, g, b], axis=-1).astype(np.uint8)


def time_ms(fn, reps: int = REPS) -> float:
    """Median device milliseconds of fn() on the card, by CUDA events.
    The card first spins (~10 ms) so that all of fn's launches are queued
    before it reaches them: the time is the device's, not the host's
    launch overhead (each wrapper call costs tens of microseconds of
    Python and ctypes)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def profile_rows(img, cfg) -> dict:
    """Milliseconds of each stage of one single-image encode on the card:
    jpegtpu_torch.profiling's rows (device rows by CUDA events behind a
    spin, host rows by the host clock; medians of 5)."""
    from jpegtpu_torch import profiling
    run = (profiling.profile_encode_color if cfg.n_components == 3
           else profiling.profile_encode)
    return {s.name: s.stage_ms for s in run(img, cfg)}


def u32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32).astype(np.int64)


def float_close(name: str, got: torch.Tensor, want: torch.Tensor) -> dict:
    """Float-mode levels: rare +-1 mismatches on float32 rounding ties
    (the natural_c tolerance) are allowed; none is expected."""
    diff = (got.cpu().long() - want.cpu().long()).abs()
    frac = float((diff > 0).float().mean())
    check(frac < 1e-4 and int(diff.max()) <= 1,
          f"{name} float: mismatch fraction {frac}, max {int(diff.max())}")
    return {"max_abs_err": int(diff.max()), "mismatch_fraction": frac}


def equal_streams(name: str, got, want) -> dict:
    """Kernel and plain (words, bits) pairs must be equal."""
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          f"{name}: kernel output differs from plain")
    return {"max_abs_err": int(np.abs(u32(got[0]) - u32(want[0])).max())}


def seeded_streams(c: int, n: int, seed: int, lengths=None):
    """n streams of c words on the card, zero past each one's bits, as K4
    and K5 store them: (words [c, n] int32, bits [n] int32). Bit counts
    are drawn from `lengths` (default: 0, 1-31, multiples of a byte and
    of a word, c * 32 and past it, and some of any length)."""
    rng = np.random.default_rng(seed)
    if lengths is None:
        lengths = np.concatenate([
            np.arange(0, 32), [8, 16, 24, 32, 40, 64, c * 32, c * 32 + 9],
            rng.integers(0, c * 32 + 1, 8)])
    bits = rng.choice(lengths, n)
    valid = (np.minimum(bits, 32 * c)[None, :]
             - 32 * np.arange(c)[:, None]).clip(0, 32)
    keep = ((1 << valid) - 1) << (32 - valid)
    words = rng.integers(0, 2**32, (c, n), dtype=np.int64) & keep
    return (torch.from_numpy(words.astype(np.uint32).view(np.int32)).cuda(),
            torch.from_numpy(bits.astype(np.int32)).cuda())


def k9_check_and_spec(name: str, segs, seg_bits, out_words: int,
                      pad_ones: bool):
    """K9 against its plain version at a path's shapes, without the tail
    padding and with the path's own (the plain version, then
    apply_tail_padding) -> (result, timing spec). The spec times K9 as the
    path calls it, beside its bound: the segments' valid words and bit
    counts in, the stream's valid words and the padded total out; the
    contract also writes every zero of the stream past the total, the
    second bound."""
    got = concat.stream_concat(segs, seg_bits, out_words)
    want = concat.stream_concat_plain(segs, seg_bits, out_words)
    padded = concat.stream_concat(segs, seg_bits, out_words, pad_ones)
    padded_p = concat.apply_tail_padding(want[0].clone(), want[1], pad_ones)
    result = equal_streams(name, (got[0], got[1].reshape(1)),
                           (want[0], want[1].reshape(1)))
    result_pad = equal_streams(f"{name} with the tail padding",
                               (padded[0], padded[1].reshape(1)),
                               (padded_p[0], padded_p[1].reshape(1)))
    result["max_abs_err"] = max(result["max_abs_err"],
                                result_pad["max_abs_err"])
    valid_seg_words = int(((seg_bits.long() + 31) // 32).sum())
    head = valid_seg_words * 4 + seg_bits.numel() * 4 + 8
    spec = ("stream_concat", "jpegtpu_torch/csrc/concat.cu",
            "jpegtpu/entropy/pallas_concat.py:337",
            lambda: concat.stream_concat(segs, seg_bits, out_words, pad_ones),
            lambda: concat.apply_tail_padding(*concat.stream_concat_plain(
                segs, seg_bits, out_words), pad_ones),
            head + (int(padded[1]) + 31) // 32 * 4, valid_seg_words * 2,
            {"bound_ms_whole_buffer": (head + out_words * 4)
             / HBM_BYTES_PER_S * 1e3})
    return result, spec


def k5_check_and_spec(name: str, wy, by, wc, bc, nmch: int, nmcw: int):
    """K5 against its plain version on a path's 4:2:0 block streams ->
    (result, timing spec), its bound the blocks' valid words and bit
    counts in, the [6 * cap, nmcu] frame and the MCUs' bit counts out."""
    result = equal_streams(name, merge.merge_mcu(wy, by, wc, bc, nmch, nmcw,
                                                 "420"),
                           merge.merge_mcu_plain(wy, by, wc, bc, nmch, nmcw,
                                                 "420"))
    nb, nmcu = by.numel() + bc.numel(), nmch * nmcw
    valid = int(((by.long() + 31) // 32).sum() + ((bc.long() + 31) // 32)
                .sum())
    spec = ("merge_mcu", "jpegtpu_torch/csrc/merge.cu",
            "jpegtpu/entropy/pallas_pack.py:867",
            lambda: merge.merge_mcu(wy, by, wc, bc, nmch, nmcw, "420"),
            lambda: merge.merge_mcu_plain(wy, by, wc, bc, nmch, nmcw, "420"),
            valid * 4 + nb * 4 + 6 * wy.shape[0] * nmcu * 4 + nmcu * 4,
            valid * 2)
    return result, spec


def wrapper_launches(say) -> None:
    """One call each of K13's, K12's, K11's, K10's, K9's, K8's, K7's and
    K5's wrappers in one torch.profiler session: the device kernels
    each launched, and their device microseconds, from key_averages().
    K12 runs on 190,512 seeded streams of 8 words at interval 504 (the
    3024 x 4032 gray restart grid), K11 on 64 images of the gray batch's
    64 row segments of 576 words, K10 on 4,320 seeded segments of 1,152
    words into the 8K gray stream's 4,148,736 words, K9 with the tail
    padding on 1,512 seeded segments of 1,152 words into the 3024 x 4032
    gray stream's 1,525,632 words, K8 on the K12 streams as the 3024 x
    4032 gray grid's row segments, K7 on 4,096 blocks of
    tests/kernel_edge_cases.py's fused elements, K5 on seeded block
    streams of the 3024 x 4032 4:2:0 grid, K13 on 64 planar 61 x 93
    RGB images read through .permute(1, 2, 0) into a 64 x 96 stack. Fails
    if the profiler sees device events and they are not two K12 launches
    and one each of the others; says so if it sees none."""
    from torch.profiler import ProfilerActivity, profile
    words, bits = seeded_streams(8, (H // 8) * (W // 8), 5)
    sw, sb = seeded_streams(576, 64 * 64, 6, np.arange(0, 4000))
    segs = sw.T.contiguous()
    cw, cb = seeded_streams(1152, K10_8K_SEGMENTS["8k_gray"], 7,
                            np.arange(0, 1152 * 8))
    csegs = cw.T.contiguous()
    ew, eb = k7_elements(4096, seed=8)
    ew = torch.from_numpy(ew.view(np.int32)).cuda()
    eb = torch.from_numpy(eb).cuda()
    nb = (H // 8) * (W // 8)
    gw, gb = seeded_streams(1152, nb // 128, 9, np.arange(0, 1152 * 4))
    gsegs = gw.T.contiguous()
    nmch, nmcw = H // 16, W // 16
    wy, by = seeded_streams(8, 4 * nmch * nmcw, 10)
    wc, bc = seeded_streams(8, 2 * nmch * nmcw, 11)
    planar = torch.randint(0, 256, (64, 3, 61, 93), dtype=torch.uint8,
                           device="cuda")
    frames = [f.permute(1, 2, 0) for f in planar]
    calls = {"stage_images": lambda: stage.stage_images(frames, (64, 96, 3)),
             "stitch_segments": lambda: stitch.stitch_segments(words, bits,
                                                               W // 8),
             "stream_concat_rows": lambda: concat.stream_concat_rows(
                 segs, sb, 64, 64 * 64 * 8),
             "stream_concat_chunked": lambda: concat.stream_concat_chunked(
                 csegs, cb, concat.stream_words(BIG_H * BIG_W // 64, 8)),
             "stream_concat": lambda: concat.stream_concat(
                 gsegs, gb, concat.stream_words(nb, 8), True),
             "merge_rows": lambda: concat.merge_rows(words, bits, H // 8,
                                                     W // 8),
             "pack_blocks": lambda: pack.pack_blocks(ew, eb, 8),
             "merge_mcu": lambda: merge.merge_mcu(wy, by, wc, bc, nmch, nmcw,
                                                  "420")}
    for fn in calls.values():  # built and loaded before the session
        fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for fn in calls.values():
                fn()
                torch.cuda.synchronize()
        seen = {e.key: (e.count, e.device_time_total / e.count)
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA}
    except Exception as e:  # the profiler itself failed on this machine
        say("device_launches", profiler_error=repr(e))
        return
    if not seen:
        say("device_launches", note="the profiler shows no device events")
        return
    owner = {"stage_images": ("stage_images_kernel",),
             "stitch_segments": ("stitch_scan_kernel",
                                 "stitch_segments_kernel"),
             "stream_concat_rows": ("stream_concat_rows_kernel",
                                    "rows_scan_kernel"),
             "stream_concat_chunked": ("stream_concat_chunked_kernel",),
             "stream_concat": ("stream_concat_kernel",),
             "merge_rows": ("merge_rows_kernel",),
             "pack_blocks": ("pack_blocks_kernel",),
             "merge_mcu": ("merge_mcu_kernel",)}
    mine = {k: w for k in seen for w, tags in owner.items()
            if any(t in k for t in tags)}
    counts = {w: sum(seen[k][0] for k in seen if mine.get(k) == w)
              for w in owner}
    other = sum(c for k, (c, _) in seen.items() if k not in mine)
    say("device_launches", launches=counts, other_device_events=other,
        kernels={k: {"count": c, "device_us": us}
                 for k, (c, us) in seen.items()})
    check(counts == {"stage_images": 1, "stitch_segments": 2,
                     "stream_concat_rows": 1,
                     "stream_concat_chunked": 1, "stream_concat": 1,
                     "merge_rows": 1, "pack_blocks": 1, "merge_mcu": 1}
          and other == 0,
          f"launches per wrapper call: {counts}, other events {other}")


def kernel_edge_phases(dev, say) -> None:
    """K1-K5 and K7-K10 against their plain versions, where every
    level and word must be equal (max_abs_err 0): K8 on
    tests/kernel_edge_cases.py's rows (K8_CASES) at every segment width
    16-128 (empty, sub-word, exactly full and clamped blocks, ragged and
    narrow rows, caps 1-8 and the 4:2:0 MCU streams' 48, 96 and 318); K7 on
    tests/kernel_edge_cases.py's fused elements (96-bit elements at every
    residue, exact word ends and cap overflow at caps 1, 8 and 53, nb 1,
    31, 33 and 1000, 64 and 130 elements a block), the overflow flag too;
    K10 and K9 on their segments (empty and sub-word segments, totals on
    a word and on a byte boundary, partial last words, one-segment
    streams, K9 also 30,000 segments) with the scan in shared memory and
    in global scratch, with no tail padding, a pad of 0s and one of 1s
    (against the plain version, then apply_tail_padding); K5 on its edge
    MCUs (empty, full and overflowed blocks, blocks of a few bits sharing
    a word) at 4:2:0, 4:2:2 and 4:4:4, caps 1, 8, 16, 17 and 53 (past 16
    it copies a block's later words in its walk); K4 on its
    adversarial blocks (nb 1, 31, 33 and 1000, the blocks past the tables
    among them; Annex-K and the blocks' optimal tables; caps 1, 8, 53); K1,
    K2 (both luma kinds) and K3 (4:2:0, 4:2:2, 4:4:4) on grids of 0/255,
    checkerboard, stripe and noise blocks whose block columns do not divide
    a tile, with rows on 16- and 8-byte boundaries, in float and int32
    mode; and K1-K4 on the main paths' images: 3024 x 4032, 7680 x 4320,
    and 64 of the batch's 512 x 512 images (the batch's geometry)."""
    errs = {}

    def diff(name, got, want):
        pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
        errs[name] = max(int((a.long() - b.long()).abs().max())
                         if a.numel() else 0 for a, b in pairs)

    def k4(name, lv, dcd, huff, caps=(1, 8, 53)):
        for cap in caps:
            diff(f"K4 {name} cap {cap}", pack.encode_blocks(lv, dcd, huff, cap),
                 pack.encode_blocks_plain(lv, dcd, huff, cap))

    def optimal(lv, dcd):
        return pipeline.optimal_tables(symbol_histograms(lv, dcd), ("lum",),
                                       dev)[1][0]

    for nb, n_elem in ((1, 64), (31, 64), (33, 64), (1000, 64), (300, 130)):
        ew, eb = k7_elements(nb, seed=nb + n_elem, n_elem=n_elem)
        ew = torch.from_numpy(ew.view(np.int32)).to(dev)
        eb = torch.from_numpy(eb).to(dev)
        for cap in K7_CAPS:
            got = pack.pack_blocks(ew, eb, cap)
            want = pack.pack_blocks_plain(ew, eb, cap)
            diff(f"K7 edges nb {nb} E {n_elem} cap {cap}",
                 (got[0], got[1], got[2]), (want[0], want[1], want[2]))
    for i, case in enumerate(K8_CASES):
        words, bits, nbh, nbw, _ = k8_case(i)
        words = torch.from_numpy(words.view(np.int32)).to(dev)
        bits = torch.from_numpy(bits).to(dev)
        for ws in concat.SEGMENT_WIDTHS:
            diff(f"K8 edges {case} ws {ws}",
                 concat.merge_rows(words, bits, nbh, nbw, ws),
                 concat.merge_rows_plain(words, bits, nbh, nbw, ws))
    smem_optin = concat._smem_optin
    for scan in ("shared", "global"):
        if scan == "global":  # the second launch, forced by a small limit
            concat._smem_optin = lambda device: 256
        try:
            for kernel, cases, case_of in (
                    ("K10", K10_CASES, k10_case), ("K9", K9_CASES, k9_case)):
                for i, case in enumerate(cases):
                    sg, sb, out_words = case_of(i)
                    sg = torch.from_numpy(sg.view(np.int32)).to(dev)
                    sb = torch.from_numpy(sb).to(dev)
                    want0 = (concat.stream_concat_chunked_plain(
                        sg, sb, out_words, concat.PLAIN_TILE)
                        if kernel == "K10" else
                        concat.stream_concat_plain(sg, sb, out_words))
                    join = (concat.stream_concat_chunked if kernel == "K10"
                            else concat.stream_concat)
                    for pad in (None, False, True):
                        got = join(sg, sb, out_words, pad)
                        want = (want0 if pad is None else
                                concat.apply_tail_padding(want0[0].clone(),
                                                          want0[1], pad))
                        diff(f"{kernel} edges {case} {scan} scan pad {pad}",
                             (got[0], got[1].reshape(1)),
                             (want[0], want[1].reshape(1)))
        finally:
            concat._smem_optin = smem_optin
    for ss in ("420", "422", "444"):
        for cap in (1, 8, 16, 17, MAX_WORDS_PER_BLOCK):
            streams = [torch.from_numpy(a.view(np.int32)).to(dev)
                       for a in k5_streams(9, 31, ss, cap, seed=cap)]
            diff(f"K5 edges {ss} cap {cap}",
                 merge.merge_mcu(*streams, 9, 31, ss),
                 merge.merge_mcu_plain(*streams, 9, 31, ss))

    annex_k = tables.encoder_state(EncodeConfig(), dev).huff
    for nb in (1, 31, 33, 1000):
        zz, dcd = k4_blocks(nb, seed=nb, past_table=True)
        lv = torch.from_numpy(zz.T.copy()).to(dev)
        d = torch.from_numpy(dcd).to(dev)
        k4(f"edges nb {nb} annex-k", lv, d, annex_k)
        k4(f"edges nb {nb} optimal", lv, d, optimal(lv, d))

    def offset(t: torch.Tensor) -> torch.Tensor:
        """t's copy starting 8 bytes past a 16-byte boundary."""
        buf = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
        buf[8:].view(t.shape).copy_(t)
        return buf[8:].view(t.shape)

    def transforms(tag, plane, rgb, subsamplings, state, modes=(False, True)):
        for im in modes:
            m = f"{tag} {'int32' if im else 'float'}"
            if plane is not None:
                diff(f"K1 {m}", transform.transform(plane, state, im),
                     transform.transform_plain(plane, state, im))
            if rgb is None:
                continue
            for ref in (False, True):
                diff(f"K2 {m} {'y_ref' if ref else 'jfif'}",
                     transform.transform_rgb_y(rgb, state, im, ref),
                     transform.transform_rgb_y_plain(rgb, state, im, ref))
            for ss in subsamplings:
                fy, fx = {"420": (2, 2), "422": (1, 2), "444": (1, 1)}[ss]
                if rgb.shape[0] % (8 * fy) or rgb.shape[1] % (8 * fx):
                    continue
                diff(f"K3 {m} {ss}",
                     transform.transform_rgb_chroma(rgb, state, im, ss),
                     transform.transform_rgb_chroma_plain(rgb, state, im, ss))

    st90 = tables.encoder_state(EncodeConfig(quality=90), dev)
    # ragged: 34, 1, 2, 66 and 130 block columns (17, 1, 33 and 65 4:2:0
    # ones); rows of 296 bytes alternate 16- and 8-byte boundaries
    for h, w in ((16, 272), (8, 8), (16, 16), (24, 296), (48, 528),
                 (80, 1040)):
        plane = torch.from_numpy(transform_image(h, w, seed=w)).to(dev)
        rgb = torch.from_numpy(transform_image(h, w, seed=h,
                                               channels=3)).to(dev)
        for x, y, tag in ((plane, rgb, f"{h}x{w}"),
                          (offset(plane), offset(rgb), f"{h}x{w} offset 8")):
            transforms(tag, x, y, ("420", "422", "444"), st90)

    state = tables.encoder_state(EncodeConfig(), dev)
    for h, w in ((H, W), (BIG_H, BIG_W)):
        plane = torch.from_numpy(make_image(h, w)).to(dev)
        rgb = torch.from_numpy(make_color_image(h, w)).to(dev)
        transforms(f"{h}x{w}", plane, rgb, ("420",), state)
        lv = transform.transform(plane, state, False)
        dcd = dc_differences(lv[0])
        k4(f"{h}x{w} gray", lv, dcd, state.huff, (8,))
        k4(f"{h}x{w} gray optimal", lv, dcd, optimal(lv, dcd), (8,))
        ly = transform.transform_rgb_y(rgb, state, False)
        lc = transform.transform_rgb_chroma(rgb, state, False, "420")
        dy, dc = color_pipeline.color_dc_differences(ly, lc, h // 16, w // 16,
                                                     "420", w // 16)
        k4(f"{h}x{w} 4:2:0 luma", ly, dy, state.huff, (8,))
        k4(f"{h}x{w} 4:2:0 chroma", lc, dc, state.huff_chroma, (8,))
    n = 64
    for color in (False, True):
        x = batch_images_on_card(n, BATCH_H, BATCH_W, color, seed=42)
        stack = x.reshape(n * BATCH_H, BATCH_W, *x.shape[3:])
        tag = f"batch {n} x {BATCH_H}x{BATCH_W}"
        transforms(tag, None if color else stack, stack if color else None,
                   ("420",), state)
        if not color:
            lv = transform.transform(stack, state, False)
            k4(f"{tag} gray", lv, dc_differences(
                lv[0], (BATCH_H // 8) * (BATCH_W // 8)), state.huff, (8,))
    bad = {k: v for k, v in errs.items() if v}
    say("kernel_edges", cases=len(errs), max_abs_err=max(errs.values()),
        nonzero=bad)
    check(not bad, f"kernel_edges: kernels differ from plain: {bad}")


def time_kernels(specs, launches: dict, results: dict, path: str, shape,
                 say) -> list:
    """Device ms of each kernel and of its plain version, beside the
    kernel's bound: the larger of its bytes (each input read once, each
    output written once) over the memory rate and its operations over the
    float32 rate. A spec may end with a dict of more fields for its
    entry."""
    entries = []
    for name, src, replaces, kern, plain, nbytes, ops, *extra in specs:
        ms = time_ms(kern)
        plain_ms = time_ms(plain, reps=3)
        byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
        op_ms = ops / FP32_OPS_PER_S * 1e3
        entry = {
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": results[name]["max_abs_err"], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(byte_ms, op_ms),
            "bound_by": "bytes" if byte_ms >= op_ms else "operations",
            "library_ms": None, "path": path, "shape": shape, "ok": True,
            **(extra[0] if extra else {}),
        }
        entries.append(entry)
        say("kernel_time", bound_bytes=nbytes, bound_ops=ops, **entry)
    return entries


def color_phases(dev, say) -> list:
    """The color main path (4:2:0, Q50): kernels against their plain
    versions, end to end through encode_color, 4:2:2 and 4:4:4, the
    capacity ladder, and the kernels' times. Returns the kernel entries."""
    cfg = EncodeConfig(subsampling="420")
    img = make_color_image(H, W)
    nmch, nmcw = H // 16, W // 16
    nmcu = nmch * nmcw
    ny, nc = 4 * nmcu, 2 * nmcu  # luma blocks; Cb + Cr blocks
    cap = cfg.capacity_words_per_block
    state = tables.encoder_state(cfg, dev)
    rgb = torch.from_numpy(img).to(dev)
    results = {}

    # --- 6. each color kernel against its plain version, main-path shapes
    ly = transform.transform_rgb_y(rgb, state, False)
    results["transform_rgb_y"] = float_close(
        "K2", ly, transform.transform_rgb_y_plain(rgb, state, False))
    lc = transform.transform_rgb_chroma(rgb, state, False, "420")
    results["transform_rgb_chroma"] = float_close(
        "K3", lc, transform.transform_rgb_chroma_plain(rgb, state, False,
                                                       "420"))
    check(torch.equal(transform.transform_rgb_y(rgb, state, True),
                      transform.transform_rgb_y_plain(rgb, state, True)),
          "K2 int32: kernel != plain")
    check(torch.equal(
        transform.transform_rgb_chroma(rgb, state, True, "420"),
        transform.transform_rgb_chroma_plain(rgb, state, True, "420")),
        "K3 int32: kernel != plain")

    dcd_y = y_dc_differences(ly[0].reshape(2 * nmch, 2 * nmcw),
                             "420").reshape(-1)
    dcd_c = dc_differences(lc[0].reshape(2, -1)).reshape(-1)
    wy, by = pack.encode_blocks(ly, dcd_y, state.huff, cap)
    wc, bc = pack.encode_blocks(lc, dcd_c, state.huff_chroma, cap)
    equal_streams("K4 luma", (wy, by),
                  pack.encode_blocks_plain(ly, dcd_y, state.huff, cap))
    results["encode_blocks"] = equal_streams(
        "K4 chroma", (wc, bc),
        pack.encode_blocks_plain(lc, dcd_c, state.huff_chroma, cap))
    check(int(torch.cat([by, bc]).max()) <= cap * 32,
          "K4: color main-path image overflowed cap 8")

    mw, mb = merge.merge_mcu(wy, by, wc, bc, nmch, nmcw, "420")
    results["merge_mcu"], k5_spec = k5_check_and_spec(
        "K5", wy, by, wc, bc, nmch, nmcw)
    segs, seg_bits = concat.merge_rows(mw, mb, nmch, nmcw)
    results["merge_rows"] = equal_streams(
        "K8 (MCU streams)", (segs, seg_bits),
        concat.merge_rows_plain(mw, mb, nmch, nmcw))
    out_words = concat.stream_words(nmcu, mw.shape[0])
    results["stream_concat"], k9_spec = k9_check_and_spec(
        "K9 (MCU streams)", segs, seg_bits, out_words, cfg.pad_ones)
    say("color_kernels_vs_plain", shape=[H, W, 3], subsampling="420",
        **results)

    # --- 7. color end to end through the entry point ---------------------
    for k in _build.LAUNCHES:
        _build.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    jpg = color_pipeline.encode_color(img)
    first_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    path_kernels = ("transform_rgb_y", "transform_rgb_chroma",
                    "encode_blocks", "merge_mcu", "merge_rows",
                    "stream_concat")
    check(all(launches[k] > 0 for k in path_kernels),
          f"color main path skipped a kernel: {launches}")
    check(jpg[:2] == b"\xff\xd8" and jpg[-2:] == b"\xff\xd9",
          "color output is not a JFIF stream")
    # float mode: levels within tolerance of the CPU path; the bytes equal
    # the CPU entropy chain fed the card's levels
    cpu = torch.device("cpu")
    ly_g, lc_g, _, _ = color_pipeline.component_levels(img, cfg, dev)
    ly_c, lc_c, cpu_state, _ = color_pipeline.component_levels(img, cfg, cpu)
    float_close("color luma levels vs CPU path", ly_g, ly_c)
    float_close("color chroma levels vs CPU path", lc_g, lc_c)
    scan = color_pipeline.encode_color_levels(ly_g.cpu(), lc_g.cpu(),
                                              cpu_state, nmch, nmcw, cfg)
    check(pipeline.jfif.assemble(W, H, cfg, [scan]) == jpg,
          "color float: card bytes != CPU entropy chain on the card's levels")
    cfg_int = EncodeConfig(subsampling="420", dct_dtype="int32")
    jpg_int = color_pipeline.encode_color(img, cfg_int)
    check(jpg_int == color_pipeline.encode_color(img, cfg_int, device="cpu"),
          "color int32: card bytes != CPU bytes")
    e2e_s = []
    for _ in range(5):
        t0 = time.perf_counter()
        color_pipeline.encode_color(img)
        e2e_s.append(time.perf_counter() - t0)
    e2e_med = float(np.median(e2e_s))
    say("color_end_to_end", shape=[H, W, 3], subsampling="420",
        quality=cfg.quality, bytes=len(jpg), bytes_int32=len(jpg_int),
        first_call_s=first_s, median_s=e2e_med,
        mpix_per_s=H * W / 1e6 / e2e_med, launches=launches)
    say("color_stage_breakdown_ms", shape=[H, W, 3], subsampling="420",
        **profile_rows(img, cfg))

    # --- 8. 4:2:2 and 4:4:4 ----------------------------------------------
    side = make_color_image(SIDE_H, SIDE_W)
    sizes = {}
    for ss in ("422", "444"):
        c = EncodeConfig(subsampling=ss, dct_dtype="int32")
        got = color_pipeline.encode_color(side, c)
        check(got == color_pipeline.encode_color(side, c, device="cpu"),
              f"{ss} int32: card bytes != CPU bytes")
        sizes[ss] = len(got)
    say("color_other_subsamplings", shape=[SIDE_H, SIDE_W, 3], bytes=sizes)

    # --- 9. color capacity ladder: K8 segments past 48 KB ----------------
    noise = np.random.default_rng(7).integers(
        0, 256, (LADDER_H, LADDER_W, 3), dtype=np.uint8)
    cfg_q100 = EncodeConfig(quality=100, dct_dtype="int32",
                            subsampling="420")
    before = _build.LAUNCHES["merge_mcu"]
    jpg_noise = color_pipeline.encode_color(noise, cfg_q100)
    rungs = _build.LAUNCHES["merge_mcu"] - before
    top = pipeline._cap_history[(LADDER_H, LADDER_W, cfg_q100, "color")][0]
    check(rungs == 3 and top == MAX_WORDS_PER_BLOCK,
          f"color ladder: {rungs} K5 launches, settled at cap {top}")
    check(jpg_noise == color_pipeline.encode_color(noise, cfg_q100,
                                                   device="cpu"),
          "color ladder: card bytes != CPU bytes")
    say("color_capacity_ladder", shape=[LADDER_H, LADDER_W, 3], rungs=rungs,
        cap=top, merge_rows_segment_bytes=[(6 * c + 1) * 512
                                           for c in (8, 16, 53)],
        bytes=len(jpg_noise))

    # --- 10. color kernel timings and bounds -----------------------------
    nb = ny + nc
    valid_mcu_words = int(((mb.long() + 31) // 32).sum())
    nseg, seg_words = segs.shape
    tab = 3 * 64 * 4  # quant + both bases
    specs = [
        ("transform_rgb_y", "jpegtpu_torch/csrc/transform.cu",
         "jpegtpu/ops/pallas_transform.py:464",
         lambda: transform.transform_rgb_y(rgb, state, False),
         lambda: transform.transform_rgb_y_plain(rgb, state, False),
         H * W * 3 + 64 * ny * 4 + tab, ny * 2 * 1024),
        ("transform_rgb_chroma", "jpegtpu_torch/csrc/transform.cu",
         "jpegtpu/ops/pallas_transform.py:505",
         lambda: transform.transform_rgb_chroma(rgb, state, False, "420"),
         lambda: transform.transform_rgb_chroma_plain(rgb, state, False,
                                                      "420"),
         H * W * 3 + 64 * nc * 4 + tab, nc * 2 * 1024),
        # both launches of the path: luma table, then chroma table
        ("encode_blocks", "jpegtpu_torch/csrc/pack.cu",
         "jpegtpu/entropy/pallas_pack.py:560",
         lambda: (pack.encode_blocks(ly, dcd_y, state.huff, cap),
                  pack.encode_blocks(lc, dcd_c, state.huff_chroma, cap)),
         lambda: (pack.encode_blocks_plain(ly, dcd_y, state.huff, cap),
                  pack.encode_blocks_plain(lc, dcd_c, state.huff_chroma,
                                           cap)),
         64 * nb * 4 + nb * 4 + 2 * tables.HUFF_SIZE * 4 + cap * nb * 4
         + nb * 4, 64 * nb),
        k5_spec,
        ("merge_rows", "jpegtpu_torch/csrc/concat.cu",
         "jpegtpu/entropy/pallas_concat.py:240",
         lambda: concat.merge_rows(mw, mb, nmch, nmcw),
         lambda: concat.merge_rows_plain(mw, mb, nmch, nmcw),
         valid_mcu_words * 4 + nmcu * 4 + nseg * seg_words * 4 + nseg * 4,
         valid_mcu_words * 2),
        k9_spec,
    ]
    kernels = time_kernels(specs, launches, results, "color", [H, W, 3], say)
    for name, fn in (
        ("transform_rgb_y",
         lambda: transform.transform_rgb_y(rgb, state, True)),
        ("transform_rgb_chroma",
         lambda: transform.transform_rgb_chroma(rgb, state, True, "420")),
    ):
        say("kernel_time_int32", name=name, shape=[H, W, 3], ms=time_ms(fn))
    return kernels


def restart_stage_breakdown(img, cfg, reps: int = 5) -> dict:
    """Host-clock milliseconds of each stage of one gray restart encode
    (restart_interval from cfg), each ended by a synchronize (medians)."""
    stages = {}

    def mark(name, t0):
        torch.cuda.synchronize()
        stages.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
        return time.perf_counter()

    h, w = img.shape
    cap = cfg.capacity_words_per_block
    for _ in range(reps):
        t = time.perf_counter()
        plane = torch.from_numpy(img).cuda()
        state = tables.encoder_state(cfg, "cuda")
        t = mark("h2d_image_and_tables", t)
        lv = transform.transform(plane, state, False)
        t = mark("K1_transform", t)
        dcd = dc_differences(lv[0], cfg.restart_interval)
        t = mark("dc_differences_with_resets", t)
        words, bits = pack.encode_blocks(lv, dcd, state.huff, cap)
        t = mark("K4_pack", t)
        stream, seg_tot, total = stitch.stitch_segments(
            words, bits, cfg.restart_interval, cfg.pad_ones)
        t = mark("K12_stitch_scan_and_segments", t)
        ov, total_bits = torch.stack(
            [(bits > cap * 32).any().to(torch.int64), total]).tolist()
        t = mark("d2h_overflow_and_total", t)
        nw = (total_bits + 31) // 32
        host = torch.cat([stream[:nw], seg_tot]).cpu().numpy()
        t = mark("d2h_words_and_segment_totals", t)
        scan = native.scan_from_words(host[:nw].view(np.uint32),
                                      host[nw:].astype(np.int64) // 8)
        t = mark("host_scan_from_words", t)
        pipeline.jfif.assemble(w, h, cfg, [scan])
        mark("host_assemble", t)
    return {k: float(np.median(v)) for k, v in stages.items()}


def two_pass_stage_breakdown(img, cfg, reps: int = 5) -> dict:
    """Host-clock milliseconds of each stage of one gray 2-pass encode,
    each ended by a synchronize (medians over reps)."""
    stages = {}

    def mark(name, t0):
        torch.cuda.synchronize()
        stages.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
        return time.perf_counter()

    h, w = img.shape
    nbh, nbw = h // 8, w // 8
    cap = cfg.capacity_words_per_block
    for _ in range(reps):
        t = time.perf_counter()
        plane = torch.from_numpy(img).cuda()
        state = tables.encoder_state(cfg, "cuda")
        t = mark("h2d_image_and_tables", t)
        lv = transform.transform(plane, state, False)
        t = mark("K1_transform", t)
        dcd = dc_differences(lv[0])
        t = mark("dc_differences", t)
        counts = symbol_histograms(lv, dcd)
        t = mark("symbol_histograms", t)
        counts = counts.cpu()
        t = mark("d2h_symbol_counts", t)
        specs, (huff,) = pipeline.optimal_tables(counts, ("lum",), "cuda")
        t = mark("host_table_build_and_h2d", t)
        words, bits = pack.encode_blocks(lv, dcd, huff, cap)
        t = mark("K4_pack_runtime_tables", t)
        stream, total = concat.concat_stream(words, bits, nbh, nbw,
                                             pad_ones=cfg.pad_ones)
        t = mark("K8_K9_concat_and_tail_pad", t)
        ov, total_bits = torch.stack(
            [(bits > cap * 32).any().to(torch.int64), total]).tolist()
        words_np = stream[: (total_bits + 31) // 32].cpu().numpy()
        t = mark("d2h_overflow_total_and_words", t)
        scan = native.words_to_stuffed(words_np.view(np.uint32), total_bits)
        t = mark("host_stuff", t)
        pipeline.jfif.assemble(w, h, cfg, [scan], huffman_specs=specs)
        mark("host_assemble", t)
    return {k: float(np.median(v)) for k, v in stages.items()}


def restart_and_two_pass_phases(dev, say) -> list:
    """Restart intervals (K12) and 2-pass optimal tables (K4 with runtime
    tables), gray and 4:2:0: kernels against their plain versions, end to
    end through the entry points in four configs, the capacity ladder,
    stage breakdowns and the kernels' times. Returns the kernel entries."""
    img, rgb_img = make_image(H, W), make_color_image(H, W)
    nbh, nbw = H // 8, W // 8
    nmch, nmcw = H // 16, W // 16
    cap = 8
    cfg_g = EncodeConfig(restart_interval=nbw)  # one block row: 504
    cfg_c = EncodeConfig(subsampling="420", restart_interval=nmcw)  # 252
    state = tables.encoder_state(cfg_c, dev)
    lv = transform.transform(torch.from_numpy(img).to(dev), state, False)
    rgb = torch.from_numpy(rgb_img).to(dev)
    ly = transform.transform_rgb_y(rgb, state, False)
    lc = transform.transform_rgb_chroma(rgb, state, False, "420")

    def stitch_check(name, words, bits, seg_len, pad_ones=True):
        got = stitch.stitch_segments(words, bits, seg_len, pad_ones)
        want = stitch.stitch_segments_plain(words, bits, seg_len, pad_ones)
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"K12 {name} interval {seg_len}: kernel != plain")
        return {"max_abs_err": int(np.abs(u32(got[0]) - u32(want[0])).max()),
                "segments": int(got[1].shape[0]), "bits": int(got[2])}

    # --- 11. K12 against its plain version, 3024 x 4032 ------------------
    k12 = {}
    for ri in (nbw, 1, 1000):  # a block row; every block; ragged tail
        dcd = dc_differences(lv[0], ri)
        words, bits = pack.encode_blocks(lv, dcd, state.huff, cap)
        k12[f"gray_{ri}"] = stitch_check("gray", words, bits, ri)
        if ri == nbw:
            g_streams = (words, bits)
            k12[f"gray_{ri}_pad_zeros"] = stitch_check("gray", words, bits,
                                                       ri, False)
    for ri in (nmcw, 1):  # an MCU row; every MCU
        dy, dc = color_pipeline.color_dc_differences(ly, lc, nmch, nmcw,
                                                     "420", ri)
        wy, by = pack.encode_blocks(ly, dy, state.huff, cap)
        wc, bc = pack.encode_blocks(lc, dc, state.huff_chroma, cap)
        mw, mb = merge.merge_mcu(wy, by, wc, bc, nmch, nmcw, "420")
        k12[f"420_{ri}"] = stitch_check("4:2:0", mw, mb, ri)
        if ri == nmcw:
            c_streams = (mw, mb)
    say("stitch_vs_plain", shape=[H, W], **k12)

    # --- 11b. K12's edge cases: seeded bit counts, intervals 1, 2, 37, n
    say("stitch_edge_cases_vs_plain", **stitch_edge_cases())

    # --- 12. K4 with the images' optimal tables against its plain version
    dcd_g = dc_differences(lv[0])
    specs_g, (huff_g,) = pipeline.optimal_tables(
        symbol_histograms(lv, dcd_g), ("lum",), dev)
    dcd_y, dcd_c = color_pipeline.color_dc_differences(ly, lc, nmch, nmcw,
                                                       "420", nmcw)
    specs_c, (huff_l, huff_c) = pipeline.optimal_tables(
        symbol_histograms(ly, dcd_y, 0) + symbol_histograms(lc, dcd_c, 1),
        ("lum", "chrom"), dev)
    rt = {}
    for name, lev, dcd, huff in (("gray", lv, dcd_g, huff_g),
                                 ("420_luma", ly, dcd_y, huff_l),
                                 ("420_chroma", lc, dcd_c, huff_c)):
        rt[name] = equal_streams(
            f"K4 runtime tables {name}",
            pack.encode_blocks(lev, dcd, huff, cap),
            pack.encode_blocks_plain(lev, dcd, huff, cap))
    say("runtime_tables_vs_plain", shape=[H, W],
        longest_code_bits={k: int(v[0].nonzero()[0].max()) + 1
                           for k, v in {**specs_g, **specs_c}.items()},
        **rt)

    # --- 13. end to end through the entry points, four configs -----------
    cfg_g2 = EncodeConfig(optimize_huffman=True)
    cfg_c2 = EncodeConfig(subsampling="420", restart_interval=nmcw,
                          optimize_huffman=True)
    gray_k = ("transform", "encode_blocks")
    color_k = ("transform_rgb_y", "transform_rgb_chroma", "encode_blocks",
               "merge_mcu")
    k12_k = ("stitch_scan", "stitch_segments")
    runs = [
        ("gray_restart", cfg_g, img, gray_k + k12_k),
        ("420_restart", cfg_c, rgb_img, color_k + k12_k),
        ("gray_2pass", cfg_g2, img, gray_k + ("merge_rows", "stream_concat")),
        ("420_restart_2pass", cfg_c2, rgb_img, color_k + k12_k),
    ]
    cpu = torch.device("cpu")
    launches = {}
    for name, cfg, im, path_kernels in runs:
        gray = cfg.n_components == 1
        encode = (pipeline.encode_grayscale if gray
                  else color_pipeline.encode_color)
        for k in _build.LAUNCHES:
            _build.LAUNCHES[k] = 0
        t0 = time.perf_counter()
        jpg = encode(im, cfg)
        first_s = time.perf_counter() - t0
        launches[name] = dict(_build.LAUNCHES)
        check(all(launches[name][k] > 0 for k in path_kernels),
              f"{name} skipped a kernel: {launches[name]}")
        check(jpg[:2] == b"\xff\xd8" and jpg[-2:] == b"\xff\xd9",
              f"{name}: output is not a JFIF stream")
        # float mode: the bytes equal the CPU entropy chain (2-pass table
        # build included) fed the card's levels
        cpu_state = tables.encoder_state(cfg, cpu)
        if gray:
            scan, specs = pipeline.gray_scan(lv.cpu(), cpu_state, nbh, nbw,
                                             cfg)
        else:
            scan, specs = color_pipeline.color_scan(
                ly.cpu(), lc.cpu(), cpu_state, nmch, nmcw, cfg)
        check(pipeline.jfif.assemble(W, H, cfg, [scan],
                                     huffman_specs=specs) == jpg,
              f"{name} float: card bytes != CPU entropy chain on the card's "
              "levels")
        cfg_int = dataclasses.replace(cfg, dct_dtype="int32")
        jpg_int = encode(im, cfg_int)
        check(jpg_int == encode(im, cfg_int, device="cpu"),
              f"{name} int32: card bytes != CPU bytes")
        e2e_s = []
        for _ in range(5):
            t0 = time.perf_counter()
            encode(im, cfg)
            e2e_s.append(time.perf_counter() - t0)
        e2e_med = float(np.median(e2e_s))
        say("end_to_end", path=name, shape=list(im.shape),
            restart_interval=cfg.restart_interval,
            optimize_huffman=cfg.optimize_huffman, bytes=len(jpg),
            bytes_int32=len(jpg_int), first_call_s=first_s,
            median_s=e2e_med, mpix_per_s=H * W / 1e6 / e2e_med,
            launches=launches[name])

    # --- 14. capacity ladder: gray restart, 4:2:0 restart 2-pass ---------
    noise = np.random.default_rng(7).integers(
        0, 256, (LADDER_H, LADDER_W, 3), dtype=np.uint8)
    for name, cfg, im in (
        ("gray_restart",
         EncodeConfig(quality=100, dct_dtype="int32",
                      restart_interval=LADDER_W // 8),
         noise[..., 0]),
        ("420_restart_2pass",
         EncodeConfig(quality=100, dct_dtype="int32", subsampling="420",
                      restart_interval=LADDER_W // 16,
                      optimize_huffman=True),
         noise),
    ):
        gray = cfg.n_components == 1
        key = ((LADDER_H // 8, LADDER_W // 8, cfg, False) if gray
               else (LADDER_H, LADDER_W, cfg, "color"))
        encode = (pipeline.encode_grayscale if gray
                  else color_pipeline.encode_color)
        before = _build.LAUNCHES["stitch_segments"]
        jpg_noise = encode(im, cfg)
        rungs = _build.LAUNCHES["stitch_segments"] - before
        top = pipeline._cap_history[key][0]
        check(rungs == 3 and top == MAX_WORDS_PER_BLOCK,
              f"{name} ladder: {rungs} K12 launches, settled at cap {top}")
        check(jpg_noise == encode(im, cfg, device="cpu"),
              f"{name} ladder: card bytes != CPU bytes")
        say("capacity_ladder", path=name, shape=list(im.shape), rungs=rungs,
            cap=top, bytes=len(jpg_noise))

    # --- 15. stage breakdowns -------------------------------------------
    say("stage_breakdown_ms", path="gray_restart", shape=[H, W],
        **restart_stage_breakdown(img, cfg_g))
    say("stage_breakdown_ms", path="gray_2pass", shape=[H, W],
        **two_pass_stage_breakdown(img, cfg_g2))

    # --- 16. timings and bounds -----------------------------------------
    def k12_spec(path, words, bits, seg_len):
        """K12's bound as counted since PR 3 (the valid output words), and
        beside it the bound with the whole buffer written once."""
        stream, seg_tot, total = stitch.stitch_segments(words, bits, seg_len)
        valid = int(((bits.long() + 31) // 32).sum())
        inputs = valid * 4 + bits.numel() * 4 + seg_tot.numel() * 4
        whole = inputs + stream.numel() * 4
        return ("stitch_segments", "jpegtpu_torch/csrc/stitch.cu",
                "jpegtpu/entropy/pallas_concat.py:553",
                lambda: stitch.stitch_segments(words, bits, seg_len),
                lambda: stitch.stitch_segments_plain(words, bits, seg_len),
                inputs + (int(total) + 31) // 32 * 4, valid * 2,
                {"launches_scan": launches[path]["stitch_scan"],
                 "bound_ms_whole_buffer": whole / HBM_BYTES_PER_S * 1e3})

    def k4_spec(pairs):
        nb = sum(lev.shape[1] for lev, _, _ in pairs)
        return ("encode_blocks", "jpegtpu_torch/csrc/pack.cu",
                "jpegtpu/entropy/pallas_pack.py:237",
                lambda: [pack.encode_blocks(lev, d, h, cap)
                         for lev, d, h in pairs],
                lambda: [pack.encode_blocks_plain(lev, d, h, cap)
                         for lev, d, h in pairs],
                64 * nb * 4 + nb * 4 + len(pairs) * tables.HUFF_SIZE * 4
                + cap * nb * 4 + nb * 4, 64 * nb)

    kernels = []
    for path, spec, result in (
        ("gray_restart", k12_spec("gray_restart", *g_streams,
                                  cfg_g.restart_interval),
         k12[f"gray_{nbw}"]),
        ("420_restart", k12_spec("420_restart", *c_streams,
                                 cfg_c.restart_interval),
         k12[f"420_{nmcw}"]),
        ("gray_2pass", k4_spec([(lv, dcd_g, huff_g)]), rt["gray"]),
        ("420_restart_2pass",
         k4_spec([(ly, dcd_y, huff_l), (lc, dcd_c, huff_c)]),
         {"max_abs_err": max(rt["420_luma"]["max_abs_err"],
                             rt["420_chroma"]["max_abs_err"])}),
    ):
        kernels += time_kernels([spec], launches[path], {spec[0]: result},
                                path, [H, W], say)
    dcd1 = dc_differences(lv[0], 1)
    w1, b1 = pack.encode_blocks(lv, dcd1, state.huff, cap)
    valid1 = int(((b1.long() + 31) // 32).sum())
    s1, st1, tot1 = stitch.stitch_segments(w1, b1, 1)
    inputs1 = (valid1 + b1.numel() + st1.numel()) * 4
    say("kernel_time", name="stitch_segments", path="gray_restart_1",
        shape=[H, W], ms=time_ms(lambda: stitch.stitch_segments(w1, b1, 1)),
        plain_ms=time_ms(lambda: stitch.stitch_segments_plain(w1, b1, 1),
                         reps=3),
        bound_ms=(inputs1 + (int(tot1) + 31) // 32 * 4) / HBM_BYTES_PER_S
        * 1e3,
        bound_ms_whole_buffer=(inputs1 + s1.numel() * 4) / HBM_BYTES_PER_S
        * 1e3)
    return kernels


def stitch_edge_cases() -> dict:
    """K12 against its plain version, whole buffers compared, on 190,512
    seeded streams of 8 words (the 3024 x 4032 gray grid): bit counts
    0, 1-31, multiples of a byte and of a word, 256 and past it
    (clamped), at intervals 1, 2, 37 and n, with both pads. Returns, for
    each interval, how many segment totals end on a byte and on a word."""
    c, n = 8, (H // 8) * (W // 8)
    words, bits = seeded_streams(c, n, 17)
    out = {}
    for seg_len in (1, 2, 37, n):
        err = 0
        for pad_ones in (True, False):
            got = stitch.stitch_segments(words, bits, seg_len, pad_ones)
            want = stitch.stitch_segments_plain(words, bits, seg_len,
                                                pad_ones)
            check(all(torch.equal(a, b) for a, b in zip(got, want)),
                  f"K12 edge cases, interval {seg_len}, pad_ones "
                  f"{pad_ones}: kernel != plain")
            err = max(err, int(np.abs(u32(got[0]) - u32(want[0])).max()))
        _, seg_bits, _, _ = stitch.segment_offsets(bits, seg_len, 256)
        out[f"interval_{seg_len}"] = {
            "max_abs_err": err, "segments": int(got[1].shape[0]),
            "ending_on_a_byte": int((seg_bits % 8 == 0).sum()),
            "ending_on_a_word": int((seg_bits % 32 == 0).sum())}
    return out


def batch_images(n: int, h: int, w: int, color: bool, seed: int) -> np.ndarray:
    """n distinct images of make_image's (or make_color_image's) content,
    each with its own noise and brightness, made on the card from a seed:
    uint8 [n, h, w] or [n, h, w, 3] on the host."""
    return batch_images_on_card(n, h, w, color, seed).cpu().numpy()


def batch_images_on_card(n: int, h: int, w: int, color: bool,
                         seed: int) -> torch.Tensor:
    """batch_images, left on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    yy = torch.arange(h, device="cuda", dtype=torch.float32)[:, None]
    xx = torch.arange(w, device="cuda", dtype=torch.float32)[None, :]
    grad = (xx + yy) * (255.0 / (h + w))
    tex = 20.0 * torch.sin(xx / 3.1) * torch.cos(yy / 2.7)
    shift = (torch.arange(n, device="cuda") % 61 - 30).float()[:, None, None]

    def chan(a: float, b: float) -> torch.Tensor:
        noise = torch.randn((n, h, w), generator=g, device="cuda")
        return grad * a + tex * b + shift + 6.0 * noise

    x = (torch.stack([chan(0.9, 1.0), chan(1.0, 1.0), chan(1.1, -1.0)], -1)
         if color else chan(1.0, 1.0))
    return x.clamp(0, 255).to(torch.uint8)


def batch_phases(dev, say) -> list:
    """The batch main path (M5) at the reference's batch configuration,
    1024 images of 512 x 512, gray and 4:2:0 (bench.py:354-416): K8 at the
    batch's segment width and K11 against their plain versions (cap 8 on
    the batch, the top rung on a smaller noise batch), end to end through
    encode_grayscale_batch / encode_color_batch with every file held
    against the single-image encode, shared 2-pass tables against the CPU
    entropy chain on the card's levels, stage breakdowns, reduced-size
    checks against the CPU path, and the kernels' times. Returns the
    kernel entries."""
    n, h, w = BATCH_N, BATCH_H, BATCH_W
    cap = 8
    cpu = torch.device("cpu")
    g = torch.Generator(device="cuda").manual_seed(7)
    entries = []
    for kind in ("gray", "420"):
        color = kind == "420"
        cfg = EncodeConfig(subsampling="420") if color else EncodeConfig()
        encode_batch = (batch.encode_color_batch if color
                        else batch.encode_grayscale_batch)
        encode_one = (color_pipeline.encode_color if color
                      else pipeline.encode_grayscale)
        shape = [n, h, w, 3] if color else [n, h, w]
        t0 = time.perf_counter()
        arr = batch_images(n, h, w, color, seed=42)
        images = list(arr)
        say("batch_images", path=f"batch_{kind}", shape=shape,
            seconds=time.perf_counter() - t0)

        # --- 17. K8 (segment width) and K11 against their plain versions
        def streams_of(x, c, cap):
            """Stack x [m, h, w(, 3)] on the card -> (words, bits, nbh,
            nbw, levels, dcd) of its first rung's K4 (and K5)."""
            m = x.shape[0]
            st = tables.encoder_state(c, dev)
            int_mode = c.dct_dtype == "int32"
            if color:
                rgb = x.reshape(m * h, w, 3)
                ly = transform.transform_rgb_y(rgb, st, int_mode)
                lc = transform.transform_rgb_chroma(rgb, st, int_mode, "420")
                nbh, nbw = h // 16, w // 16
                dcd = color_pipeline.color_dc_differences(
                    ly, lc, m * nbh, nbw, "420", nbh * nbw)
                wd, bt, _ = color_pipeline.mcu_streams(ly, lc, dcd, st,
                                                       m * nbh, nbw, "420",
                                                       cap)
                return wd, bt, nbh, nbw, (ly, lc), dcd
            lv = transform.transform(x.reshape(m * h, w), st, int_mode)
            nbh, nbw = h // 8, w // 8
            dcd = dc_differences(lv[0], nbh * nbw)
            wd, bt = pack.encode_blocks(lv, dcd, st.huff, cap)
            return wd, bt, nbh, nbw, (lv,), dcd

        def k8_k11(words, bits, m, nbh, nbw, name):
            ws = batch.segment_width(nbw)
            segs, seg_bits = concat.merge_rows(words, bits, m * nbh, nbw, ws)
            res = {"merge_rows": equal_streams(
                f"K8 ws={ws} {name}", (segs, seg_bits),
                concat.merge_rows_plain(words, bits, m * nbh, nbw, ws))}
            args = (segs, seg_bits, segs.shape[0] // m,
                    words.shape[0] * nbh * nbw, True)
            res["stream_concat_rows"] = equal_streams(
                f"K11 {name}", concat.stream_concat_rows(*args),
                concat.stream_concat_rows_plain(*args))
            return res, ws, (segs, seg_bits), args

        x = torch.from_numpy(arr).to(dev)
        words, bits, nbh, nbw, levels, dcd = streams_of(x, cfg, cap)
        check(int(bits.max()) <= cap * 32,
              f"batch {kind}: the batch overflowed cap 8")
        results, ws, (segs, seg_bits), k11_args = k8_k11(
            words, bits, n, nbh, nbw, f"batch {kind} cap 8")
        k5_spec = None
        if color:  # K5 on the stack's block streams
            st = tables.encoder_state(cfg, dev)
            results["merge_mcu"], k5_spec = k5_check_and_spec(
                "K5 batch", *pack.encode_blocks(levels[0], dcd[0], st.huff,
                                                cap),
                *pack.encode_blocks(levels[1], dcd[1], st.huff_chroma, cap),
                n * nbh, nbw)
        # K11 with the pad left 0, and on a 2-image batch
        per = k11_args[2]
        k11_edge = {}
        for name, args in (
                ("pad_zeros", k11_args[:4] + (False,)),
                ("two_images", (segs[:2 * per], seg_bits[:2 * per], per,
                                k11_args[3], True))):
            k11_edge[name] = equal_streams(
                f"K11 {name} batch {kind}", concat.stream_concat_rows(*args),
                concat.stream_concat_rows_plain(*args))
        noise = torch.randint(0, 256, [TOP_N] + shape[1:], generator=g,
                              device=dev, dtype=torch.uint8)
        cfg100 = dataclasses.replace(cfg, quality=100, dct_dtype="int32")
        top = MAX_WORDS_PER_BLOCK
        wt, bt, *_ = streams_of(noise, cfg100, top)
        top_res, _, (segs_t, _), _ = k8_k11(wt, bt, TOP_N, nbh, nbw,
                                            f"batch {kind} cap {top}")
        del wt, bt
        say("batch_kernels_vs_plain", path=f"batch_{kind}", shape=shape,
            segment_width=ws, segments=int(segs.shape[0]),
            segment_words=int(segs.shape[1]), cap8=results,
            k11_edge_cases=k11_edge,
            top_rung={"cap": top, "images": TOP_N, "content": "Q100 noise",
                      "segment_words": int(segs_t.shape[1]), **top_res})
        del segs_t

        # --- 18. end to end through the batch entry point --------------
        for k in _build.LAUNCHES:
            _build.LAUNCHES[k] = 0
        t0 = time.perf_counter()
        files = encode_batch(images, cfg)
        first_s = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        path_kernels = (("transform_rgb_y", "transform_rgb_chroma",
                         "encode_blocks", "merge_mcu") if color
                        else ("transform", "encode_blocks"))
        path_kernels += ("merge_rows", "stream_concat_rows")
        check(all(launches[k] > 0 for k in path_kernels),
              f"batch {kind} skipped a kernel: {launches}")
        t0 = time.perf_counter()
        for i, im in enumerate(images):
            check(files[i] == encode_one(im, cfg),
                  f"batch {kind}: file {i} != its single-image encode")
        single_s = time.perf_counter() - t0
        e2e_s = []
        for _ in range(5):
            t0 = time.perf_counter()
            encode_batch(images, cfg)
            e2e_s.append(time.perf_counter() - t0)
        e2e_med = float(np.median(e2e_s))
        say("batch_end_to_end", path=f"batch_{kind}", shape=shape,
            quality=cfg.quality, bytes=sum(map(len, files)),
            first_call_s=first_s, median_s=e2e_med, runs_s=e2e_s,
            mpix_per_s=n * h * w / 1e6 / e2e_med, launches=launches,
            files_equal_single_image=n, single_image_encodes_s=single_s)
        say("batch_spans", path=f"batch_{kind}", shape=shape,
            **traced_call(lambda: encode_batch(images, cfg)))

        # --- 19. shared 2-pass tables at the same size -------------------
        cfg2 = dataclasses.replace(cfg, optimize_huffman=True)
        check((batch.color_raw_ok(h, w, "420", cap) if color
               else batch.shares_gray_tables(h, w, cap)),
              f"batch {kind}: 2-pass tables are not shared at {h} x {w}")
        t0 = time.perf_counter()
        files2 = encode_batch(images, cfg2)
        two_pass_s = time.perf_counter() - t0
        # the CPU entropy chain on the card's levels: the port's histogram
        # and table build over the whole batch, then its numpy host coder
        # on every 16th image
        lv_cpu = [t.cpu() for t in levels]
        dcd_cpu = [t.cpu() for t in dcd] if color else [dcd.cpu()]
        counts = sum(symbol_histograms(lv, d, t)
                     for t, (lv, d) in enumerate(zip(lv_cpu, dcd_cpu)))
        kinds = ("lum", "chrom") if color else ("lum",)
        specs = pipeline._optimal_specs(assemble_histograms(counts), kinds)
        luts = tables.huffman_luts_from_specs(specs)
        headers = pipeline.jfif.assemble(w, h, cfg2, [b""],
                                         huffman_specs=specs)[:-2]
        check(all(f.startswith(headers) for f in files2),
              f"batch {kind} 2-pass: a file's tables != the CPU tables")
        if color:
            gather, sel, comp = color_pipeline._scan_layout(h, w, "420")
            ny, nm = 4 * nbh * nbw, nbh * nbw
        held = list(range(0, n, 16))
        for i in held:
            if color:
                ly_c, lc_c = lv_cpu
                allz = torch.cat([ly_c[:, i * ny:(i + 1) * ny],
                                  lc_c[:, i * nm:(i + 1) * nm],
                                  lc_c[:, (n + i) * nm:(n + i + 1) * nm]], 1)
                zz = allz.T[torch.from_numpy(gather)].numpy()
                scan = entropy_host.encode_scan(zz, sel.astype(np.int64),
                                                comp, luts=luts)
            else:
                nb = nbh * nbw
                zz = lv_cpu[0][:, i * nb:(i + 1) * nb].T.numpy()
                scan = entropy_host.encode_scan(zz, luts=luts)
            check(files2[i] == pipeline.jfif.assemble(
                w, h, cfg2, scan, huffman_specs=specs),
                f"batch {kind} 2-pass: file {i} != CPU chain on card levels")
        del lv_cpu, dcd_cpu, levels, dcd
        cfg2i = dataclasses.replace(cfg2, dct_dtype="int32")
        check(encode_batch(images[:16], cfg2i)
              == encode_batch(images[:16], cfg2i, device="cpu"),
              f"batch {kind} 2-pass int32: card bytes != CPU batch path")
        say("batch_two_pass", path=f"batch_{kind}", shape=shape,
            seconds=two_pass_s, bytes=sum(map(len, files2)),
            bytes_single_pass=sum(map(len, files)),
            files_with_cpu_tables=n, files_held_against_cpu_chain=len(held),
            int32_images_equal_cpu=len(images[:16]))

        # --- 20. timings and bounds -------------------------------------
        valid_words = int(((bits.long() + 31) // 32).sum())
        valid_seg_words = int(((seg_bits.long() + 31) // 32).sum())
        nseg, seg_words = segs.shape
        slab_bytes = n * k11_args[3] * 4
        specs_t = [
            ("merge_rows", "jpegtpu_torch/csrc/concat.cu",
             "jpegtpu/entropy/pallas_concat.py:240",
             lambda: concat.merge_rows(words, bits, n * nbh, nbw, ws),
             lambda: concat.merge_rows_plain(words, bits, n * nbh, nbw, ws),
             valid_words * 4 + bits.numel() * 4 + nseg * seg_words * 4
             + nseg * 4, valid_words * 2),
            ("stream_concat_rows", "jpegtpu_torch/csrc/concat.cu",
             "jpegtpu/entropy/pallas_concat.py:412",
             lambda: concat.stream_concat_rows(*k11_args),
             lambda: concat.stream_concat_rows_plain(*k11_args),
             valid_seg_words * 4 + nseg * 4 + slab_bytes + n * 8,
             valid_seg_words * 2),
        ]
        if k5_spec:
            specs_t.append(k5_spec)
        entries += time_kernels(specs_t, launches, results, f"batch_{kind}",
                                shape, say)
        del x, words, bits, segs, seg_bits, k11_args, files2, k5_spec
        torch.cuda.empty_cache()

    # --- 21. reduced size: geometries, the ladder, leaving shared tables
    rng = np.random.default_rng(11)
    # jpegtpu's own batch test shapes (tests/test_batch.py:220)
    mixed = [np.roll(make_image(hh, ww), 5 * j, axis=1)
             for hh, ww, k in ((48, 760, 2), (64, 640, 3), (40, 1366, 2),
                               (56, 200, 5)) for j in range(k)]
    mixed += [np.repeat(im[..., None], 3, -1) for im in mixed[:4]]
    ladder = [make_image(LADDER_H, LADDER_W),
              rng.integers(0, 256, (LADDER_H, LADDER_W), np.uint8)]
    reduced = {}
    for name, encode, cfg, images, kernel, want_launches in (
        ("mixed_gray", batch.encode_grayscale_batch,
         EncodeConfig(dct_dtype="int32"), mixed, "stream_concat_rows", 6),
        ("mixed_420", batch.encode_color_batch,
         EncodeConfig(dct_dtype="int32", subsampling="420"), mixed,
         "stream_concat_rows", 4),
        ("ladder_gray_q100", batch.encode_grayscale_batch,
         EncodeConfig(dct_dtype="int32", quality=100), ladder,
         "merge_rows", 3),
        ("two_pass_420_leaves_shared_tables", batch.encode_color_batch,
         EncodeConfig(dct_dtype="int32", quality=100, subsampling="420",
                      optimize_huffman=True),
         [np.repeat(im[..., None], 3, -1) for im in ladder],
         "stream_concat_rows", 1),
    ):
        before = _build.LAUNCHES[kernel]
        got = encode(images, cfg)
        launched = _build.LAUNCHES[kernel] - before
        check(launched == want_launches,
              f"{name}: {launched} {kernel} launches, not {want_launches}")
        check(got == encode(images, cfg, device="cpu"),
              f"{name}: card bytes != CPU batch path")
        reduced[name] = {"images": len(images), kernel: launched,
                         "bytes": sum(map(len, got))}
    say("batch_reduced_size", **reduced)
    return entries

def large_frame_phases(dev, say) -> list:
    """The 8K single frame, 7680 x 4320 (bench.py:521-575), gray and 4:2:0
    at Q50: past jpegtpu's resident-concat budget, so the scan's concat is
    K10. K10 against its plain version and against K9 on the same
    segments, end to end through encode_grayscale / encode_color (K10
    launched, K9 not), the bytes against the CPU path (gray int32) or the
    CPU entropy chain fed the card's levels (float, and 4:2:0 int32),
    e2e MPix/s, a stage breakdown and K8's, K10's and K9's device times;
    then a
    3024 x 4032 4:2:0 Q100 noise encode whose upper rungs lie past the
    budget. Returns the kernel entries."""
    cpu = torch.device("cpu")
    entries = []
    for kind in ("gray", "420"):
        color = kind == "420"
        cfg = EncodeConfig(subsampling="420") if color else EncodeConfig()
        cfg_int = dataclasses.replace(cfg, dct_dtype="int32")
        encode = (color_pipeline.encode_color if color
                  else pipeline.encode_grayscale)
        cap = cfg.capacity_words_per_block
        t0 = time.perf_counter()
        img = (make_color_image(BIG_H, BIG_W) if color
               else make_image(BIG_H, BIG_W))
        made_s = time.perf_counter() - t0
        state = tables.encoder_state(cfg, dev)
        x = torch.from_numpy(img).to(dev)

        def levels(int_mode):
            if color:
                return (transform.transform_rgb_y(x, state, int_mode),
                        transform.transform_rgb_chroma(x, state, int_mode,
                                                       "420"))
            return (transform.transform(x, state, int_mode),)

        def streams(lv):
            """The scan's streams at cap 8: (words, bits, nbh, nbw)."""
            if color:
                nbh, nbw = BIG_H // 16, BIG_W // 16
                dcd = color_pipeline.color_dc_differences(*lv, nbh, nbw,
                                                          "420")
                words, bits, _ = color_pipeline.mcu_streams(
                    *lv, dcd, state, nbh, nbw, "420", cap)
            else:
                nbh, nbw = BIG_H // 8, BIG_W // 8
                words, bits = pack.encode_blocks(lv[0], dc_differences(
                    lv[0][0]), state.huff, cap)
            return words, bits, nbh, nbw

        # --- 22. K10 against its plain version and K9, 8K segments ------
        mode = (color_pipeline.color_concat_mode(BIG_H, BIG_W, "420", cap)
                if color else pipeline.gray_concat_mode(BIG_H, BIG_W, cap))
        check(mode != "pallas-resident",
              f"8K {kind}: the port's decision says K9 ({mode})")
        lv = levels(False)
        words, bits, nbh, nbw = streams(lv)
        check(int(bits.max()) <= cap * 32, f"8K {kind}: overflowed cap 8")
        segs, seg_bits = concat.merge_rows(words, bits, nbh, nbw)
        out_words = concat.stream_words(nbh * nbw, words.shape[0])
        # jpegtpu's chunks hold this many segments at 8K; the plain
        # version's stream does not depend on it
        tile = 17
        k10 = concat.stream_concat_chunked(segs, seg_bits, out_words)
        plain = concat.stream_concat_chunked_plain(segs, seg_bits, out_words,
                                                   tile)
        k9 = concat.stream_concat(segs, seg_bits, out_words)
        result = equal_streams(f"K10 8K {kind}", (k10[0], k10[1].reshape(1)),
                               (plain[0], plain[1].reshape(1)))
        check(torch.equal(k10[0], k9[0]) and int(k10[1]) == int(k9[1]),
              f"K10 8K {kind}: stream != K9's on the same segments")
        say("large_frame_kernels_vs_plain", path=f"8k_{kind}",
            shape=list(img.shape), concat_mode=mode, segments=int(
                segs.shape[0]), segment_words=int(segs.shape[1]),
            stream_words=out_words, k10_blocks=concat.chunked_blocks(
                out_words, concat._chunked_resident(
                    dev, int(segs.shape[0]), False)),
            stream_concat_chunked=result, equal_to_k9=True,
            image_seconds=made_s)

        # --- 23. end to end through the entry point ---------------------
        for k in _build.LAUNCHES:
            _build.LAUNCHES[k] = 0
        t0 = time.perf_counter()
        jpg = encode(img, cfg)
        first_s = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        path_kernels = (("transform_rgb_y", "transform_rgb_chroma",
                         "encode_blocks", "merge_mcu") if color
                        else ("transform", "encode_blocks"))
        path_kernels += ("merge_rows", "stream_concat_chunked")
        check(all(launches[k] > 0 for k in path_kernels)
              and launches["stream_concat"] == 0,
              f"8K {kind}: not K10's route: {launches}")
        check(jpg[:2] == b"\xff\xd8" and jpg[-2:] == b"\xff\xd9",
              f"8K {kind}: output is not a JFIF stream")
        # float: the bytes equal the CPU entropy chain fed the card's
        # levels; int32: gray equal to the CPU path, 4:2:0 to the CPU
        # entropy chain fed the card's int32 levels (its CPU transform
        # would double the phase)
        t0 = time.perf_counter()
        cpu_state = tables.encoder_state(cfg, cpu)

        def cpu_chain(lv, c):
            if color:
                return color_pipeline.encode_color_levels(
                    *(t.cpu() for t in lv), cpu_state, nbh, nbw, c)
            return pipeline.encode_levels(lv[0].cpu(), cpu_state.huff, nbh,
                                          nbw, c)

        check(pipeline.jfif.assemble(BIG_W, BIG_H, cfg,
                                     [cpu_chain(lv, cfg)]) == jpg,
              f"8K {kind} float: card bytes != CPU entropy chain on the "
              "card's levels")
        del words, bits, segs, seg_bits, k10, plain, k9, lv
        jpg_int = encode(img, cfg_int)
        if color:
            lv_int = levels(True)
            want_int = pipeline.jfif.assemble(
                BIG_W, BIG_H, cfg_int, [cpu_chain(lv_int, cfg_int)])
            del lv_int
            int_check = "cpu_entropy_chain_on_card_int32_levels"
        else:
            want_int = encode(img, cfg_int, device="cpu")
            int_check = "cpu_path"
        check(jpg_int == want_int, f"8K {kind} int32: card bytes != "
              f"{int_check}")
        cpu_s = time.perf_counter() - t0
        e2e_s = []
        for _ in range(5):
            t0 = time.perf_counter()
            encode(img, cfg)
            e2e_s.append(time.perf_counter() - t0)
        e2e_med = float(np.median(e2e_s))
        say("end_to_end", path=f"8k_{kind}", shape=list(img.shape),
            quality=cfg.quality, bytes=len(jpg), bytes_int32=len(jpg_int),
            int32_held_against=int_check, cpu_checks_s=cpu_s,
            first_call_s=first_s, median_s=e2e_med, runs_s=e2e_s,
            mpix_per_s=BIG_H * BIG_W / 1e6 / e2e_med, launches=launches)
        say("stage_breakdown_ms", path=f"8k_{kind}", shape=list(img.shape),
            **profile_rows(img, cfg))

        # --- 24. K8, K10 and K9 at 8K, device ms and bounds -------------
        lv = levels(False)
        words, bits, nbh, nbw = streams(lv)
        segs, seg_bits = concat.merge_rows(words, bits, nbh, nbw)
        k10_total = int(concat.stream_concat_chunked(segs, seg_bits,
                                                     out_words)[1])
        valid_seg_words = int(((seg_bits.long() + 31) // 32).sum())
        # the segments' valid words and bit counts in, the stream's valid
        # words and the total out; the contract also writes every zero of
        # the stream past the total, the second bound
        nbytes = (valid_seg_words * 4 + segs.shape[0] * 4
                  + (k10_total + 31) // 32 * 4 + 8)
        whole = valid_seg_words * 4 + segs.shape[0] * 4 + out_words * 4 + 8
        # as the path calls it: with the tail padding
        spec = ("stream_concat_chunked", "jpegtpu_torch/csrc/concat.cu",
                "jpegtpu/entropy/pallas_concat.py:762",
                lambda: concat.stream_concat_chunked(segs, seg_bits,
                                                     out_words, cfg.pad_ones),
                lambda: concat.apply_tail_padding(
                    *concat.stream_concat_chunked_plain(
                        segs, seg_bits, out_words, tile), cfg.pad_ones),
                nbytes, valid_seg_words * 2,
                {"bound_ms_whole_buffer": whole / HBM_BYTES_PER_S * 1e3})
        # K8 on the frame's streams: the blocks' valid words and bit
        # counts in, every segment word and the segments' counts out
        valid_words = int(((bits.long() + 31) // 32).sum())
        specs = [spec, (
            "merge_rows", "jpegtpu_torch/csrc/concat.cu",
            "jpegtpu/entropy/pallas_concat.py:240",
            lambda: concat.merge_rows(words, bits, nbh, nbw),
            lambda: concat.merge_rows_plain(words, bits, nbh, nbw),
            valid_words * 4 + bits.numel() * 4 + segs.numel() * 4
            + segs.shape[0] * 4, valid_words * 2)]
        results = {"stream_concat_chunked": result,
                   "merge_rows": equal_streams(
                       f"K8 8K {kind}", (segs, seg_bits),
                       concat.merge_rows_plain(words, bits, nbh, nbw))}
        if color:
            nmch, nmcw = BIG_H // 16, BIG_W // 16
            dy, dc = color_pipeline.color_dc_differences(*lv, nmch, nmcw,
                                                         "420")
            k5_in = (pack.encode_blocks(lv[0], dy, state.huff, cap)
                     + pack.encode_blocks(lv[1], dc, state.huff_chroma, cap))
            results["merge_mcu"], k5_spec = k5_check_and_spec(
                "K5 8K", *k5_in, nmch, nmcw)
            specs.append(k5_spec)
        entries += time_kernels(specs, launches, results, f"8k_{kind}",
                                list(img.shape), say)
        # K9 and K10 on the same segments, in turns
        turns = [("K9", lambda: concat.stream_concat(
                     segs, seg_bits, out_words, cfg.pad_ones)),
                 ("K10", lambda: concat.stream_concat_chunked(
                     segs, seg_bits, out_words, cfg.pad_ones))]
        times = {}
        for name, fn in turns + turns[::-1]:
            times.setdefault(name, []).append(time_ms(fn))
        say("k9_vs_k10", path=f"8k_{kind}", shape=list(img.shape),
            k9_ms=times["K9"], k10_ms=times["K10"],
            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
            bound_ms_whole_buffer=whole / HBM_BYTES_PER_S * 1e3)
        del x, lv, words, bits, segs, seg_bits, specs, results
        torch.cuda.empty_cache()

    # --- 25. below 8K: a 4:2:0 ladder whose upper rungs are chunked ------
    noise = np.random.default_rng(7).integers(0, 256, (H, W, 3),
                                              dtype=np.uint8)
    cfg = EncodeConfig(quality=100, dct_dtype="int32", subsampling="420")
    modes = [color_pipeline.color_concat_mode(H, W, "420", c)
             for c in (8, 16, MAX_WORDS_PER_BLOCK)]
    for k in _build.LAUNCHES:
        _build.LAUNCHES[k] = 0
    jpg = color_pipeline.encode_color(noise, cfg)
    launches = dict(_build.LAUNCHES)
    check(launches["merge_mcu"] == 3 and launches["stream_concat"] == 1
          and launches["stream_concat_chunked"] == 2,
          f"3024 x 4032 4:2:0 Q100 ladder: {launches} for modes {modes}")
    t0 = time.perf_counter()
    check(jpg == color_pipeline.encode_color(noise, cfg, device="cpu"),
          "3024 x 4032 4:2:0 Q100 ladder: card bytes != CPU bytes")
    say("chunked_ladder", path="420_q100_noise", shape=[H, W, 3],
        concat_modes=modes, launches=launches, bytes=len(jpg),
        cpu_path_s=time.perf_counter() - t0)
    return entries


def staged_entropy_phases(dev, say) -> list:
    """jpegtpu's levels -> scan entry point, encode_scan_device, on the
    3024 x 4032 gray levels of the card: the staged branch (fused=False:
    symbolize, fuse, K7) against the fused one (K4), K7 against its plain
    version at caps 8, 16 and 53, a 4:2:0 interleaved scan with a table
    array and no DC differences (the staged branch) against the CPU twin,
    and K7's device time. Returns the kernel entries."""
    cfg = EncodeConfig()
    state = tables.encoder_state(cfg, dev)
    lv = transform.transform(torch.from_numpy(make_image(H, W)).to(dev),
                             state, False)
    zz = lv.T.contiguous()
    nb = zz.shape[0]
    cap = cfg.capacity_words_per_block

    # --- 26. staged against fused, launches -----------------------------
    runs, launches = {}, {}
    for name, fused in (("fused", True), ("staged", False)):
        for k in _build.LAUNCHES:
            _build.LAUNCHES[k] = 0
        runs[name] = device.encode_scan_device(
            zz, capacity_words=nb * cap, stuff=False, fused=fused)
        launches[name] = dict(_build.LAUNCHES)
    check(launches["staged"]["pack_blocks"] == 1
          and launches["staged"]["encode_blocks"] == 0
          and launches["fused"]["encode_blocks"] == 1
          and launches["fused"]["pack_blocks"] == 0,
          f"encode_scan_device: wrong kernels {launches}")
    (ws, ts, os_), (wf, tf, of) = runs["staged"], runs["fused"]
    check(not bool(os_) and not bool(of) and int(ts) == int(tf)
          and torch.equal(ws, wf),
          "encode_scan_device: staged words/total != fused")
    stuffed = device.encode_scan_device(zz, capacity_words=nb * cap,
                                        fused=False)
    scan = pipeline.encode_levels(lv, state.huff, H // 8, W // 8, cfg)
    check(bytes(stuffed[0][:int(stuffed[1])].cpu().numpy()) == scan,
          "encode_scan_device stuffed != the gray encode's scan")
    # stuff=True stays on the card: stuff_bytes_device, plain torch
    stuff_ms = time_ms(lambda: device.stuff_bytes_device(wf, tf))

    # --- 27. K7 against its plain version at caps 8, 16, 53 --------------
    values, lengths = device.symbolize_elements64(zz)
    words_t, bits_t = treepack._fuse_subslots(values, lengths, 3)
    del values, lengths
    k7 = {}
    for c in (8, 16, MAX_WORDS_PER_BLOCK):
        got = pack.pack_blocks(words_t, bits_t, c)
        want = pack.pack_blocks_plain(words_t, bits_t, c)
        check(bool(got[2]) == bool(want[2]),
              f"K7 cap {c}: overflow flags differ")
        k7[f"cap{c}"] = {**equal_streams(f"K7 cap {c}", got[:2], want[:2]),
                         "overflow": bool(got[2])}

    # --- 28. 4:2:0 interleaved scan, table array, no DC differences ------
    side = make_color_image(SIDE_H, SIDE_W)
    cfg_c = EncodeConfig(subsampling="420")
    zc, sel, _ = color_pipeline.color_coefficients(side, cfg_c)
    zc_dev = torch.from_numpy(zc).to(dev)
    for k in _build.LAUNCHES:
        _build.LAUNCHES[k] = 0
    got = device.encode_scan_device(zc_dev, table_sel=sel,
                                    capacity_words=zc.shape[0] * cap)
    interleaved = dict(_build.LAUNCHES)
    want = device.encode_scan_device(torch.from_numpy(zc), table_sel=sel,
                                     capacity_words=zc.shape[0] * cap)
    check(interleaved["pack_blocks"] == 1
          and interleaved["encode_blocks"] == 0,
          f"4:2:0 interleaved scan: not the staged branch: {interleaved}")
    check(not bool(got[2]) and int(got[1]) == int(want[1])
          and torch.equal(got[0].cpu(), want[0]),
          "4:2:0 interleaved staged scan: card bytes != CPU twin's")
    say("staged_entropy", shape=[H, W], blocks=nb, cap=cap,
        total_bits=int(tf), launches=launches, k7_vs_plain=k7,
        stuff_bytes_device_ms=stuff_ms, stream_words=int(wf.shape[0]),
        interleaved_420={"shape": [SIDE_H, SIDE_W, 3], "slots": int(
            zc.shape[0]), "nbytes": int(got[1]), "launches": interleaved})

    # --- 29. K7 device time and bound, cap 8 ----------------------------
    # bytes the function needs: every element's bit count, the words that
    # hold a non-empty element's bits (the kernel reads no others), and
    # the [cap, nb] words + [nb] bits out
    elem_words = int(((bits_t.to(torch.int64) + 31) // 32).sum())
    spec = ("pack_blocks", "jpegtpu_torch/csrc/pack.cu",
            "jpegtpu/entropy/pallas_pack.py:948",
            lambda: pack.pack_blocks(words_t, bits_t, cap),
            lambda: pack.pack_blocks_plain(words_t, bits_t, cap),
            64 * nb * 4 + 4 * elem_words + cap * nb * 4 + nb * 4,
            64 * nb * 10)
    return time_kernels([spec], launches["staged"],
                        {"pack_blocks": k7[f"cap{cap}"]}, "staged_gray",
                        [H, W], say)


def repaired_config_phases(dev, say) -> None:
    """Configs the port once refused or could not run on the card, at
    3024 x 4032: a first rung past K8's shared memory (4:2:0 at 76 words a
    block, gray at 453), which runs the kernels at 53 words; dct_dtype
    float64 and float16; stuff="device" at jpegtpu's four single-segment
    sites, stuffed on the card, and on a restart encode, which ignores
    it. Every encode against the same image's bytes at the default."""
    gray, rgb = make_image(H, W), make_color_image(H, W)
    out = {}
    for name, img, kw in (
        ("420_cap76", rgb, {"subsampling": "420",
                            "capacity_words_per_block": 76}),
        ("gray_cap453", gray, {"capacity_words_per_block": 453}),
        ("420_float64", rgb, {"subsampling": "420", "dct_dtype": "float64"}),
        ("gray_float16", gray, {"dct_dtype": "float16"}),
    ):
        encode = (color_pipeline.encode_color if img.ndim == 3
                  else pipeline.encode_grayscale)
        base = {k: v for k, v in kw.items() if k == "subsampling"}
        got = encode(img, EncodeConfig(**kw))
        check(got == encode(img, EncodeConfig(**base)),
              f"{name}: bytes != the default config's")
        out[name] = len(got)
    stuffed = []
    orig = pipeline.stuff_bytes_device
    pipeline.stuff_bytes_device = lambda *a: stuffed.append(1) or orig(*a)
    try:
        for name, img, kw, on_card in (
            ("gray", gray, {}, True),
            ("gray_two_pass", gray, {"optimize_huffman": True}, True),
            ("420", rgb, {"subsampling": "420"}, True),
            ("420_two_pass", rgb, {"subsampling": "420",
                                   "optimize_huffman": True}, True),
            ("gray_restart_504", gray, {"restart_interval": 504}, False),
        ):
            encode = (color_pipeline.encode_color if img.ndim == 3
                      else pipeline.encode_grayscale)
            before = len(stuffed)
            got = encode(img, EncodeConfig(stuff="device", **kw))
            check((len(stuffed) > before) == on_card,
                  f"stuff=device {name}: stuffed on the card "
                  f"{len(stuffed) - before} times")
            check(got == encode(img, EncodeConfig(**kw)),
                  f"stuff=device {name}: bytes != host stuffing")
            out[f"stuff_device_{name}"] = len(got)
    finally:
        pipeline.stuff_bytes_device = orig
    say("repaired_configs", shape=[H, W], bytes=out)


def batch_k6_phases(dev, say) -> list:
    """jpegtpu's non-raw color batch route at full width: 16 images of
    3024 x 4032 at 4:2:0 (jpegtpu buckets batches to powers of two; 195
    MPix, the scale of its 1024 x 512 x 512 batch row), past the raw
    body's row budget at every rung, so the MCU merge is K6 on slot-major
    streams. K6 against its plain version and K5 on the phase's streams,
    end to end through encode_color_batch (K6 launched, K5 not) with
    every file held against its single-image encode (which merges with
    K5), an int32 2-image batch against the CPU path, MPix/s and a stage
    breakdown; a 64 x 512 x 512 batch at rung 16, which jpegtpu also
    merges with K6; and K8's, K6's and K11's device times. Returns the
    kernel entries."""
    n, h, w, cap = K6_N, H, W, 8
    cfg = EncodeConfig(subsampling="420")
    nmch, nmcw = h // 16, w // 16
    m = n * nmch * nmcw
    check(not batch.color_raw_ok(h, w, "420", 8)
          and not batch.color_raw_ok(h, w, "420", 16),
          "batch_k6: 3024 x 4032 4:2:0 takes jpegtpu's raw route")
    t0 = time.perf_counter()
    arr = batch_images(n, h, w, True, seed=42)
    images = list(arr)
    say("batch_k6_images", shape=[n, h, w, 3],
        seconds=time.perf_counter() - t0)

    # --- 30. K6 against its plain version and K5, the phase's streams ---
    state = tables.encoder_state(cfg, dev)
    rgb = torch.from_numpy(arr).to(dev).reshape(n * h, w, 3)
    ly = transform.transform_rgb_y(rgb, state, False)
    lc = transform.transform_rgb_chroma(rgb, state, False, "420")
    del rgb
    dcd = color_pipeline.color_dc_differences(ly, lc, n * nmch, nmcw, "420",
                                              nmch * nmcw)
    wy, by = pack.encode_blocks(ly, dcd[0], state.huff, cap)
    wc, bc = pack.encode_blocks(lc, dcd[1], state.huff_chroma, cap)
    del ly, lc, dcd
    check(int(torch.cat([by, bc]).max()) <= cap * 32,
          "batch_k6: the batch overflowed cap 8")
    sw, sb = merge.slot_major_streams(wy, by, wc, bc, n * nmch, nmcw, "420")
    got = merge.merge_streams(sw, sb)
    results = {"merge_streams": equal_streams(
        "K6 batch_k6", got, merge.merge_streams_plain(sw, sb))}
    check(all(torch.equal(a, b) for a, b in zip(
        got, merge.merge_mcu(wy, by, wc, bc, n * nmch, nmcw, "420"))),
        "batch_k6: K6 != K5 on the same streams")
    del wy, by, wc, bc
    # K8 (ws 128) and K11 on the route's row segments, both pads
    ws6 = batch.segment_width(nmcw)
    segs6, sb6 = concat.merge_rows(*got, n * nmch, nmcw, ws6)
    results["merge_rows"] = equal_streams(
        "K8 batch_k6", (segs6, sb6),
        concat.merge_rows_plain(*got, n * nmch, nmcw, ws6))
    k11_args = (segs6, sb6, segs6.shape[0] // n,
                got[0].shape[0] * nmch * nmcw, True)
    for pad_ones in (False, True):
        args = k11_args[:4] + (pad_ones,)
        results["stream_concat_rows"] = equal_streams(
            f"K11 batch_k6 pad_ones {pad_ones}",
            concat.stream_concat_rows(*args),
            concat.stream_concat_rows_plain(*args))
    say("batch_k6_kernels_vs_plain", shape=[n, h, w, 3], mcus=m,
        slot_major=list(sw.shape), k6_equals_k5=True,
        segments=list(segs6.shape), **results)

    # --- 31. end to end through encode_color_batch -----------------------
    for k in _build.LAUNCHES:
        _build.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    files = batch.encode_color_batch(images, cfg)
    first_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    check(all(launches[k] > 0 for k in (
        "transform_rgb_y", "transform_rgb_chroma", "encode_blocks",
        "merge_streams", "merge_rows", "stream_concat_rows")),
        f"batch_k6 skipped a kernel: {launches}")
    check(launches["merge_streams"] == 1 and launches["merge_mcu"] == 0,
          f"batch_k6: K6 / K5 launches {launches}")
    for i, im in enumerate(images):
        check(files[i] == color_pipeline.encode_color(im, cfg),
              f"batch_k6: file {i} != its single-image encode")
    e2e_s = []
    for _ in range(5):
        t0 = time.perf_counter()
        batch.encode_color_batch(images, cfg)
        e2e_s.append(time.perf_counter() - t0)
    e2e_med = float(np.median(e2e_s))
    say("batch_k6_end_to_end", shape=[n, h, w, 3], quality=cfg.quality,
        bytes=sum(map(len, files)), first_call_s=first_s, median_s=e2e_med,
        runs_s=e2e_s, mpix_per_s=n * h * w / 1e6 / e2e_med,
        launches=launches, files_equal_single_image=n)
    say("batch_k6_spans", shape=[n, h, w, 3],
        **traced_call(lambda: batch.encode_color_batch(images, cfg)))
    cfg_int = dataclasses.replace(cfg, dct_dtype="int32")
    t0 = time.perf_counter()
    check(batch.encode_color_batch(images[:2], cfg_int)
          == batch.encode_color_batch(images[:2], cfg_int, device="cpu"),
          "batch_k6 int32: card bytes != CPU batch path")
    say("batch_k6_int32_vs_cpu", shape=[2, h, w, 3],
        seconds=time.perf_counter() - t0)
    del files, images, arr

    # --- 32. rung 16: K6 for a shape jpegtpu merges with K5 at rung 8 ----
    small = list(batch_images(K6_RUNG16_N, BATCH_H, BATCH_W, True, seed=43))
    check(batch.color_raw_ok(BATCH_H, BATCH_W, "420", 8),
          "batch_k6: 512 x 512 4:2:0 left jpegtpu's raw route at rung 8")
    runs = {}
    for c in (8, 16):
        before = dict(_build.LAUNCHES)
        got_c = batch.encode_color_batch(
            small, dataclasses.replace(cfg, capacity_words_per_block=c))
        runs[c] = (got_c, {k: _build.LAUNCHES[k] - before[k]
                           for k in ("merge_streams", "merge_mcu")})
    check(runs[16][1] == {"merge_streams": 1, "merge_mcu": 0}
          and runs[8][1] == {"merge_streams": 0, "merge_mcu": 1},
          f"batch_k6 rung 16: launches {runs[8][1]} / {runs[16][1]}")
    check(runs[16][0] == runs[8][0], "batch_k6: rung 16 bytes != rung 8")
    say("batch_k6_rung16", shape=[K6_RUNG16_N, BATCH_H, BATCH_W, 3],
        launches_cap8=runs[8][1], launches_cap16=runs[16][1],
        bytes=sum(map(len, runs[16][0])))
    del small, runs

    # --- 33. K6 device time and bound -----------------------------------
    e = sw.shape[0]
    valid_words = int(((sb.long().clamp(max=cap * 32) + 31) // 32).sum())
    valid_seg_words = int(((sb6.long() + 31) // 32).sum())
    valid_mcu_words = int(((got[1].long() + 31) // 32).sum())
    specs_t = [
        ("merge_rows", "jpegtpu_torch/csrc/concat.cu",
         "jpegtpu/entropy/pallas_concat.py:240",
         lambda: concat.merge_rows(*got, n * nmch, nmcw, ws6),
         lambda: concat.merge_rows_plain(*got, n * nmch, nmcw, ws6),
         valid_mcu_words * 4 + m * 4 + segs6.numel() * 4 + sb6.numel() * 4,
         valid_mcu_words * 2),
        ("merge_streams", "jpegtpu_torch/csrc/merge.cu",
         "jpegtpu/entropy/pallas_pack.py:683",
         lambda: merge.merge_streams(sw, sb),
         lambda: merge.merge_streams_plain(sw, sb),
         valid_words * 4 + e * m * 4 + e * cap * m * 4 + m * 4,
         valid_words * 2),
        ("stream_concat_rows", "jpegtpu_torch/csrc/concat.cu",
         "jpegtpu/entropy/pallas_concat.py:412",
         lambda: concat.stream_concat_rows(*k11_args),
         lambda: concat.stream_concat_rows_plain(*k11_args),
         valid_seg_words * 4 + sb6.numel() * 4 + n * k11_args[3] * 4 + n * 8,
         valid_seg_words * 2),
    ]
    entries = time_kernels(specs_t, launches, results, "batch_k6",
                           [n, h, w, 3], say)
    del sw, sb, segs6, sb6, k11_args, got
    torch.cuda.empty_cache()
    return entries


SERVE_N = 16  # distinct 3024 x 4032 images of each serving stream
SHARDS = 4  # shards of the single-process sharded encodes, one card
MESH_N = 2  # devices of the batch mesh (the card twice)
WORKER_TIMEOUT_S = 600


def strip_sof(data: bytes) -> bytes:
    """A JFIF file without its SOF0 segment (frame dims), to hold a sharded
    file against a single-image encode of the shard-padded image."""
    i = data.index(b"\xff\xc0")
    return data[:i] + data[i + 2 + int.from_bytes(data[i + 2:i + 4], "big"):]


def chain_entries(path: str, x: torch.Tensor, cfg, launches: dict, say, *,
                  join: str, seg_len: int = 0, rows=None, k6: bool = False,
                  huffs=None) -> list:
    """One unit of a path (an image, a shard's band, a batch share) through
    the path's kernel chain on the card, each kernel against its plain
    version on the same inputs, then timed beside its bound: K1 (gray) or
    K2 + K3 (4:2:0); DC chains reset every seg_len blocks (MCUs); K4
    (runtime tables `huffs` in 2-pass); K5, or the slot-major gather + K6
    (k6); then the join: "k9" (K8 + K9 and the tail pad), "k12" (the
    restart stitch at seg_len) or "k11" (K8 at the rows' segment width +
    K11; rows = (grid rows, grid cols, images)). launches: the path's run.
    Returns the kernel entries."""
    color = cfg.n_components == 3
    cap = cfg.capacity_words_per_block
    state = tables.encoder_state(cfg, x.device)
    if huffs is not None:
        state = state._replace(huff=huffs[0], huff_chroma=huffs[-1])
    h, w = x.shape[:2]
    tab = 3 * 64 * 4  # quant + both bases
    results, specs = {}, []
    if color:
        nbh, nbw = h // 16, w // 16
        n = nbh * nbw
        ny, nc = 4 * n, 2 * n
        ly = transform.transform_rgb_y(x, state, False)
        results["transform_rgb_y"] = float_close(
            f"K2 {path}", ly, transform.transform_rgb_y_plain(x, state, False))
        lc = transform.transform_rgb_chroma(x, state, False, "420")
        results["transform_rgb_chroma"] = float_close(
            f"K3 {path}", lc,
            transform.transform_rgb_chroma_plain(x, state, False, "420"))
        specs += [
            ("transform_rgb_y", "jpegtpu_torch/csrc/transform.cu",
             "jpegtpu/ops/pallas_transform.py:464",
             lambda: transform.transform_rgb_y(x, state, False),
             lambda: transform.transform_rgb_y_plain(x, state, False),
             h * w * 3 + 64 * ny * 4 + tab, ny * 2 * 1024),
            ("transform_rgb_chroma", "jpegtpu_torch/csrc/transform.cu",
             "jpegtpu/ops/pallas_transform.py:505",
             lambda: transform.transform_rgb_chroma(x, state, False, "420"),
             lambda: transform.transform_rgb_chroma_plain(x, state, False,
                                                          "420"),
             h * w * 3 + 64 * nc * 4 + tab, nc * 2 * 1024)]
        dcd = color_pipeline.color_dc_differences(ly, lc, nbh, nbw, "420",
                                                  seg_len)
        pairs = [(ly, dcd[0], state.huff), (lc, dcd[1], state.huff_chroma)]
    else:
        nbh, nbw = h // 8, w // 8
        n = nbh * nbw
        lv = transform.transform(x, state, False)
        results["transform"] = float_close(
            f"K1 {path}", lv, transform.transform_plain(x, state, False))
        specs.append(("transform", "jpegtpu_torch/csrc/transform.cu",
                      "jpegtpu/ops/pallas_transform.py:255",
                      lambda: transform.transform(x, state, False),
                      lambda: transform.transform_plain(x, state, False),
                      h * w + 64 * n * 4 + tab, n * 2 * 1024))
        pairs = [(lv, dc_differences(lv[0], seg_len), state.huff)]
    blocks = [pack.encode_blocks(lev, d, t, cap) for lev, d, t in pairs]
    for (lev, d, t), got in zip(pairs, blocks):
        results["encode_blocks"] = equal_streams(
            f"K4 {path}", got, pack.encode_blocks_plain(lev, d, t, cap))
    nbk = sum(lev.shape[1] for lev, _, _ in pairs)
    check(int(torch.cat([b for _, b in blocks]).max()) <= cap * 32,
          f"{path}: overflowed cap {cap}")
    specs.append((
        "encode_blocks", "jpegtpu_torch/csrc/pack.cu",
        "jpegtpu/entropy/pallas_pack.py:"
        + ("237" if huffs is not None else "560"),
        lambda: [pack.encode_blocks(lev, d, t, cap) for lev, d, t in pairs],
        lambda: [pack.encode_blocks_plain(lev, d, t, cap)
                 for lev, d, t in pairs],
        64 * nbk * 4 + nbk * 4 + len(pairs) * tables.HUFF_SIZE * 4
        + cap * nbk * 4 + nbk * 4, 64 * nbk))
    if not color:
        words, bits = blocks[0]
    elif k6:
        (wy, by), (wc, bc) = blocks
        sw, sb = merge.slot_major_streams(wy, by, wc, bc, nbh, nbw, "420")
        words, bits = merge.merge_streams(sw, sb)
        results["merge_streams"] = equal_streams(
            f"K6 {path}", (words, bits), merge.merge_streams_plain(sw, sb))
        e = sw.shape[0]
        valid = int(((sb.long().clamp(max=cap * 32) + 31) // 32).sum())
        specs.append(("merge_streams", "jpegtpu_torch/csrc/merge.cu",
                      "jpegtpu/entropy/pallas_pack.py:683",
                      lambda: merge.merge_streams(sw, sb),
                      lambda: merge.merge_streams_plain(sw, sb),
                      valid * 4 + e * n * 4 + e * cap * n * 4 + n * 4,
                      valid * 2))
    else:
        (wy, by), (wc, bc) = blocks
        results["merge_mcu"], k5_spec = k5_check_and_spec(
            f"K5 {path}", wy, by, wc, bc, nbh, nbw)
        specs.append(k5_spec)
        words, bits = merge.merge_mcu(wy, by, wc, bc, nbh, nbw, "420")
    c = words.shape[0]
    valid_words = int(((bits.long() + 31) // 32).sum())
    if join == "k12":
        got = stitch.stitch_segments(words, bits, seg_len, cfg.pad_ones)
        results["stitch_segments"] = equal_streams(
            f"K12 {path}", (got[0], got[1], got[2].reshape(1)),
            [t.reshape(-1) for t in stitch.stitch_segments_plain(
                words, bits, seg_len, cfg.pad_ones)])
        inputs = valid_words * 4 + bits.numel() * 4 + got[1].numel() * 4
        specs.append(("stitch_segments", "jpegtpu_torch/csrc/stitch.cu",
                      "jpegtpu/entropy/pallas_concat.py:553",
                      lambda: stitch.stitch_segments(words, bits, seg_len,
                                                     cfg.pad_ones),
                      lambda: stitch.stitch_segments_plain(
                          words, bits, seg_len, cfg.pad_ones),
                      inputs + (int(got[2]) + 31) // 32 * 4,
                      valid_words * 2,
                      {"launches_scan": launches["stitch_scan"]}))
    else:
        r, cols, n_images = (nbh, nbw, 1) if join == "k9" else rows
        ws = 128 if join == "k9" else concat.segment_width(cols)
        segs, sbits = concat.merge_rows(words, bits, r, cols, ws)
        results["merge_rows"] = equal_streams(
            f"K8 {path}", (segs, sbits),
            concat.merge_rows_plain(words, bits, r, cols, ws))
        nseg, seg_words = segs.shape
        specs.append(("merge_rows", "jpegtpu_torch/csrc/concat.cu",
                      "jpegtpu/entropy/pallas_concat.py:240",
                      lambda: concat.merge_rows(words, bits, r, cols, ws),
                      lambda: concat.merge_rows_plain(words, bits, r, cols,
                                                      ws),
                      valid_words * 4 + n * 4 + nseg * seg_words * 4
                      + nseg * 4, valid_words * 2))
        if join == "k9":
            results["stream_concat"], k9_spec = k9_check_and_spec(
                f"K9 {path}", segs, sbits, concat.stream_words(n, c),
                cfg.pad_ones)
            specs.append(k9_spec)
        else:
            args = (segs, sbits, nseg // n_images, n // n_images * c,
                    cfg.pad_ones)
            results["stream_concat_rows"] = equal_streams(
                f"K11 {path}", concat.stream_concat_rows(*args),
                concat.stream_concat_rows_plain(*args))
            valid_seg = int(((sbits.long() + 31) // 32).sum())
            specs.append(("stream_concat_rows", "jpegtpu_torch/csrc/concat.cu",
                          "jpegtpu/entropy/pallas_concat.py:412",
                          lambda: concat.stream_concat_rows(*args),
                          lambda: concat.stream_concat_rows_plain(*args),
                          valid_seg * 4 + nseg * 4 + n * c * 4
                          + n_images * 8, valid_seg * 2))
    say(f"{path}_kernels_vs_plain", shape=list(x.shape), **results)
    return time_kernels(specs, launches, results, path, list(x.shape), say)


def reset_launches() -> None:
    for k in _build.LAUNCHES:
        _build.LAUNCHES[k] = 0


def traced_call(fn) -> dict:
    """One call of an entry point under tracing.recording(): its wall
    seconds and the program's spans and counters (tracing.totals()), in
    milliseconds."""
    torch.cuda.synchronize()
    with tracing.recording():
        t0 = time.perf_counter()
        fn()
        wall = time.perf_counter() - t0
    t = tracing.totals()
    return {"wall_s": wall, "root_ms": t["root_ns"] / 1e6,
            "counts": t["counts"],
            "self_ms": {k: v["self_ns"] / 1e6 for k, v in t["spans"].items()},
            "calls": {k: v["calls"] for k, v in t["spans"].items()}}


def serving_phases(dev, say) -> list:
    """encode_stream (M6) on streams of SERVE_N distinct 3024 x 4032
    images, gray and 4:2:0: submit queues no host sync (torch's sync
    debug mode set to error around it), every file equal to its
    single-image encode at depths 1, 2 and 3, MPix/s and wall ms of each
    depth in turns, the card's busy share at each depth (torch.profiler),
    an overflowing image's fallback and the history it leaves, and the
    path's kernels against their plain versions and timed. Returns the
    kernel entries."""
    from jpegtpu_torch import serving
    entries = []
    for kind, color in (("gray", False), ("420", True)):
        cfg = EncodeConfig(subsampling="420") if color else EncodeConfig()
        path = f"serving_{kind}"
        images = list(batch_images(SERVE_N, H, W, color, seed=50 + color))
        enc = (color_pipeline.encode_color if color
               else pipeline.encode_grayscale)
        singles = [enc(im, cfg) for im in images]
        # no host sync inside submit
        server = serving._Server(cfg, color, 2, dev)
        torch.cuda.set_sync_debug_mode("error")
        try:
            pends = [server.submit(im) for im in images[:2]]
        finally:
            torch.cuda.set_sync_debug_mode("default")
        check([server.finish(p, im) for p, im in zip(pends, images)]
              == singles[:2], f"{path}: submit / finish bytes != single")
        walls = {1: [], 2: [], 3: []}
        launches = None
        for rep in range(3):
            for depth in (1, 2, 3):
                reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                files = serving.encode_stream_list(images, cfg, color=color,
                                                   depth=depth)
                walls[depth].append(time.perf_counter() - t0)
                check(files == singles,
                      f"{path} depth {depth}: a file != its single encode")
                if depth == 2 and rep == 0:
                    launches = dict(_build.LAUNCHES)
        mpix = SERVE_N * H * W / 1e6
        say(f"{path}_end_to_end", shape=[SERVE_N, H, W] + ([3] if color
                                                            else []),
            files_equal_single_image=SERVE_N, launches_depth2=launches,
            **{f"depth{d}": {"wall_ms": [s * 1e3 for s in v],
                             "median_ms": float(np.median(v)) * 1e3,
                             "mpix_per_s": mpix / float(np.median(v))}
               for d, v in walls.items()})
        for depth in (1, 2):
            say(f"{path}_spans", depth=depth, **traced_call(
                lambda d=depth: serving.encode_stream_list(
                    images, cfg, color=color, depth=d)))
        # a Q100 noise image past rung 8 in a stream: the blocking ladder
        # for it, then its site's next submission at the rung that fit
        cfg100 = dataclasses.replace(cfg, quality=100)
        shape = (LADDER_H, LADDER_W) + ((3,) if color else ())
        noise = [np.random.default_rng(s).integers(0, 256, shape,
                                                   dtype=np.uint8)
                 for s in (60, 61)]
        flat = np.full(shape, 90, np.uint8)
        key = ((LADDER_H, LADDER_W, cfg100, "color") if color
               else (LADDER_H // 8, LADDER_W // 8, cfg100, False))
        pipeline._cap_history.pop(key, None)
        mixed = [flat, noise[0], flat, noise[1]]
        got = serving.encode_stream_list(mixed, cfg100, color=color,
                                         depth=1)
        fit = pipeline._cap_history.get(key, [0])[0]
        check(got == [enc(im, cfg100) for im in mixed] and fit > 8,
              f"{path}: overflow fallback (rung {fit})")
        say(f"{path}_overflow_fallback", shape=list(shape), quality=100,
            rung_learned=fit)
        entries += chain_entries(
            path, torch.from_numpy(images[0]).to(dev), cfg, launches, say,
            join="k9")
        del images, singles
    return entries


def sharded_phases(dev, say) -> list:
    """encode_grayscale_sharded / encode_color_sharded (M7) at 3024 x 4032
    on SHARDS shards of the one card, 1- and 2-pass: the stitched route
    (K12 per shard) launched, the file equal to the single-image restart
    encode of the shard-padded image on the card (frame dims aside), int32
    files equal to the port's CPU path, end-to-end ms, and the first
    shard's kernels against their plain versions and timed. Returns the
    kernel entries."""
    from jpegtpu_torch.parallel import sharding
    mesh = sharding.make_mesh(SHARDS, devices=[dev] * SHARDS)
    entries = []
    for kind, color in (("gray", False), ("420", True)):
        img = make_color_image(H, W) if color else make_image(H, W)
        enc = (color_pipeline.encode_color_sharded if color
               else sharding.encode_grayscale_sharded)
        single = (color_pipeline.encode_color if color
                  else pipeline.encode_grayscale)
        mh = 16 if color else 8
        ph = -(-H // (mh * SHARDS)) * mh * SHARDS
        rows, cols = ph // SHARDS // mh, W // mh
        seg = sharding.restart_subsegments(rows, cols)
        padded = np.pad(img, [(0, ph - H), (0, 0)] + [(0, 0)] * color,
                        mode="edge")
        for two_pass in (False, True):
            cfg = EncodeConfig(subsampling="420" if color else "gray",
                               optimize_huffman=two_pass)
            path = f"sharded_{kind}" + ("_2pass" if two_pass else "")
            enc(img, cfg, mesh=mesh)
            reset_launches()
            t0 = time.perf_counter()
            data = enc(img, cfg, mesh=mesh)
            first_s = time.perf_counter() - t0
            launches = dict(_build.LAUNCHES)
            r = launches["stitch_segments"] // SHARDS  # rungs climbed
            fronts = (("transform_rgb_y", "transform_rgb_chroma") if color
                      else ("transform",))
            check(r >= 1 and all(launches[k] == SHARDS for k in fronts)
                  and launches["stitch_scan"] == SHARDS * r
                  and launches["stitch_segments"] == SHARDS * r
                  and launches["encode_blocks"] == SHARDS * r * (1 + color)
                  and launches["merge_mcu"] == SHARDS * r * color
                  and launches["merge_rows"] == 0
                  and launches["stream_concat_rows"] == 0,
                  f"{path}: launches {launches}")
            restart = dataclasses.replace(cfg, restart_interval=seg)
            check(strip_sof(data) == strip_sof(single(padded, restart)),
                  f"{path}: != the single-image restart encode")
            runs = []
            for _ in range(5):
                t0 = time.perf_counter()
                enc(img, cfg, mesh=mesh)
                runs.append(time.perf_counter() - t0)
            cfg_int = dataclasses.replace(cfg, dct_dtype="int32")
            t0 = time.perf_counter()
            check(enc(img, cfg_int, mesh=mesh)
                  == enc(img, cfg_int, mesh=["cpu"] * SHARDS),
                  f"{path} int32: card bytes != CPU path")
            cpu_s = time.perf_counter() - t0
            say(f"{path}_end_to_end", shape=list(img.shape), shards=SHARDS,
                restart_interval=seg, bytes=len(data), first_call_s=first_s,
                runs_s=runs, median_s=float(np.median(runs)),
                mpix_per_s=H * W / 1e6 / float(np.median(runs)),
                launches=launches, int32_vs_cpu_s=cpu_s)
            huffs = None
            if two_pass:  # the sharded encode's tables, from all shards
                counts = 0
                for i in range(SHARDS):
                    x = sharding.band(img, i, SHARDS, ph, W, dev)
                    st = tables.encoder_state(cfg, dev)
                    if color:
                        ly = transform.transform_rgb_y(x, st, False)
                        lc = transform.transform_rgb_chroma(x, st, False,
                                                            "420")
                        d = color_pipeline.color_dc_differences(
                            ly, lc, rows, cols, "420", seg)
                        counts = counts + symbol_histograms(ly, d[0], 0) \
                            + symbol_histograms(lc, d[1], 1)
                    else:
                        lv = transform.transform(x, st, False)
                        counts = counts + symbol_histograms(
                            lv, dc_differences(lv[0], seg))
                kinds = ("lum", "chrom") if color else ("lum",)
                _, huffs = pipeline.optimal_tables(counts, kinds, dev)
            entries += chain_entries(
                path, sharding.band(img, 0, SHARDS, ph, W, dev), cfg, launches,
                say, join="k12", seg_len=seg, huffs=huffs)
    return entries


def multiprocess_worker(port: str, rank: int, out_dir: str) -> int:
    """One of multiprocess_phases' two processes: joins the gloo group,
    encodes 3024 x 4032 gray and 4:2:0 on one shard a process (its
    shard's kernels on this card), times it, writes the files, and prints
    its launches (rank 0 also its shard's kernel entries) as JSON."""
    from jpegtpu_torch.parallel import multihost, sharding
    dev = torch.device("cuda:0")
    multihost.initialize(f"tcp://localhost:{port}", world_size=2, rank=rank,
                         timeout_s=WORKER_TIMEOUT_S)
    mesh = multihost.global_mesh([dev])
    lines = []
    for kind, color in (("gray", False), ("420", True)):
        img = make_color_image(H, W) if color else make_image(H, W)
        enc = (color_pipeline.encode_color_sharded if color
               else sharding.encode_grayscale_sharded)
        cfg = EncodeConfig(subsampling="420") if color else EncodeConfig()
        enc(img, cfg, mesh=mesh)
        torch.distributed.barrier()
        reset_launches()
        data = enc(img, cfg, mesh=mesh)
        launches = dict(_build.LAUNCHES)
        runs = []
        for _ in range(3):
            torch.distributed.barrier()
            t0 = time.perf_counter()
            enc(img, cfg, mesh=mesh)
            runs.append(time.perf_counter() - t0)
        with open(os.path.join(out_dir, f"{kind}.p{rank}"), "wb") as f:
            f.write(data)
        entries = []
        if rank == 0:
            mh = 16 if color else 8
            ph = -(-H // (mh * 2)) * mh * 2
            rows, cols = ph // 2 // mh, W // mh
            seg = sharding.restart_subsegments(rows, cols)
            k = rows * cols // seg
            entries = chain_entries(
                f"multiprocess_{kind}",
                sharding.band(img, 0, 2, ph, W, dev), cfg,
                launches, lambda *a, **kv: None, join="k11", seg_len=seg,
                rows=(k, seg, k), k6=color and k == 1)
        lines.append({"kind": kind, "rank": rank, "launches": launches,
                      "runs_s": runs, "median_s": float(np.median(runs)),
                      "entries": entries})
    print("WORKER " + json.dumps(lines), flush=True)
    torch.distributed.destroy_process_group()
    return 0


def multiprocess_phases(dev, say) -> list:
    """Two processes on the card (parallel.multihost over gloo, one shard
    each, jpegtpu's per-segment route): both must exit 0 within
    WORKER_TIMEOUT_S, and each file of each process must equal the
    single-process sharded encode on a mesh of two. Reports each
    process's launches (K6 for 4:2:0) and end-to-end ms; rank 0's shard
    gives the kernel entries. Returns them."""
    import socket
    import tempfile
    from jpegtpu_torch.parallel import sharding
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = str(s.getsockname()[1])
    out_dir = tempfile.mkdtemp(dir=os.path.dirname(os.path.abspath(
        __file__)), prefix=".multiprocess_")
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "RANK", "WORLD_SIZE")}
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", port,
         str(r), out_dir], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env) for r in (0, 1)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        check(p.returncode == 0 and "WORKER " in log,
              f"multiprocess worker {r} failed (rc {p.returncode}):\n"
              f"{log[-3000:]}")
    reports = [json.loads(next(ln for ln in log.splitlines()
                               if ln.startswith("WORKER "))[7:])
               for log in logs]
    mesh = sharding.make_mesh(2, devices=[dev] * 2)
    entries = []
    for kind, color in (("gray", False), ("420", True)):
        img = make_color_image(H, W) if color else make_image(H, W)
        enc = (color_pipeline.encode_color_sharded if color
               else sharding.encode_grayscale_sharded)
        cfg = EncodeConfig(subsampling="420") if color else EncodeConfig()
        want = enc(img, cfg, mesh=mesh)
        for r in (0, 1):
            with open(os.path.join(out_dir, f"{kind}.p{r}"), "rb") as f:
                check(f.read() == want,
                      f"multiprocess {kind}: rank {r} != one process")
        rep = [next(x for x in reports[r] if x["kind"] == kind)
               for r in (0, 1)]
        for r in (0, 1):
            lc = rep[r]["launches"]
            check(lc["encode_blocks"] == 1 + color
                  and lc["merge_rows"] == 1 and lc["stream_concat_rows"] == 1
                  and lc["merge_streams"] == int(color)
                  and lc["stitch_segments"] == 0,
                  f"multiprocess {kind} rank {r}: launches {lc}")
        say(f"multiprocess_{kind}_end_to_end", shape=list(img.shape),
            processes=2, files_equal_one_process=True,
            launches=[x["launches"] for x in rep],
            median_s=[x["median_s"] for x in rep],
            runs_s=[x["runs_s"] for x in rep])
        for e in rep[0]["entries"]:
            say("kernel_time", **e)
        entries += rep[0]["entries"]
    shutil.rmtree(out_dir, ignore_errors=True)
    return entries


def batch_mesh_phases(dev, say) -> list:
    """encode_grayscale_batch with a mesh of MESH_N (the card twice) on
    1024 x 512 x 512 gray, 1- and 2-pass: every file equal to the batch
    without a mesh, one launch of each kernel a share, end-to-end ms; the
    first share's kernels against their plain versions and timed. Returns
    the kernel entries."""
    images = list(batch_images(BATCH_N, BATCH_H, BATCH_W, False, seed=42))
    mesh = [dev] * MESH_N
    entries = []
    for two_pass in (False, True):
        cfg = EncodeConfig(optimize_huffman=two_pass)
        path = "batch_mesh_gray" + ("_2pass" if two_pass else "")
        want = batch.encode_grayscale_batch(images, cfg)
        reset_launches()
        t0 = time.perf_counter()
        files = batch.encode_grayscale_batch(images, cfg, mesh=mesh)
        first_s = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        check(files == want, f"{path}: files != the batch without a mesh")
        check(all(launches[k] == MESH_N for k in (
            "transform", "encode_blocks", "merge_rows",
            "stream_concat_rows")), f"{path}: launches {launches}")
        runs = []
        for _ in range(3):
            t0 = time.perf_counter()
            batch.encode_grayscale_batch(images, cfg, mesh=mesh)
            runs.append(time.perf_counter() - t0)
        say(f"{path}_end_to_end", shape=[BATCH_N, BATCH_H, BATCH_W],
            mesh=MESH_N, files_equal_no_mesh=BATCH_N, first_call_s=first_s,
            runs_s=runs, median_s=float(np.median(runs)),
            mpix_per_s=BATCH_N * BATCH_H * BATCH_W / 1e6
            / float(np.median(runs)), launches=launches)
        share = BATCH_N // MESH_N
        x = torch.from_numpy(np.stack(images[:share])).to(dev).reshape(
            share * BATCH_H, BATCH_W)
        huffs = None
        if two_pass:
            counts = 0
            for lo in range(0, BATCH_N, share):
                xs = torch.from_numpy(np.stack(images[lo:lo + share])).to(
                    dev).reshape(share * BATCH_H, BATCH_W)
                lv = transform.transform(xs, tables.encoder_state(cfg, dev),
                                         False)
                counts = counts + symbol_histograms(
                    lv, dc_differences(lv[0], (BATCH_H // 8) * (BATCH_W // 8)))
            _, huffs = pipeline.optimal_tables(counts, ("lum",), dev)
        entries += chain_entries(
            path, x, cfg, launches, say, join="k11",
            seg_len=(BATCH_H // 8) * (BATCH_W // 8),
            rows=(share * BATCH_H // 8, BATCH_W // 8, share), huffs=huffs)
        del x
    del images
    torch.cuda.empty_cache()
    return entries


def wall_ms(fn, reps: int = 5) -> float:
    """Median host-clock milliseconds of fn() from an idle card to its
    last device work done: launch overhead included, which is what a
    host-bound caller pays."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def on_card_phases(dev, say) -> list:
    """Frames that are already on the card, as a video decoder hands them
    out: VIDEO_N planar [3, 1080, 1920] frames passed as .permute(1, 2, 0)
    views. K13 (ops.stage.stage_images) stacks them at 1088 rows, stacks
    the frames' green planes (gray), and stacks STAGE_MIXED_N cropped RGB
    views and gray planes into three channels (two launches); each stack
    equals stage_images_plain's byte for byte, with one launch a 64
    images (launch counts reset just before). K13 and its twin are timed
    on the frames beside K13's bound (3 bytes a pixel read, 3 written),
    by CUDA events and by the host clock. Then encode_color_batch at the
    video configuration (Q75, 4:2:0) on the views: one K13 launch, its
    span and counter and none of the ring's, no host sync in
    transfer.stage, the files of the numpy route, and both routes' wall
    time; with K13's twin in its place, the same files and the time that
    costs; an int32 batch and encode_color on the views equal to the CPU
    path and the numpy input. Returns K13's kernel entry."""
    frames = batch_images_on_card(VIDEO_N, VIDEO_H, VIDEO_W, True, seed=18)
    planar = frames.permute(0, 3, 1, 2).contiguous()
    del frames
    views = [f.permute(1, 2, 0) for f in planar]
    rgb = (VIDEO_PH, VIDEO_W, 3)
    cases = {
        "rgb_planar": (views, rgb),
        "gray": ([f[1] for f in planar], rgb[:2]),
        "mixed": ([views[i % VIDEO_N][:VIDEO_H - i, :VIDEO_W - 8 * (i % 5)]
                   if i % 2 else planar[i % VIDEO_N, i % 3]
                   for i in range(STAGE_MIXED_N)], rgb),
    }
    results, launches = {}, {}
    for name, (images, shape) in cases.items():
        reset_launches()
        got = stage.stage_images(images, shape)
        launches[name] = _build.LAUNCHES["stage_images"]
        want = stage.stage_images_plain(images, shape)
        err = int((got.int() - want.int()).abs().max())
        check(err == 0 and torch.equal(got, want),
              f"K13 {name}: kernel != plain, max_abs_err {err}")
        check(launches[name] == -(-len(images) // stage.MAX_IMAGES),
              f"K13 {name}: {launches[name]} launches for {len(images)} "
              "images")
        results[name] = {"images": len(images), "stack": list(got.shape),
                         "launches": launches[name], "max_abs_err": err}
        del got, want
    say("on_card_k13_vs_plain", **results)
    pixels = VIDEO_N * VIDEO_H * VIDEO_W
    k13 = lambda: stage.stage_images(views, rgb)  # noqa: E731
    twin = lambda: stage.stage_images_plain(views, rgb)  # noqa: E731
    entries = time_kernels(
        [("stage_images", "jpegtpu_torch/csrc/stage.cu",
          "none: jpegtpu edge-pads on the host (np.pad) before its upload",
          k13, twin, 6 * pixels, 0,
          {"wall_ms": wall_ms(k13), "plain_wall_ms": wall_ms(twin)})],
        {"stage_images": launches["rgb_planar"]},
        {"stage_images": results["rgb_planar"]}, "on_card_video",
        [VIDEO_N, VIDEO_H, VIDEO_W, 3], say)

    cfg = EncodeConfig(quality=75, subsampling="420")
    arrays = [f.cpu().numpy() for f in views]
    want = batch.encode_color_batch(arrays, cfg)
    reset_launches()
    got = batch.encode_color_batch(views, cfg)
    card_launches = dict(_build.LAUNCHES)
    check(got == want, "on-card batch: files != the numpy route's")
    check(card_launches["stage_images"] == 1,
          f"on-card batch: launches {card_launches}")
    traced = traced_call(lambda: batch.encode_color_batch(views, cfg))
    check("io.on_card" in traced["calls"]
          and traced["counts"].get("io.on_card_images") == VIDEO_N
          and not {"io.stack", "io.pad", "io.upload"} & set(traced["calls"]),
          f"on-card batch: spans {traced['calls']}, counts "
          f"{traced['counts']}")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        transfer.stage(views, rgb, dev)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    secs = {}
    for route, images in (("numpy", arrays), ("card", views)):
        secs[route] = wall_ms(lambda: batch.encode_color_batch(images, cfg),
                              reps=3) / 1e3
    try:  # the card route with K13's twin in its place
        transfer.stage_images = stage.stage_images_plain
        check(batch.encode_color_batch(views, cfg) == want,
              "on-card batch with K13's twin: files != the numpy route's")
        secs["card_twin"] = wall_ms(
            lambda: batch.encode_color_batch(views, cfg), reps=3) / 1e3
    finally:
        transfer.stage_images = stage.stage_images
    say("on_card_batch", shape=[VIDEO_N, VIDEO_H, VIDEO_W, 3],
        quality=cfg.quality, files_equal_numpy_route=VIDEO_N,
        bytes=sum(map(len, got)), launches={
            k: v for k, v in card_launches.items() if v},
        spans=traced["calls"], counts=traced["counts"],
        self_ms=traced["self_ms"], median_s=secs,
        mpix_per_s={k: pixels / 1e6 / v for k, v in secs.items()})

    cfg_int = EncodeConfig(quality=75, subsampling="420", dct_dtype="int32")
    few = views[:4]
    check(batch.encode_color_batch(few, cfg_int)
          == batch.encode_color_batch(arrays[:4], cfg_int, device="cpu"),
          "on-card int32 batch: files != the CPU path")
    check(color_pipeline.encode_color(views[1], cfg)
          == color_pipeline.encode_color(arrays[1], cfg),
          "on-card encode_color: file != the numpy input's")
    say("on_card_single_and_int32", int32_batch_equal_cpu=len(few),
        encode_color_equal_numpy=1)
    del views, planar, arrays
    torch.cuda.empty_cache()
    return entries


TOOL_DIR_N = 8  # 512 x 512 BMPs of the encode-dir checks


def reconstruct(zz: np.ndarray, quant: np.ndarray, h: int,
                w: int) -> np.ndarray:
    """A decoder's view of an encode, for the quality metrics: zigzag
    levels [nb, 64] of an h x w plane (blocks in raster order over the
    plane padded to 8) -> dequantized, inverse DCT with the orthonormal
    basis, + 128, rounded and clipped -> uint8 [h, w]."""
    coef = np.empty(zz.shape, np.float64)
    order = tables.ZIGZAG_ORDER
    coef[:, order] = zz * quant.reshape(64)[order]
    t = tables.dct_basis(np.float64)
    x = np.matmul(t.T, np.matmul(coef.reshape(-1, 8, 8), t))
    ph, pw = -(-h // 8) * 8, -(-w // 8) * 8
    plane = x.reshape(ph // 8, pw // 8, 8, 8).transpose(0, 2, 1, 3)
    plane = plane.reshape(ph, pw)[:h, :w]
    return np.clip(np.round(plane + 128), 0, 255).astype(np.uint8)


def tooling_phases(dev, say) -> list:
    """The tooling (M8) at 3024 x 4032, gray and 4:2:0, through
    `jpegtpu_torch.cli.main` as a user runs it: encode (default, --sharded
    and --entropy host), each file equal to the port's CPU path (with
    host entropy, which gives the same bytes for a fraction of the device
    entropy's plain-version time, on a host thread while the card works;
    the sharded file, one shard on the one card, against the CPU encode
    at its restart interval), the launches of each run; encode-dir on TOOL_DIR_N BMPs of 512 x 512, batch and
    --pipeline 2, each file equal to the CPU path; the profile table
    (the CLI's, then profile_encode / profile_encode_color, whose file
    must equal the CPU path), first, with no host thread of the phase
    busy beside it; first_block_report on `dev` equal to the CPU's
    and its zigzag equal to K1's levels of that block; mse, psnr and ssim
    of each image's luma against its reconstruction from K1's levels. The
    CLI encode's kernels against their plain versions and timed. Returns
    the kernel entries."""
    import tempfile

    from jpegtpu_torch import analysis, cli, debug, profiling
    from jpegtpu_torch.io import bmp
    from jpegtpu_torch.ops import color as color_ops
    from jpegtpu_torch.parallel import sharding
    on_card = dev.type == "cuda"
    dev_flags = [] if on_card else ["--device", str(dev)]
    tmp = tempfile.mkdtemp(dir=os.path.dirname(os.path.abspath(__file__)),
                           prefix=".tooling_")
    entries = []

    def run(argv) -> dict:
        reset_launches()
        check(cli.main(argv + dev_flags) == 0, f"cli {argv}: nonzero exit")
        return dict(_build.LAUNCHES)

    def read(path) -> bytes:
        with open(path, "rb") as f:
            return f.read()

    def inputs(kind, color):
        """The phase's images of one kind, written as BMPs."""
        img = make_color_image(H, W) if color else make_image(H, W)
        rgb = img if color else np.repeat(img[..., None], 3, axis=-1)
        small = batch_images(TOOL_DIR_N, 512, 512, color, seed=80 + color)
        if not color:
            small = np.repeat(small[..., None], 3, axis=-1)
        os.makedirs(os.path.join(tmp, f"in_{kind}"))
        bmp.write(os.path.join(tmp, f"{kind}.bmp"), rgb)
        for i, im in enumerate(small):
            bmp.write(os.path.join(tmp, f"in_{kind}", f"im{i}.bmp"), im)
        return img, rgb, small

    def cpu_path(rgb, small, color):
        """The port's CPU files (host entropy): the image, the image at
        the sharded file's restart interval, the encode-dir images."""
        t0 = time.perf_counter()
        cfg = EncodeConfig(subsampling="420" if color else "gray",
                           entropy="host")
        enc = (color_pipeline.encode_color if color
               else pipeline.encode_grayscale)
        mh = 16 if color else 8
        seg = sharding.restart_subsegments(-(-H // mh), -(-W // mh))
        return {"default": enc(rgb, cfg, device="cpu"),
                "sharded": enc(rgb, dataclasses.replace(
                    cfg, restart_interval=seg), device="cpu"),
                "dir": [enc(im, cfg, device="cpu") for im in small],
                "restart_interval": seg, "s": time.perf_counter() - t0}

    from concurrent.futures import ThreadPoolExecutor
    pool = ThreadPoolExecutor(1)  # the CPU files while the card works
    try:
        kinds = (("gray", False), ("420", True))
        made = {kind: inputs(kind, color) for kind, color in kinds}
        # --- profile: the CLI's table, then the rows and the file; first,
        # so that no host thread of this phase is busy beside it ---------
        profs = {}
        for kind, color in kinds:
            img = made[kind][0]
            run(["profile", os.path.join(tmp, f"{kind}.bmp"),
                 "--subsampling", kind])
            cfg = EncodeConfig(subsampling="420") if color else EncodeConfig()
            prof = profs[kind] = (profiling.profile_encode_color if color
                                  else profiling.profile_encode)(
                img, cfg, device=dev)
            check(all(s.stage_ms >= 0 for s in prof),
                  f"profile {kind}: a negative row")
            print(profiling.format_report(prof, H, W), flush=True)
            say(f"tooling_{kind}_profile_ms", shape=list(img.shape),
                rows={s.name: s.stage_ms for s in prof},
                total_ms=prof[-1].total_ms)
        cpu_files = {kind: pool.submit(cpu_path, *made[kind][1:], color)
                     for kind, color in kinds}
        for kind, color in kinds:
            cfg = EncodeConfig(subsampling="420") if color else EncodeConfig()
            img, rgb, small = made.pop(kind)
            src = os.path.join(tmp, f"{kind}.bmp")
            ss = ["--subsampling", kind]
            # --- encode: default, --sharded, --entropy host --------------
            files, launches, secs = {}, {}, {}
            for name, flags in (("default", []), ("sharded", ["--sharded"]),
                                ("entropy_host", ["--entropy", "host"])):
                out = os.path.join(tmp, f"{kind}_{name}.jpg")
                t0 = time.perf_counter()
                launches[name] = run(["encode", src, out, *ss, *flags])
                secs[name] = time.perf_counter() - t0
                files[name] = read(out)
            front = ({"transform_rgb_y": 1, "transform_rgb_chroma": 1,
                      "encode_blocks": 2, "merge_mcu": 1} if color
                     else {"transform": 1, "encode_blocks": 1})
            expect = {
                "default": {**front, "merge_rows": 1, "stream_concat": 1},
                "sharded": {**front, "stitch_scan": 1, "stitch_segments": 1},
                "entropy_host": {k: v for k, v in front.items()
                                 if k.startswith("transform")},
            }
            if on_card:
                for name, want_l in expect.items():
                    got_l = {k: v for k, v in launches[name].items() if v}
                    check(got_l == want_l,
                          f"cli {kind} {name}: launches {got_l} != {want_l}")
            # --- encode-dir: batch and --pipeline 2 ------------------------
            dir_files, dir_launches = {}, {}
            for mode, flags in (("batch", []), ("pipeline2",
                                                ["--pipeline", "2"])):
                outd = os.path.join(tmp, f"out_{kind}_{mode}")
                dir_launches[mode] = run(["encode-dir", os.path.join(
                    tmp, f"in_{kind}"), outd, *ss, *flags])
                dir_files[mode] = [read(os.path.join(outd, f"im{i}.jpeg"))
                                   for i in range(TOOL_DIR_N)]
            if on_card:
                b, p = dir_launches["batch"], dir_launches["pipeline2"]
                n = TOOL_DIR_N
                check(b["stream_concat_rows"] == 1 and b["merge_rows"] == 1
                      and b["encode_blocks"] == 1 + color
                      and b["merge_mcu"] + b["merge_streams"] == int(color),
                      f"encode-dir {kind} batch: launches {b}")
                check(p["stream_concat"] == n and p["merge_rows"] == n
                      and p["encode_blocks"] == n * (1 + color)
                      and p["merge_mcu"] == n * color,
                      f"encode-dir {kind} --pipeline 2: launches {p}")
            # --- the block report and the quality metrics -----------------
            zz = pipeline.grayscale_coefficients(rgb, EncodeConfig(),
                                                 device=dev)
            if not color:
                cfg_int = EncodeConfig(dct_dtype="int32")
                zz_int = pipeline.grayscale_coefficients(img, cfg_int,
                                                         device=dev)
                blocks = (0, 5, zz.shape[0] // 2, zz.shape[0] - 1)
                for c, levels in ((cfg, zz), (cfg_int, zz_int)):
                    for blk in blocks:
                        got = debug.first_block_report(img, c, blk,
                                                       device=dev)
                        cpu = debug.first_block_report(img, c, blk,
                                                       device="cpu")
                        check(all(got[k].dtype == cpu[k].dtype
                                  and np.array_equal(got[k], cpu[k])
                                  for k in cpu),
                              f"block report {c.dct_dtype} {blk}: "
                              "device != cpu")
                        check(np.array_equal(got["zigzag"], levels[blk]),
                              f"block report {c.dct_dtype} {blk}: zigzag "
                              "!= K1's levels")
                say("tooling_block_report", shape=[H, W], blocks=blocks,
                    dct_dtypes=["float32", "int32"], equal_cpu=True,
                    zigzag_equal_k1=True, block0_zigzag=[
                        int(v) for v in zz[0]])
            luma = color_ops.rgb_to_y_reference(torch.from_numpy(rgb)).numpy()
            recon = reconstruct(zz, EncodeConfig().luma_quant, H, W)
            m = {"mse": analysis.mse(luma, recon),
                 "psnr_db": analysis.psnr(luma, recon),
                 "ssim": analysis.ssim(luma, recon)}
            check(np.isfinite(m["psnr_db"]) and m["psnr_db"] > 25
                  and 0 < m["ssim"] <= 1, f"quality {kind}: {m}")
            say(f"tooling_{kind}_quality", shape=[H, W], quality=50,
                of="luma vs its reconstruction from K1's levels", **m)
            # --- the CLI encode's kernels, against plain and timed ---------
            x = torch.from_numpy(img).to(dev)
            entries += chain_entries(f"tooling_cli_{kind}", x, cfg,
                                     launches["default"], say, join="k9")
            del x, small, rgb, img
            # --- every file against the port's CPU path -------------------
            want = cpu_files[kind].result()
            check(files["default"] == want["default"],
                  f"cli {kind}: file != CPU path")
            check(profs[kind].jfif == want["default"],
                  f"profile {kind}: file != CPU path")
            check(files["entropy_host"] == want["default"],
                  f"cli {kind} --entropy host: file != CPU path")
            check(files["sharded"] == want["sharded"],
                  f"cli {kind} --sharded: file != CPU path at interval "
                  f"{want['restart_interval']}")
            for mode, got in dir_files.items():
                check(got == want["dir"],
                      f"cli encode-dir {kind} {mode}: a file != CPU path")
            say(f"tooling_{kind}_cli_encode", shape=[H, W, 3],
                files_equal_cpu_path=sorted(files),
                bytes=len(files["default"]),
                restart_interval_sharded=want["restart_interval"],
                seconds=secs, cpu_path_s=want["s"], launches=launches)
            say(f"tooling_{kind}_cli_encode_dir", images=TOOL_DIR_N,
                shape=[512, 512, 3], files_equal_cpu_path=sorted(dir_files),
                launches=dir_launches)
    finally:
        pool.shutdown(cancel_futures=True)
        shutil.rmtree(tmp, ignore_errors=True)
    return entries


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(card)
    dev = torch.device("cuda")

    t_start = time.perf_counter()

    def say(phase: str, **kv) -> None:
        print(json.dumps({"phase": phase, "card": card, **kv,
                          "at_s": time.perf_counter() - t_start}),
              flush=True)

    # --- 1. build every source anew; no spills in the redesigned ones ---
    t0 = time.perf_counter()
    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
    reports = _build.build_all()
    ptxas = {k: ptxas_lines(v) for k, v in reports.items()}
    occupancy = blocks_per_sm()
    say("build", seconds=time.perf_counter() - t0, ptxas=ptxas,
        blocks_per_sm=occupancy)
    spills = [f"{src}: {ln}" for src in NO_SPILL_SOURCES for ln in ptxas[src]
              if re.search(r"\b[1-9]\d* bytes spill stores", ln)]
    check(not spills, f"spill stores: {spills}")
    check(min(occupancy["transform_kernel"].values()) > 0
          and occupancy["encode_blocks_kernel"] > 0
          and occupancy["pack_blocks_kernel"] > 0
          and min(occupancy["stream_concat_chunked_kernel"].values()) > 0
          and min(occupancy["merge_mcu_kernel"].values()) > 0
          and min(occupancy["merge_rows_kernel"].values()) > 0
          and occupancy["stream_concat_kernel"] > 0,
          f"occupancy query failed: {occupancy}")

    # --- 1b. device launches of one K13, K12, K11, K10, K9, K8, K7, K5 call
    wrapper_launches(say)

    # --- 1c. K1-K5, K7-K10 against their plain versions, edges ---------
    kernel_edge_phases(dev, say)

    # --- 2. each kernel against its plain version, main-path shapes ----
    cfg = EncodeConfig()
    img = make_image(H, W)
    nbh, nbw = H // 8, W // 8
    nb = nbh * nbw
    cap = cfg.capacity_words_per_block
    state = tables.encoder_state(cfg, dev)
    plane = torch.from_numpy(img).to(dev)
    results = {}

    lv = transform.transform(plane, state, int_mode=False)
    results["transform"] = float_close(
        "K1", lv, transform.transform_plain(plane, state, int_mode=False))
    lv_int = transform.transform(plane, state, int_mode=True)
    check(torch.equal(lv_int, transform.transform_plain(plane, state, True)),
          "K1 int32: kernel != plain")

    dcd = dc_differences(lv[0])
    words, bits = pack.encode_blocks(lv, dcd, state.huff, cap)
    words_p, bits_p = pack.encode_blocks_plain(lv, dcd, state.huff, cap)
    check(torch.equal(bits, bits_p) and torch.equal(words, words_p),
          "K4: words/bits differ from plain")
    check(int(bits.max()) <= cap * 32, "K4: main-path image overflowed cap 8")
    results["encode_blocks"] = {"max_abs_err": int(
        np.abs(u32(words) - u32(words_p)).max())}

    segs, seg_bits = concat.merge_rows(words, bits, nbh, nbw)
    segs_p, seg_bits_p = concat.merge_rows_plain(words, bits, nbh, nbw)
    check(torch.equal(segs, segs_p) and torch.equal(seg_bits, seg_bits_p),
          "K8: segments differ from plain")
    results["merge_rows"] = {"max_abs_err": int(
        np.abs(u32(segs) - u32(segs_p)).max())}

    out_words = concat.stream_words(nb, cap)
    results["stream_concat"], k9_spec = k9_check_and_spec(
        "K9", segs, seg_bits, out_words, cfg.pad_ones)
    say("kernels_vs_plain", shape=[H, W], **{k: v for k, v in results.items()})

    # --- 3. end to end through the entry point ---------------------------
    for k in _build.LAUNCHES:
        _build.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    jpg = pipeline.encode_grayscale(img, cfg)
    e2e_first_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    check(all(launches[k] > 0 for k in ("transform", "encode_blocks",
                                        "merge_rows", "stream_concat")),
          f"main path skipped a kernel: {launches}")
    check(jpg[:2] == b"\xff\xd8" and jpg[-2:] == b"\xff\xd9",
          "output is not a JFIF stream")
    # float mode: levels within K1's tolerance of the CPU path; the bytes
    # equal the CPU entropy chain fed the card's levels
    zz_gpu = pipeline.grayscale_coefficients(img, cfg)
    zz_cpu = pipeline.grayscale_coefficients(img, cfg, device="cpu")
    d = np.abs(zz_gpu.astype(np.int64) - zz_cpu)
    check((d > 0).mean() < 1e-4 and d.max() <= 1,
          f"float levels off the CPU path: {(d > 0).mean()}, max {d.max()}")
    cpu_state = tables.encoder_state(cfg, "cpu")
    scan = pipeline.encode_levels(torch.from_numpy(zz_gpu.T.copy()),
                                  cpu_state.huff, nbh, nbw, cfg)
    check(pipeline.jfif.assemble(W, H, cfg, [scan]) == jpg,
          "float: card bytes != CPU entropy chain on the card's levels")
    cfg_int = EncodeConfig(dct_dtype="int32")
    jpg_int = pipeline.encode_grayscale(img, cfg_int)
    check(jpg_int == pipeline.encode_grayscale(img, cfg_int, device="cpu"),
          "int32: card bytes != CPU bytes")
    e2e_s = []
    for _ in range(5):
        t0 = time.perf_counter()
        pipeline.encode_grayscale(img, cfg)
        e2e_s.append(time.perf_counter() - t0)
    e2e_med = float(np.median(e2e_s))
    say("end_to_end", shape=[H, W], quality=cfg.quality, bytes=len(jpg),
        bytes_int32=len(jpg_int), first_call_s=e2e_first_s,
        median_s=e2e_med, mpix_per_s=H * W / 1e6 / e2e_med,
        launches=launches)
    check(native.available(), "native stuffer did not build")
    say("stage_breakdown_ms", shape=[H, W], **profile_rows(img, cfg))

    # --- 4. capacity ladder ----------------------------------------------
    noise = np.random.default_rng(7).integers(
        0, 256, (LADDER_H, LADDER_W), dtype=np.uint8)
    cfg_q100 = EncodeConfig(quality=100, dct_dtype="int32")
    before = _build.LAUNCHES["encode_blocks"]
    jpg_noise = pipeline.encode_grayscale(noise, cfg_q100)
    rungs = _build.LAUNCHES["encode_blocks"] - before
    top = pipeline._cap_history[(LADDER_H // 8, LADDER_W // 8, cfg_q100,
                                 False)][0]
    check(rungs == 3 and top == MAX_WORDS_PER_BLOCK,
          f"ladder: {rungs} K4 launches, settled at cap {top}")
    check(jpg_noise == pipeline.encode_grayscale(noise, cfg_q100,
                                                 device="cpu"),
          "ladder: card bytes != CPU bytes")
    say("capacity_ladder", shape=[LADDER_H, LADDER_W], rungs=rungs,
        cap=top, bytes=len(jpg_noise))

    # --- 5. timings and bounds -------------------------------------------
    seg_words = segs.shape[1]
    valid_block_words = int(((bits.long() + 31) // 32).sum())
    nseg = segs.shape[0]
    kernel_specs = [
        ("transform", "jpegtpu_torch/csrc/transform.cu",
         "jpegtpu/ops/pallas_transform.py:255",
         lambda: transform.transform(plane, state, False),
         lambda: transform.transform_plain(plane, state, False),
         H * W + 64 * nb * 4 + 64 * 4 * 3,
         nb * 2 * 1024),
        ("encode_blocks", "jpegtpu_torch/csrc/pack.cu",
         "jpegtpu/entropy/pallas_pack.py:560",
         lambda: pack.encode_blocks(lv, dcd, state.huff, cap),
         lambda: pack.encode_blocks_plain(lv, dcd, state.huff, cap),
         64 * nb * 4 + nb * 4 + tables.HUFF_SIZE * 4 + cap * nb * 4 + nb * 4,
         64 * nb),
        ("merge_rows", "jpegtpu_torch/csrc/concat.cu",
         "jpegtpu/entropy/pallas_concat.py:240",
         lambda: concat.merge_rows(words, bits, nbh, nbw),
         lambda: concat.merge_rows_plain(words, bits, nbh, nbw),
         valid_block_words * 4 + nb * 4 + nseg * seg_words * 4 + nseg * 4,
         valid_block_words * 2),
        k9_spec,
    ]
    kernels = time_kernels(kernel_specs, launches, results, "gray", [H, W],
                           say)
    say("kernel_time_int32", name="transform", shape=[H, W],
        ms=time_ms(lambda: transform.transform(plane, state, True)))

    kernels += color_phases(dev, say)
    kernels += restart_and_two_pass_phases(dev, say)
    kernels += batch_phases(dev, say)
    kernels += large_frame_phases(dev, say)
    kernels += staged_entropy_phases(dev, say)
    repaired_config_phases(dev, say)
    kernels += batch_k6_phases(dev, say)
    kernels += serving_phases(dev, say)
    kernels += sharded_phases(dev, say)
    kernels += multiprocess_phases(dev, say)
    kernels += batch_mesh_phases(dev, say)
    kernels += on_card_phases(dev, say)
    kernels += tooling_phases(dev, say)

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--worker"]:  # one of multiprocess_phases'
            sys.exit(multiprocess_worker(sys.argv[2], int(sys.argv[3]),
                                         sys.argv[4]))
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
