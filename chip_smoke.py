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
jpegtpu's slot-major route: K2, K3, K4, a gather, K6, K8, K11.
Every source is built anew; the build line lists each kernel's registers,
spills and shared memory, and the run fails if a kernel of transform.cu
or pack.cu (K1-K4, K7) spills. Right after the build, one torch.profiler
session counts the device kernels of one K12 and one K11 wrapper call
(two and one), and the kernel_edges phase holds K1-K4 against their plain
versions, equal to the last level and word, on tests/kernel_edge_cases.py's
adversarial blocks and ragged grids and on the main paths' images. For
each path
it holds every kernel against its plain PyTorch version at the path's
shapes (K12 also at restart_interval 1, with a ragged last segment, and
on seeded streams at intervals 1, 2, 37 and n with both pads; K8 and K11
also at the top rung, K11 also with the pad left 0, on a 2-image batch
and on the K6 route, where it is timed too), encodes end to end through
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
                           native, pipeline, tables)
from jpegtpu_torch.entropy import concat, device, merge, pack, stitch
from jpegtpu_torch.entropy import host as entropy_host
from jpegtpu_torch.entropy import treepack
from jpegtpu_torch.entropy.device import (MAX_WORDS_PER_BLOCK,
                                          assemble_histograms, dc_differences,
                                          symbol_histograms, y_dc_differences)
from jpegtpu_torch.ops import transform

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "tests"))
from kernel_edge_cases import k4_blocks, transform_image  # noqa: E402

H, W = 3024, 4032  # 12.19 MPix, the reference's image size
LADDER_H, LADDER_W = 512, 512
SIDE_H, SIDE_W = 1024, 1536  # the 4:2:2 and 4:4:4 checks
# the reference's batch configuration (bench.py:354-416): 1024 x 512 x 512
BATCH_N, BATCH_H, BATCH_W = 1024, 512, 512
TOP_N = 128  # images of the top-rung K8 / K11 checks
BIG_H, BIG_W = 4320, 7680  # the 8K frame, 33.2 MPix (bench.py:521-575)
K6_N = 16  # 3024 x 4032 images of the batch K6 phase
K6_RUNG16_N = 64  # 512 x 512 images of its rung-16 check
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
REPS = 20
# sources whose kernels must build without spill stores (K1-K4)
NO_SPILL_SOURCES = ("transform", "pack")
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
    """Thread blocks one SM holds of each transform kind (256 threads) and
    of K4 (128 threads, at any cap): the CUDA runtime's occupancy
    calculator on the built kernels."""
    return {
        "transform_kernel": {
            kind: _build.query("transform", "transform_blocks_per_sm",
                               (ctypes.c_int,), i)
            for i, kind in enumerate(TRANSFORM_KINDS)},
        "encode_blocks_kernel": _build.query("pack", "encode_blocks_per_sm",
                                             ()),
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


def concat_label(nbh: int, nbw: int, c: int) -> str:
    """The stage name of K8 + K9 (or K10, past jpegtpu's resident budget)
    for an nbh x nbw grid of streams of c words."""
    mode = concat.concat_mode(nbh, nbw, c, concat.column_groups(nbw))
    return ("K8_K9_concat_and_tail_pad" if mode == "pallas-resident"
            else "K8_K10_concat_and_tail_pad")


def stage_breakdown(img, cfg, reps: int = 5) -> dict:
    """Host-clock milliseconds of each stage of one main-path encode,
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
        words, bits = pack.encode_blocks(lv, dc_differences(lv[0]),
                                         state.huff, cap)
        t = mark("dc_diff_and_K4_pack", t)
        stream, total = concat.concat_stream(words, bits, nbh, nbw)
        stream, total = concat.apply_tail_padding(stream, total, cfg.pad_ones)
        t = mark(concat_label(nbh, nbw, cap), t)
        ov, total_bits = torch.stack(
            [(bits > cap * 32).any().to(torch.int64), total]).tolist()
        words_np = stream[: (total_bits + 31) // 32].cpu().numpy()
        t = mark("d2h_overflow_total_and_words", t)
        scan = native.words_to_stuffed(words_np.view(np.uint32), total_bits)
        t = mark("host_stuff", t)
        pipeline.jfif.assemble(w, h, cfg, [scan])
        mark("host_assemble", t)
    return {k: float(np.median(v)) for k, v in stages.items()}


def color_stage_breakdown(img, cfg, reps: int = 5) -> dict:
    """Host-clock milliseconds of each stage of one color main-path
    encode, each ended by a synchronize (medians over reps)."""
    stages = {}

    def mark(name, t0):
        torch.cuda.synchronize()
        stages.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
        return time.perf_counter()

    h, w = img.shape[:2]
    nmch, nmcw = h // 16, w // 16
    cap = cfg.capacity_words_per_block
    for _ in range(reps):
        t = time.perf_counter()
        rgb = torch.from_numpy(img).cuda()
        state = tables.encoder_state(cfg, "cuda")
        t = mark("h2d_rgb_and_tables", t)
        ly = transform.transform_rgb_y(rgb, state, False)
        t = mark("K2_transform_rgb_y", t)
        lc = transform.transform_rgb_chroma(rgb, state, False, "420")
        t = mark("K3_transform_rgb_chroma", t)
        dy = y_dc_differences(ly[0].reshape(2 * nmch, 2 * nmcw),
                              "420").reshape(-1)
        dc = dc_differences(lc[0].reshape(2, -1)).reshape(-1)
        t = mark("dc_differences", t)
        wy, by = pack.encode_blocks(ly, dy, state.huff, cap)
        wc, bc = pack.encode_blocks(lc, dc, state.huff_chroma, cap)
        t = mark("K4_pack_x2", t)
        words, bits = merge.merge_mcu(wy, by, wc, bc, nmch, nmcw, "420")
        t = mark("K5_merge_mcu", t)
        stream, total = concat.concat_stream(words, bits, nmch, nmcw)
        stream, total = concat.apply_tail_padding(stream, total, cfg.pad_ones)
        t = mark(concat_label(nmch, nmcw, words.shape[0]), t)
        ov, total_bits = torch.stack(
            [(torch.cat([by, bc]) > cap * 32).any().to(torch.int64),
             total]).tolist()
        words_np = stream[: (total_bits + 31) // 32].cpu().numpy()
        t = mark("d2h_overflow_total_and_words", t)
        scan = native.words_to_stuffed(words_np.view(np.uint32), total_bits)
        t = mark("host_stuff", t)
        pipeline.jfif.assemble(w, h, cfg, [scan])
        mark("host_assemble", t)
    return {k: float(np.median(v)) for k, v in stages.items()}


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


def wrapper_launches(say) -> None:
    """One call each of K12's and K11's wrappers in one torch.profiler
    session (the run's only one): the device kernels each launched, and
    their device microseconds, from key_averages(). K12 runs on 190,512
    seeded streams of 8 words at interval 504 (the 3024 x 4032 gray
    restart grid), K11 on 64 images of the gray batch's 64 row segments
    of 576 words. Fails if the profiler sees device events and they are
    not one K11 launch and two K12 launches; says so if it sees none."""
    from torch.profiler import ProfilerActivity, profile
    words, bits = seeded_streams(8, (H // 8) * (W // 8), 5)
    sw, sb = seeded_streams(576, 64 * 64, 6, np.arange(0, 4000))
    segs = sw.T.contiguous()
    calls = {"stitch_segments": lambda: stitch.stitch_segments(words, bits,
                                                               W // 8),
             "stream_concat_rows": lambda: concat.stream_concat_rows(
                 segs, sb, 64, 64 * 64 * 8)}
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
    owner = {"stitch_segments": ("stitch_scan_kernel",
                                 "stitch_segments_kernel"),
             "stream_concat_rows": ("stream_concat_rows_kernel",
                                    "rows_scan_kernel")}
    mine = {k: w for k in seen for w, tags in owner.items()
            if any(t in k for t in tags)}
    counts = {w: sum(seen[k][0] for k in seen if mine.get(k) == w)
              for w in owner}
    other = sum(c for k, (c, _) in seen.items() if k not in mine)
    say("device_launches", launches=counts, other_device_events=other,
        kernels={k: {"count": c, "device_us": us}
                 for k, (c, us) in seen.items()})
    check(counts == {"stitch_segments": 2, "stream_concat_rows": 1}
          and other == 0,
          f"launches per wrapper call: {counts}, other events {other}")


def kernel_edge_phases(dev, say) -> None:
    """K1-K4 against their plain versions, where every level and word must
    be equal (max_abs_err 0): K4 on tests/kernel_edge_cases.py's
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
    results["merge_mcu"] = equal_streams(
        "K5", (mw, mb),
        merge.merge_mcu_plain(wy, by, wc, bc, nmch, nmcw, "420"))
    segs, seg_bits = concat.merge_rows(mw, mb, nmch, nmcw)
    results["merge_rows"] = equal_streams(
        "K8 (MCU streams)", (segs, seg_bits),
        concat.merge_rows_plain(mw, mb, nmch, nmcw))
    out_words = concat.stream_words(nmcu, mw.shape[0])
    stream, total = concat.stream_concat(segs, seg_bits, out_words)
    stream_p, total_p = concat.stream_concat_plain(segs, seg_bits, out_words)
    check(int(total) == int(total_p), "K9 (MCU streams): totals differ")
    results["stream_concat"] = equal_streams(
        "K9 (MCU streams)", (stream, total.reshape(1)),
        (stream_p, total_p.reshape(1)))
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
        **color_stage_breakdown(img, cfg))

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

    # --- 9. color capacity ladder: K8 past 48 KB of shared memory --------
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
        cap=top, merge_rows_smem_bytes=[(6 * c + 1) * 512
                                        for c in (8, 16, 53)],
        bytes=len(jpg_noise))

    # --- 10. color kernel timings and bounds -----------------------------
    nb = ny + nc
    valid_block_words = int(((torch.cat([by, bc]).long() + 31) // 32).sum())
    valid_mcu_words = int(((mb.long() + 31) // 32).sum())
    valid_seg_words = int(((seg_bits.long() + 31) // 32).sum())
    stream_bytes = (int(total) + 31) // 32 * 4
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
        ("merge_mcu", "jpegtpu_torch/csrc/merge.cu",
         "jpegtpu/entropy/pallas_pack.py:867",
         lambda: merge.merge_mcu(wy, by, wc, bc, nmch, nmcw, "420"),
         lambda: merge.merge_mcu_plain(wy, by, wc, bc, nmch, nmcw, "420"),
         valid_block_words * 4 + nb * 4 + mw.shape[0] * nmcu * 4 + nmcu * 4,
         valid_block_words * 2),
        ("merge_rows", "jpegtpu_torch/csrc/concat.cu",
         "jpegtpu/entropy/pallas_concat.py:240",
         lambda: concat.merge_rows(mw, mb, nmch, nmcw),
         lambda: concat.merge_rows_plain(mw, mb, nmch, nmcw),
         valid_mcu_words * 4 + nmcu * 4 + nseg * seg_words * 4 + nseg * 4,
         valid_mcu_words * 2),
        ("stream_concat", "jpegtpu_torch/csrc/concat.cu",
         "jpegtpu/entropy/pallas_concat.py:337",
         lambda: concat.stream_concat(segs, seg_bits, out_words),
         lambda: concat.stream_concat_plain(segs, seg_bits, out_words),
         valid_seg_words * 4 + nseg * 12 + stream_bytes,
         valid_seg_words * 2),
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
        stream, total = concat.concat_stream(words, bits, nbh, nbw)
        stream, total = concat.apply_tail_padding(stream, total, cfg.pad_ones)
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


def batch_stage_breakdown(images: list, cfg, reps: int = 5) -> dict:
    """Host-clock milliseconds of each stage of one batch encode (one
    group, gray or 4:2:0, first rung; 4:2:0 merges with K5 or, where
    jpegtpu's raw body does not apply, with the slot-major gather and
    K6), each ended by a synchronize (medians over reps)."""
    stages = {}

    def mark(name, t0):
        torch.cuda.synchronize()
        stages.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
        return time.perf_counter()

    n = len(images)
    h, w = images[0].shape[:2]
    color = cfg.n_components == 3
    nbh, nbw = (h // 16, w // 16) if color else (h // 8, w // 8)
    cap = cfg.capacity_words_per_block
    ws = batch.segment_width(nbw)
    for _ in range(reps):
        t = time.perf_counter()
        stack = np.stack(images)
        t = mark("host_stack", t)
        x = torch.from_numpy(stack).cuda()
        state = tables.encoder_state(cfg, "cuda")
        t = mark("h2d_images_and_tables", t)
        if color:
            rgb = x.reshape(n * h, w, 3)
            ly = transform.transform_rgb_y(rgb, state, False)
            lc = transform.transform_rgb_chroma(rgb, state, False, "420")
            t = mark("K2_K3_transform", t)
            dcd = color_pipeline.color_dc_differences(ly, lc, n * nbh, nbw,
                                                      "420", nbh * nbw)
            t = mark("dc_differences", t)
            wy, by = pack.encode_blocks(ly, dcd[0], state.huff, cap)
            wc, bc = pack.encode_blocks(lc, dcd[1], state.huff_chroma, cap)
            t = mark("K4_pack_x2", t)
            if batch.color_raw_ok(h, w, "420", cap):
                words, bits = merge.merge_mcu(wy, by, wc, bc, n * nbh, nbw,
                                              "420")
                over = torch.cat([by, bc]) > cap * 32
                t = mark("K5_merge_mcu", t)
            else:  # jpegtpu's slot-major route
                sm = merge.slot_major_streams(wy, by, wc, bc, n * nbh, nbw,
                                              "420")
                t = mark("slot_major_gather", t)
                words, bits = merge.merge_streams(*sm)
                over = torch.cat([by, bc]) > cap * 32
                t = mark("K6_merge_streams", t)
        else:
            lv = transform.transform(x.reshape(n * h, w), state, False)
            t = mark("K1_transform", t)
            dcd = dc_differences(lv[0], nbh * nbw)
            t = mark("dc_differences", t)
            words, bits = pack.encode_blocks(lv, dcd, state.huff, cap)
            over = bits > cap * 32
            t = mark("K4_pack", t)
        segs, seg_bits = concat.merge_rows(words, bits, n * nbh, nbw, ws)
        t = mark("K8_merge_rows_ws", t)
        streams, totals = concat.stream_concat_rows(
            segs, seg_bits, segs.shape[0] // n, words.shape[0] * nbh * nbw,
            cfg.pad_ones)
        t = mark("K11_stream_concat_rows_scans_and_pad_inside", t)
        head = torch.cat([over.any().to(torch.int64).reshape(1),
                          totals]).tolist()
        t = mark("d2h_overflow_and_totals", t)
        nw = (max(head[1:]) + 31) // 32
        words_np = streams[:, :nw].cpu().numpy().view(np.uint32)
        t = mark("d2h_valid_words", t)
        scans = pipeline.segments_from_streams(words_np, head[1:])
        t = mark("host_stuff_x_images", t)
        for im, scan in zip(images, scans):
            pipeline.jfif.assemble(im.shape[1], im.shape[0], cfg, [scan])
        mark("host_jfif_x_images", t)
    return {k: float(np.median(v)) for k, v in stages.items()}


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
        say("batch_stage_breakdown_ms", path=f"batch_{kind}", shape=shape,
            **batch_stage_breakdown(images, cfg))

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
        entries += time_kernels(specs_t, launches, results, f"batch_{kind}",
                                shape, say)
        del x, words, bits, segs, seg_bits, k11_args, files2
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
    e2e MPix/s, a stage breakdown and K10's and K9's device times; then a
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
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        tile = concat.chunk_tile(segs.shape[0], segs.shape[1],
                                 concat._smem_optin(dev), sms)
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
            tile_segments=tile, tiles=-(-int(segs.shape[0]) // tile),
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
            **(color_stage_breakdown(img, cfg) if color
               else stage_breakdown(img, cfg)))

        # --- 24. K10 and K9 at 8K, device ms and bounds ------------------
        lv = levels(False)
        words, bits, nbh, nbw = streams(lv)
        segs, seg_bits = concat.merge_rows(words, bits, nbh, nbw)
        k10_total = int(concat.stream_concat_chunked(segs, seg_bits,
                                                     out_words)[1])
        valid_seg_words = int(((seg_bits.long() + 31) // 32).sum())
        nbytes = (valid_seg_words * 4 + segs.shape[0] * 12
                  + (k10_total + 31) // 32 * 4)
        spec = ("stream_concat_chunked", "jpegtpu_torch/csrc/concat.cu",
                "jpegtpu/entropy/pallas_concat.py:762",
                lambda: concat.stream_concat_chunked(segs, seg_bits,
                                                     out_words),
                lambda: concat.stream_concat_chunked_plain(
                    segs, seg_bits, out_words, tile),
                nbytes, valid_seg_words * 2)
        entries += time_kernels([spec], launches,
                                {"stream_concat_chunked": result},
                                f"8k_{kind}", list(img.shape), say)
        # K9 and K10 on the same segments, in turns
        turns = [("K9", lambda: concat.stream_concat(segs, seg_bits,
                                                     out_words)),
                 ("K10", lambda: concat.stream_concat_chunked(
                     segs, seg_bits, out_words))]
        times = {}
        for name, fn in turns + turns[::-1]:
            times.setdefault(name, []).append(time_ms(fn))
        say("k9_vs_k10", path=f"8k_{kind}", shape=list(img.shape),
            k9_ms=times["K9"], k10_ms=times["K10"],
            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, tile_segments=tile)
        del x, lv, words, bits, segs, seg_bits
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
    merges with K6; and K6's device time. Returns the kernel entries."""
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
    # K11 on the route's row segments (K8 at ws 128), both pads
    segs6, sb6 = concat.merge_rows(*got, n * nmch, nmcw,
                                   batch.segment_width(nmcw))
    k11_args = (segs6, sb6, segs6.shape[0] // n,
                got[0].shape[0] * nmch * nmcw, True)
    for pad_ones in (False, True):
        args = k11_args[:4] + (pad_ones,)
        results["stream_concat_rows"] = equal_streams(
            f"K11 batch_k6 pad_ones {pad_ones}",
            concat.stream_concat_rows(*args),
            concat.stream_concat_rows_plain(*args))
    del got
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
    say("batch_k6_stage_breakdown_ms", shape=[n, h, w, 3],
        **batch_stage_breakdown(images, cfg))
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
    specs_t = [
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
    del sw, sb, segs6, sb6, k11_args
    torch.cuda.empty_cache()
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
          and occupancy["encode_blocks_kernel"] > 0,
          f"occupancy query failed: {occupancy}")

    # --- 1b. device launches of one K12 and one K11 wrapper call ---------
    wrapper_launches(say)

    # --- 1c. K1-K4 against their plain versions on the edge cases --------
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
    stream, total = concat.stream_concat(segs, seg_bits, out_words)
    stream_p, total_p = concat.stream_concat_plain(segs, seg_bits, out_words)
    check(torch.equal(stream, stream_p) and int(total) == int(total_p),
          "K9: stream differs from plain")
    results["stream_concat"] = {"max_abs_err": int(
        np.abs(u32(stream) - u32(stream_p)).max())}
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
    say("stage_breakdown_ms", shape=[H, W], **stage_breakdown(img, cfg))

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
    valid_seg_words = int(((seg_bits.long() + 31) // 32).sum())
    stream_bytes = (int(total) + 31) // 32 * 4
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
        ("stream_concat", "jpegtpu_torch/csrc/concat.cu",
         "jpegtpu/entropy/pallas_concat.py:337",
         lambda: concat.stream_concat(segs, seg_bits, out_words),
         lambda: concat.stream_concat_plain(segs, seg_bits, out_words),
         valid_seg_words * 4 + nseg * 12 + stream_bytes,
         valid_seg_words * 2),
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

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
