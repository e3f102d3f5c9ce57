"""Smoke run of the jpegtpu_torch port on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written kernels from jpegtpu_torch/csrc and drives both
main paths at the reference's own image size, 3024 x 4032:
  gray   (encode_grayscale, EncodeConfig()): K1, K4, K8, K9;
  color  (encode_color, EncodeConfig(subsampling="420")): K2, K3, K4 with
         both tables, K5, K8, K9.
For each path it holds every kernel against its plain PyTorch version at
the path's shapes, encodes the image end to end through the entry point
(launch counts reset just before and read just after), checks the bytes
against the port's CPU path, climbs the capacity ladder, and times each
kernel beside its bound. The color path also checks 4:2:2 and 4:4:4 at
1024 x 1536. Every timing line carries the card's name and power limit.
The line before the last lists the kernels as JSON, one entry per kernel
and path; the last line is the JSON {"ok": true, "device": {...}}. Any
failure exits non-zero before it. Needs one CUDA card; imports nothing of
JAX or of jpegtpu.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from jpegtpu_torch import (EncodeConfig, _build, color_pipeline, native,
                           pipeline, tables)
from jpegtpu_torch.entropy import concat, merge, pack
from jpegtpu_torch.entropy.device import (MAX_WORDS_PER_BLOCK, dc_differences,
                                          y_dc_differences)
from jpegtpu_torch.ops import transform

H, W = 3024, 4032  # 12.19 MPix, the reference's image size
LADDER_H, LADDER_W = 512, 512
SIDE_H, SIDE_W = 1024, 1536  # the 4:2:2 and 4:4:4 checks
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
REPS = 20
SPIN_CYCLES = 20_000_000  # ~10 ms at the H100's ~1.98 GHz boost clock


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


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
        t = mark("K8_K9_concat_and_tail_pad", t)
        ov, total_bits = torch.stack(
            [(bits > cap * 32).any().to(torch.int64), total]).tolist()
        words_np = stream[: (total_bits + 31) // 32].cpu().numpy()
        t = mark("d2h_overflow_total_and_words", t)
        scan = native.words_to_stuffed(words_np.view(np.uint32), total_bits)
        t = mark("host_stuff", t)
        pipeline.jfif.assemble(w, h, cfg, scan)
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
        t = mark("K8_K9_concat_and_tail_pad", t)
        ov, total_bits = torch.stack(
            [(torch.cat([by, bc]) > cap * 32).any().to(torch.int64),
             total]).tolist()
        words_np = stream[: (total_bits + 31) // 32].cpu().numpy()
        t = mark("d2h_overflow_total_and_words", t)
        scan = native.words_to_stuffed(words_np.view(np.uint32), total_bits)
        t = mark("host_stuff", t)
        pipeline.jfif.assemble(w, h, cfg, scan)
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


def time_kernels(specs, launches: dict, results: dict, path: str, shape,
                 say) -> list:
    """Device ms of each kernel and of its plain version, beside the
    kernel's bound: the larger of its bytes (each input read once, each
    output written once) over the memory rate and its operations over the
    float32 rate."""
    entries = []
    for name, src, replaces, kern, plain, nbytes, ops in specs:
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
    check(pipeline.jfif.assemble(W, H, cfg, scan) == jpg,
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

    def say(phase: str, **kv) -> None:
        print(json.dumps({"phase": phase, "card": card, **kv}), flush=True)

    # --- 1. build -----------------------------------------------------
    t0 = time.perf_counter()
    reports = _build.build_all()
    say("build", seconds=time.perf_counter() - t0,
        ptxas={k: [ln.strip() for ln in v.splitlines()
                   if "registers" in ln or "spill" in ln]
               for k, v in reports.items()})

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
    check(pipeline.jfif.assemble(W, H, cfg, scan) == jpg,
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
