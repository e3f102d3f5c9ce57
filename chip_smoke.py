"""Smoke run of the jpegtpu_torch port on one CUDA card.

    python3 chip_smoke.py

Builds the four hand-written kernels from jpegtpu_torch/csrc, holds each
against its plain PyTorch version at the main path's shapes (a 3024 x 4032
grayscale image, the reference's own size), encodes that image end to end
through the port's entry point, checks the bytes against the port's CPU
path, climbs the capacity ladder, and times each kernel beside its bound.
Every timing line carries the card's name and power limit. The line
before the last lists the kernels as JSON; the last line is the JSON
{"ok": true, "device": {...}}. Any failure exits non-zero before it.
Needs one CUDA card; imports nothing of JAX or of jpegtpu.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from jpegtpu_torch import EncodeConfig, _build, native, pipeline, tables
from jpegtpu_torch.entropy import concat, pack
from jpegtpu_torch.entropy.device import MAX_WORDS_PER_BLOCK, dc_differences
from jpegtpu_torch.ops import transform

H, W = 3024, 4032  # 12.19 MPix, the reference's image size
LADDER_H, LADDER_W = 512, 512
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


def u32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32).astype(np.int64)


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
    lv_plain = transform.transform_plain(plane, state, int_mode=False)
    torch.cuda.synchronize()
    diff = (lv - lv_plain).abs()
    frac = float((diff > 0).float().mean())
    check(frac < 1e-4 and int(diff.max()) <= 1,
          f"K1 float: mismatch fraction {frac}, max {int(diff.max())}")
    results["transform"] = {"max_abs_err": int(diff.max()),
                            "mismatch_fraction": frac}
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
    check(all(n > 0 for n in launches.values()),
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
    kernels = []
    for name, src, replaces, kern, plain, nbytes, ops in kernel_specs:
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
            "library_ms": None, "ok": True,
        }
        kernels.append(entry)
        say("kernel_time", shape=[H, W], bound_bytes=nbytes, bound_ops=ops,
            **entry)
    say("kernel_time_int32", name="transform", shape=[H, W],
        ms=time_ms(lambda: transform.transform(plane, state, True)))

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
