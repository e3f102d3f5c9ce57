"""Time this tree's K1-K4 (jpegtpu_torch/csrc/transform.cu and pack.cu)
against another checkout's, on one CUDA card, in one process.

    python3 tools/torch_kernel_ab.py --parent DIR [--out FILE]

DIR holds the other checkout (for example `git archive` of the parent
commit, unpacked); its jpegtpu_torch is imported as jpegtpu_torch_parent
and builds its kernels under DIR/build. At the main paths' shapes (3024 x
4032 gray and 4:2:0, gray 2-pass and 4:2:0 restart 2-pass tables, the
1024 x 512 x 512 batches stacked as the batch path stacks them, and 7680 x
4320), each kernel's wrapper of both trees runs on the same inputs: the
outputs must be equal, and the device ms are taken in turns (other, this,
this, other) with chip_smoke.time_ms. K4 at 3024 x 4032 (gray and 4:2:0
at Q50, and seeded noise at Q100, whose dense blocks reach the retry
ladder's rungs) runs at caps 8, 16 and 53, beside a third K4,
tools/k4_warp_per_block.cu (a warp per 8x8 block), built here and held
to the same outputs (turns: other, this, warp, warp, this, other). One
JSON line per kernel and shape, with the card's name and power limit,
and one with each K4's thread blocks an SM (the warp K4's at each cap).
"""
from __future__ import annotations

import argparse
import ctypes
import glob
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from jpegtpu_torch import (EncodeConfig, _build, color_pipeline,  # noqa: E402
                           pipeline, tables)
from jpegtpu_torch.entropy import pack  # noqa: E402
from jpegtpu_torch.entropy.device import (dc_differences,  # noqa: E402
                                          symbol_histograms)
from jpegtpu_torch.ops import transform  # noqa: E402


def load_other(root: str):
    """root/jpegtpu_torch as the package jpegtpu_torch_parent."""
    pkg = os.path.join(root, "jpegtpu_torch")
    spec = importlib.util.spec_from_file_location(
        "jpegtpu_torch_parent", os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return (importlib.import_module("jpegtpu_torch_parent._build"),
            importlib.import_module("jpegtpu_torch_parent.ops.transform"),
            importlib.import_module("jpegtpu_torch_parent.entropy.pack"))


CAPS = (8, 16, 53)
WARP_SRC = os.path.join(ROOT, "tools", "k4_warp_per_block.cu")
WARP_SO = os.path.join(ROOT, "build", "tools", "libk4_warp_per_block.so")


def load_warp_k4():
    """tools/k4_warp_per_block.cu, built with the package's nvcc flags."""
    deps = [WARP_SRC] + sorted(glob.glob(os.path.join(_build.CSRC, "*.cuh")))
    _build.compile_if_stale(WARP_SO, deps,
                            lambda out: _build._nvcc_command(WARP_SRC, out))
    lib = ctypes.CDLL(WARP_SO)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.jt_encode_blocks_warp.argtypes = [P, P, P, I, I, P, P, P]
    lib.jt_encode_blocks_warp_per_sm.argtypes = [I]

    def encode(levels, dc_diff, huff, cap):
        nb = levels.shape[1]
        words = torch.empty((cap, nb), dtype=torch.int32,
                            device=levels.device)
        bits = torch.empty((nb,), dtype=torch.int32, device=levels.device)
        err = lib.jt_encode_blocks_warp(
            levels.data_ptr(), dc_diff.data_ptr(), huff.data_ptr(), nb, cap,
            words.data_ptr(), bits.data_ptr(),
            torch.cuda.current_stream(levels.device).cuda_stream)
        if err:
            raise RuntimeError(f"encode_blocks_warp: cudaError {err}")
        return words, bits

    return encode, lib.jt_encode_blocks_warp_per_sm


def equal(a, b) -> bool:
    if isinstance(a, (tuple, list)):
        return all(equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device available", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()
    out = open(args.out, "w") if args.out else None

    def say(**kv):
        line = json.dumps({**kv, "card": card})
        print(line, flush=True)
        if out:
            out.write(line + "\n")

    t0 = time.perf_counter()
    obuild, otransform, opack = load_other(os.path.abspath(args.parent))
    _build.build_all()
    obuild.build_all()
    warp_k4, warp_per_sm = load_warp_k4()
    say(phase="build", seconds=time.perf_counter() - t0)
    say(phase="blocks_per_sm", threads=128, caps=list(CAPS),
        encode_blocks=_build.query("pack", "encode_blocks_per_sm", ()),
        encode_blocks_warp=[warp_per_sm(c) for c in CAPS])
    dev = torch.device("cuda")

    def ab(kernel, path, other, this):
        same = equal(other(), this())
        t = [cs.time_ms(f) for f in (other, this, this, other)]
        say(kernel=kernel, path=path, equal=bool(same),
            before_ms=[t[0], t[3]], after_ms=[t[1], t[2]])
        if not same:
            raise SystemExit(f"{kernel} {path}: outputs differ")

    def k4(path, pairs, caps=(8,)):
        """pairs: (levels, dc_diff, table) of the path's K4 launches; at
        more than one cap the warp-per-block K4 runs too."""
        for cap in caps:
            def run(enc, cap=cap):
                return lambda: [enc(lv, d, h, cap) for lv, d, h in pairs]
            other, this = run(opack.encode_blocks), run(pack.encode_blocks)
            if len(caps) == 1:
                ab("K4", path, other, this)
                continue
            warp = run(warp_k4)
            want = this()
            same = equal(other(), want) and equal(warp(), want)
            t = [cs.time_ms(f) for f in (other, this, warp, warp, this,
                                         other)]
            say(kernel="K4", path=path, cap=cap, equal=bool(same),
                before_ms=[t[0], t[5]], after_ms=[t[1], t[4]],
                warp_ms=[t[2], t[3]])
            if not same:
                raise SystemExit(f"K4 {path} cap {cap}: outputs differ")

    def gray(path, plane, seg_blocks=0, two_pass=False, quality=50,
             caps=(8,)):
        st = tables.encoder_state(EncodeConfig(quality=quality), dev)
        for im in (False, True) if path == "gray" else (False,):
            ab("K1 int32" if im else "K1", path,
               lambda: otransform.transform(plane, st, im),
               lambda: transform.transform(plane, st, im))
        lv = transform.transform(plane, st, False)
        dcd = dc_differences(lv[0], seg_blocks)
        k4(path, [(lv, dcd, st.huff)], caps)
        if two_pass:
            _, (h,) = pipeline.optimal_tables(symbol_histograms(lv, dcd),
                                              ("lum",), dev)
            k4(f"{path}_2pass", [(lv, dcd, h)])

    def color(path, rgb, nmch, nmcw, seg_mcus=0, restart_2pass=False,
              quality=50, caps=(8,)):
        st = tables.encoder_state(
            EncodeConfig(subsampling="420", quality=quality), dev)
        for im in (False, True) if path == "420" else (False,):
            ab("K2 int32" if im else "K2", path,
               lambda: otransform.transform_rgb_y(rgb, st, im),
               lambda: transform.transform_rgb_y(rgb, st, im))
            ab("K3 int32" if im else "K3", path,
               lambda: otransform.transform_rgb_chroma(rgb, st, im, "420"),
               lambda: transform.transform_rgb_chroma(rgb, st, im, "420"))
        ly = transform.transform_rgb_y(rgb, st, False)
        lc = transform.transform_rgb_chroma(rgb, st, False, "420")
        dy, dc = color_pipeline.color_dc_differences(ly, lc, nmch, nmcw,
                                                     "420", seg_mcus)
        k4(path, [(ly, dy, st.huff), (lc, dc, st.huff_chroma)], caps)
        if restart_2pass:  # one MCU row a segment, its optimal tables
            dy, dc = color_pipeline.color_dc_differences(ly, lc, nmch, nmcw,
                                                         "420", nmcw)
            _, (hl, hc) = pipeline.optimal_tables(
                symbol_histograms(ly, dy, 0) + symbol_histograms(lc, dc, 1),
                ("lum", "chrom"), dev)
            k4(f"{path}_restart_2pass", [(ly, dy, hl), (lc, dc, hc)])

    h, w = cs.H, cs.W
    gray("gray", torch.from_numpy(cs.make_image(h, w)).to(dev),
         two_pass=True, caps=CAPS)
    color("420", torch.from_numpy(cs.make_color_image(h, w)).to(dev),
          h // 16, w // 16, restart_2pass=True, caps=CAPS)
    noise = torch.from_numpy(np.random.default_rng(7).integers(
        0, 256, (h, w, 3), dtype=np.uint8)).to(dev)
    gray("gray_q100_noise", noise[..., 0].contiguous(), quality=100,
         caps=CAPS)
    color("420_q100_noise", noise, h // 16, w // 16, quality=100, caps=CAPS)
    del noise
    n, bh, bw = cs.BATCH_N, cs.BATCH_H, cs.BATCH_W
    x = cs.batch_images_on_card(n, bh, bw, False, seed=42)
    gray("batch_gray", x.reshape(n * bh, bw), (bh // 8) * (bw // 8))
    del x
    x = cs.batch_images_on_card(n, bh, bw, True, seed=42)
    color("batch_420", x.reshape(n * bh, bw, 3), n * bh // 16, bw // 16,
          (bh // 16) * (bw // 16))
    del x
    h, w = cs.BIG_H, cs.BIG_W
    gray("8k_gray", torch.from_numpy(cs.make_image(h, w)).to(dev))
    color("8k_420", torch.from_numpy(cs.make_color_image(h, w)).to(dev),
          h // 16, w // 16)
    say(phase="done", seconds=time.perf_counter() - t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
