"""Time this tree's K1-K5 and K7-K10 (jpegtpu_torch/csrc/transform.cu,
pack.cu, merge.cu and concat.cu) against another checkout's, on one CUDA
card, in one process.

    python3 tools/torch_kernel_ab.py --parent DIR [--out FILE]
        [--kernels k1-k4,k5,k7,k8,k9,k10]

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
to the same outputs (turns: other, this, warp, warp, this, other).
K5 runs on the 4:2:0 block streams of 3024 x 4032, 7680 x 4320 and the
batch stack at cap 8, and of 3024 x 4032 Q100 noise at caps 16 and 53,
beside tools/k5_word_parallel.cu (a thread a group of output words) and
tools/k5_staged.cu (8 words a block staged, the zeros stored while they
arrive), both built here and held to the same outputs (turns: other,
this, words, words, staged, staged, this, other), with the frame's
stores alone and the word-parallel K5 over its threads an MCU.
K8 runs on the block streams of 3024 x 4032 gray (and of its staged
path's one row), 3024 x 4032 4:2:0 (48-word MCU streams), 8K gray and
4:2:0, the 1024 x 512 x 512 gray and 4:2:0 batch stacks (ws 64 / 32), the
K6 route's 16 x 3024 x 4032 4:2:0 stack (ws 128) and 3024 x 4032 4:2:0
Q100 noise at caps 16 and 53 (96- and 318-word MCU streams), beside
tools/k8_word_parallel.cu (no segment in shared memory, built here and
held to the same outputs; turns: other, this, words, words, this,
other), with the fill floor of each segment buffer (torch.zeros, and a
kernel of 16-byte zero stores alone, and one that reads each segment's
bit counts before it stores the segment as zeros) and K8's byte bound;
at six of the shapes, this K8 built with other constants (words a block
loads a round, short and long streams; words loaded with its count).
K7 runs on the staged path's fused elements of the 3024 x 4032 gray
levels, Q50 and Q100 seeded noise, at caps 8, 16 and 53, beside
tools/k7_staged.cu (its elements staged in shared memory, built here and
held to the same outputs, in the same turns), with the compare-and-reduce
that the parent's wrapper runs after its launch timed alone and K7 built
at other numbers of elements a round trip. K9 runs on K8's segments of
3024 x 4032 gray (and of its staged path's one row), 4:2:0, gray Q100
noise at rung 16 and 4:2:0 Q100 noise at rung 8 (rungs jpegtpu still
joins resident), with the tail padding against the parent's K9 followed
by apply_tail_padding (the paths' join), and without it; then K9 built
at 128-1024 threads a block over grids of 1-12 blocks an SM, beside the
stream's zero-fill alone and K9 on segments with no bits. K10 runs on
K8's segments of the 7680 x 4320 frame, gray and 4:2:0, and of the 3024
x 4032 4:2:0 Q100 noise ladder's chunked rungs (16 and 53), beside
tools/k10_warp_per_segment.cu (a warp per segment, built here and held
to the same outputs, in the same turns as the warp K4), and at 8K with
and without its pad, over a sweep of its thread-block counts, with the
stream's zero-fill alone and K10 on segments with no bits beside it. One
JSON line per kernel and shape, with the card's name and power limit,
and one with each K4's, K5's, K7's, K8's and K10's thread blocks an SM.
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
from jpegtpu_torch import (EncodeConfig, _build, batch,  # noqa: E402
                           color_pipeline, pipeline, tables)
from jpegtpu_torch.entropy import concat, device, merge, pack  # noqa: E402
from jpegtpu_torch.entropy import treepack  # noqa: E402
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
            importlib.import_module("jpegtpu_torch_parent.entropy.pack"),
            importlib.import_module("jpegtpu_torch_parent.entropy.concat"),
            importlib.import_module("jpegtpu_torch_parent.entropy.merge"))


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


K10_WARP_SRC = os.path.join(ROOT, "tools", "k10_warp_per_segment.cu")
K10_WARP_SO = os.path.join(ROOT, "build", "tools",
                           "libk10_warp_per_segment.so")


def load_warp_k10():
    """tools/k10_warp_per_segment.cu, built with the package's nvcc flags:
    (join(segs, seg_bits, out_words, blocks=None) -> (stream, total), its
    thread blocks an SM for nseg segments)."""
    deps = [K10_WARP_SRC] + sorted(glob.glob(os.path.join(_build.CSRC,
                                                          "*.cuh")))
    _build.compile_if_stale(
        K10_WARP_SO, deps,
        lambda out: _build._nvcc_command(K10_WARP_SRC, out))
    lib = ctypes.CDLL(K10_WARP_SO)
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.jt_concat_warp_per_segment.argtypes = [P, P, I, I, I, P, L, P, P]
    lib.jt_concat_warp_per_segment_per_sm.argtypes = [I]

    def join(segs, seg_bits, out_words, blocks=None):
        nseg, sw = segs.shape
        if blocks is None:
            sms = torch.cuda.get_device_properties(
                segs.device).multi_processor_count
            blocks = concat.chunked_blocks(
                out_words,
                sms * lib.jt_concat_warp_per_segment_per_sm(nseg))
        out = torch.empty((out_words,), dtype=torch.int32,
                          device=segs.device)
        total = torch.empty((), dtype=torch.int64, device=segs.device)
        err = lib.jt_concat_warp_per_segment(
            segs.data_ptr(), seg_bits.data_ptr(), nseg, sw, blocks,
            out.data_ptr(), out_words, total.data_ptr(),
            torch.cuda.current_stream(segs.device).cuda_stream)
        if err:
            raise RuntimeError(f"concat_warp_per_segment: cudaError {err}")
        return out, total

    return join, lib.jt_concat_warp_per_segment_per_sm


K7_STAGED_SRC = os.path.join(ROOT, "tools", "k7_staged.cu")
K7_STAGED_SO = os.path.join(ROOT, "build", "tools", "libk7_staged.so")


def load_staged_k7():
    """tools/k7_staged.cu, built with the package's nvcc flags:
    (pack(words_t, bits_t, cap) -> (words, bits, overflow), its thread
    blocks an SM)."""
    deps = [K7_STAGED_SRC] + sorted(glob.glob(os.path.join(_build.CSRC,
                                                           "*.cuh")))
    _build.compile_if_stale(
        K7_STAGED_SO, deps,
        lambda out: _build._nvcc_command(K7_STAGED_SRC, out))
    lib = ctypes.CDLL(K7_STAGED_SO)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.jt_pack_blocks_staged.argtypes = [P, P, I, I, I, P, P, P, P, P]
    sync = torch.zeros((2,), dtype=torch.int32, device="cuda")

    def pack_staged(words_t, bits_t, cap):
        _, e, nb = words_t.shape
        dev = words_t.device
        words = torch.empty((cap, nb), dtype=torch.int32, device=dev)
        bits = torch.empty((nb,), dtype=torch.int32, device=dev)
        flag = torch.empty((), dtype=torch.bool, device=dev)
        err = lib.jt_pack_blocks_staged(
            words_t.data_ptr(), bits_t.data_ptr(), e, nb, cap,
            words.data_ptr(), bits.data_ptr(), flag.data_ptr(),
            sync.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"pack_blocks_staged: cudaError {err}")
        return words, bits, flag

    return pack_staged, lib.jt_pack_blocks_staged_per_sm


K5_STAGED_SRC = os.path.join(ROOT, "tools", "k5_staged.cu")
K5_STAGED_SO = os.path.join(ROOT, "build", "tools", "libk5_staged.so")


def load_staged_k5():
    """tools/k5_staged.cu, built with the package's nvcc flags:
    (merge(wy, by, wc, bc, nmch, nmcw) -> (words, bits) at 4:2:0: the
    first 8 words a block staged, the zeros stored while they arrive; its
    thread blocks an SM; zero(frame, vec4) -> frame: the frame's store
    pattern alone; ptxas's lines)."""
    os.makedirs(os.path.dirname(K5_STAGED_SO), exist_ok=True)
    report = subprocess.run(_build._nvcc_command(K5_STAGED_SRC,
                                                 K5_STAGED_SO),
                            check=True, capture_output=True, text=True)
    ptxas = cs.ptxas_lines(report.stdout + report.stderr)
    lib = ctypes.CDLL(K5_STAGED_SO)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.jt_merge_mcu_staged.argtypes = [P, P, P, P, I, I, I, I, I, P, P, P]
    lib.jt_frame_zero.argtypes = [P, I, I, I, P]

    def merge_staged(wy, by, wc, bc, nmch, nmcw):
        cap, nmcu = wy.shape[0], nmch * nmcw
        dev = wy.device
        out = torch.empty((6 * cap, nmcu), dtype=torch.int32, device=dev)
        bits = torch.empty((nmcu,), dtype=torch.int32, device=dev)
        err = lib.jt_merge_mcu_staged(
            wy.data_ptr(), by.data_ptr(), wc.data_ptr(), bc.data_ptr(), cap,
            nmch, nmcw, 2, 2, out.data_ptr(), bits.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"merge_mcu_staged: cudaError {err}")
        return out, bits

    def zero(frame, vec4):
        err = lib.jt_frame_zero(frame.data_ptr(), frame.shape[0],
                                frame.shape[1], int(vec4),
                                torch.cuda.current_stream(
                                    frame.device).cuda_stream)
        if err:
            raise RuntimeError(f"frame_zero: cudaError {err}")
        return frame

    return merge_staged, lib.jt_merge_mcu_staged_per_sm, zero, ptxas


K5_WORDS_SRC = os.path.join(ROOT, "tools", "k5_word_parallel.cu")
K5_WORDS_SO = os.path.join(ROOT, "build", "tools",
                           "libk5_word_parallel.so")


def k5_word_groups(nmcu: int, words: int, resident_threads: int) -> int:
    """The word-parallel K5's threads an MCU, T: enough that the grid
    fills the card's resident threads once, at most one a word."""
    return max(1, min(words, round(resident_threads / max(nmcu, 1))))


def load_word_parallel_k5():
    """tools/k5_word_parallel.cu, built with the package's nvcc flags:
    merge(wy, by, wc, bc, nmch, nmcw, groups=None) -> (words, bits) at
    4:2:0 (groups None: k5_word_groups for this card)."""
    deps = [K5_WORDS_SRC] + sorted(glob.glob(os.path.join(_build.CSRC,
                                                          "*.cuh")))
    _build.compile_if_stale(
        K5_WORDS_SO, deps, lambda out: _build._nvcc_command(K5_WORDS_SRC,
                                                            out))
    lib = ctypes.CDLL(K5_WORDS_SO)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.jt_merge_mcu_words.argtypes = [P, P, P, P, I, I, I, I, I, I, P, P,
                                       P]
    props = torch.cuda.get_device_properties(0)
    resident = (props.multi_processor_count
                * props.max_threads_per_multi_processor)

    def merge_words(wy, by, wc, bc, nmch, nmcw, groups=None):
        cap, nmcu = wy.shape[0], nmch * nmcw
        if groups is None:
            groups = k5_word_groups(nmcu, 6 * cap, resident)
        dev = wy.device
        out = torch.empty((6 * cap, nmcu), dtype=torch.int32, device=dev)
        bits = torch.empty((nmcu,), dtype=torch.int32, device=dev)
        err = lib.jt_merge_mcu_words(
            wy.data_ptr(), by.data_ptr(), wc.data_ptr(), bc.data_ptr(), cap,
            nmch, nmcw, 2, 2, groups, out.data_ptr(), bits.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"merge_mcu_words: cudaError {err}")
        return out, bits

    return merge_words


def load_k7_group(group: int):
    """This tree's K7 built with kGroup = group from a copy of
    csrc/pack.cu under build/tools/: (pack(words_t, bits_t, cap) ->
    (words, bits, overflow), thread blocks an SM, ptxas's lines for it)."""
    src = os.path.join(ROOT, "build", "tools", f"k7_group{group}.cu")
    so = os.path.join(ROOT, "build", "tools", f"libk7_group{group}.so")
    os.makedirs(os.path.dirname(src), exist_ok=True)
    text = open(os.path.join(_build.CSRC, "pack.cu")).read()
    text = text.replace("constexpr int kGroup = 6;",
                        f"constexpr int kGroup = {group};")
    text = text.replace('#include "cp_async.cuh"',
                        f'#include "{_build.CSRC}/cp_async.cuh"')
    with open(src, "w") as f:
        f.write(text)
    report = subprocess.run(_build._nvcc_command(src, so), check=True,
                            capture_output=True, text=True)
    ptxas = [ln.strip() for ln in (report.stdout + report.stderr).split(
        "\n") if "pack_blocks" in ln or "registers" in ln or "spill" in ln]
    lib = ctypes.CDLL(so)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.jt_pack_blocks.argtypes = [P, P, I, I, I, P, P, P, P, P]
    sync = torch.zeros((2,), dtype=torch.int32, device="cuda")

    def pack_group(words_t, bits_t, cap):
        _, e, nb = words_t.shape
        dev = words_t.device
        words = torch.empty((cap, nb), dtype=torch.int32, device=dev)
        bits = torch.empty((nb,), dtype=torch.int32, device=dev)
        flag = torch.empty((), dtype=torch.bool, device=dev)
        err = lib.jt_pack_blocks(
            words_t.data_ptr(), bits_t.data_ptr(), e, nb, cap,
            words.data_ptr(), bits.data_ptr(), flag.data_ptr(),
            sync.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"pack_blocks group {group}: cudaError {err}")
        return words, bits, flag

    return pack_group, lib.jt_pack_blocks_per_sm(), ptxas[:3]


def k10_blocks(segs, seg_bits, out_words, blocks):
    """This tree's K10 launched with `blocks` thread blocks."""
    out = torch.empty((out_words,), dtype=torch.int32, device=segs.device)
    total = torch.empty((), dtype=torch.int64, device=segs.device)
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    _build.launch(
        "concat", "stream_concat_chunked", (P, P, P, I, I, I, I, P, L, P),
        segs.data_ptr(), seg_bits.data_ptr(), None, segs.shape[0],
        segs.shape[1], blocks, -1, out.data_ptr(), out_words,
        total.data_ptr(), device=segs.device)
    return out, total


def load_k9_threads(threads_list):
    """This tree's K9 built with kK9Threads = each of threads_list from
    copies of csrc/concat.cu under build/tools/ (the nvcc runs in
    parallel): {threads: (join(segs, seg_bits, out_words, blocks) ->
    (stream, total) with the pad of 1s, per_sm(nseg))}."""
    text = open(os.path.join(_build.CSRC, "concat.cu")).read()
    for header in ("bitjoin.cuh", "cp_async.cuh"):
        text = text.replace(f'#include "{header}"',
                            f'#include "{_build.CSRC}/{header}"')
    procs = {}
    for t in threads_list:
        src = os.path.join(ROOT, "build", "tools", f"k9_threads{t}.cu")
        so = os.path.join(ROOT, "build", "tools", f"libk9_threads{t}.so")
        os.makedirs(os.path.dirname(src), exist_ok=True)
        with open(src, "w") as f:
            f.write(text.replace("constexpr int kK9Threads = 512;",
                                 f"constexpr int kK9Threads = {t};"))
        procs[t] = (so, subprocess.Popen(_build._nvcc_command(src, so),
                                         stdout=subprocess.DEVNULL,
                                         stderr=subprocess.PIPE))
    built = {}
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for t, (so, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"K9 at {t} threads: nvcc failed: {err}")
        lib = ctypes.CDLL(so)
        lib.jt_stream_concat.argtypes = [P, P, P, I, I, I, I, P, L, P, P]
        lib.jt_stream_concat_per_sm.argtypes = [I, I]

        def join(segs, seg_bits, out_words, blocks, lib=lib, t=t):
            out = torch.empty((out_words,), dtype=torch.int32,
                              device=segs.device)
            total = torch.empty((), dtype=torch.int64, device=segs.device)
            err = lib.jt_stream_concat(
                segs.data_ptr(), seg_bits.data_ptr(), None, segs.shape[0],
                segs.shape[1], blocks, 1, out.data_ptr(), out_words,
                total.data_ptr(),
                torch.cuda.current_stream(segs.device).cuda_stream)
            if err:
                raise RuntimeError(f"K9 at {t} threads: cudaError {err}")
            return out, total

        built[t] = (join, lib.jt_stream_concat_per_sm)
    return built


K8_WORDS_SRC = os.path.join(ROOT, "tools", "k8_word_parallel.cu")
K8_WORDS_SO = os.path.join(ROOT, "build", "tools",
                           "libk8_word_parallel.so")


def load_word_parallel_k8():
    """tools/k8_word_parallel.cu, built with the package's nvcc flags:
    (merge(words, bits, nbh, nbw, ws) -> (segs, seg_bits), its thread
    blocks an SM (ws, cap), fill(buf) -> buf: 16-byte zero stores alone,
    count_fill(bits, nbh, nbw, ws, segs, seg_bits): the counts read, then
    the segments stored as zeros, ptxas's lines)."""
    os.makedirs(os.path.dirname(K8_WORDS_SO), exist_ok=True)
    report = subprocess.run(_build._nvcc_command(K8_WORDS_SRC, K8_WORDS_SO),
                            check=True, capture_output=True, text=True)
    ptxas = cs.ptxas_lines(report.stdout + report.stderr)
    lib = ctypes.CDLL(K8_WORDS_SO)
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.jt_merge_rows_words.argtypes = [P, P, I, I, I, I, I, P, P, P]
    lib.jt_merge_rows_words_per_sm.argtypes = [I, I]
    lib.jt_fill_zero4.argtypes = [P, L, I, P]
    lib.jt_count_fill.argtypes = [P, I, I, I, I, P, P, P]
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def merge_words(words, bits, nbh, nbw, ws):
        cap, nb = words.shape
        nseg = nbh * -(-nbw // ws)
        segs = torch.empty((nseg, ws * (cap + 1)), dtype=torch.int32,
                           device=words.device)
        seg_bits = torch.empty((nseg,), dtype=torch.int32,
                               device=words.device)
        err = lib.jt_merge_rows_words(
            words.data_ptr(), bits.data_ptr(), nb, cap, nbh, nbw, ws,
            segs.data_ptr(), seg_bits.data_ptr(),
            torch.cuda.current_stream(words.device).cuda_stream)
        if err:
            raise RuntimeError(f"merge_rows_words: cudaError {err}")
        return segs, seg_bits

    def fill(buf):
        err = lib.jt_fill_zero4(buf.data_ptr(), buf.numel(), 8 * sms,
                                torch.cuda.current_stream(
                                    buf.device).cuda_stream)
        if err:
            raise RuntimeError(f"fill_zero4: cudaError {err}")
        return buf

    def count_fill(bits, nbh, nbw, ws, segs, seg_bits):
        err = lib.jt_count_fill(bits.data_ptr(), segs.shape[1] // ws - 1, nbh,
                                nbw, ws, segs.data_ptr(), seg_bits.data_ptr(),
                                torch.cuda.current_stream(
                                    bits.device).cuda_stream)
        if err:
            raise RuntimeError(f"count_fill: cudaError {err}")
        return segs

    return (merge_words, lib.jt_merge_rows_words_per_sm, fill, count_fill,
            ptxas)


# This tree's K8 built with other constants of csrc/concat.cu: {label:
# (constant, value)}; the shipped values are K8_SHIPPED
K8_SHAPES = {"eager0": ("kMergeEager", 0),
             "short8": ("kMergeSpecShort", 8),
             "long4": ("kMergeSpecLong", 4)}
K8_SHIPPED = {"kMergeSpecShort": 4, "kMergeSpecLong": 8, "kMergeLongCap": 32,
              "kMergeEager": 1}


def load_k8_shapes(shapes=K8_SHAPES):
    """This tree's K8 built with each of shapes' constants from copies of
    csrc/concat.cu under build/tools/ (the nvcc runs in parallel):
    {label: merge(words, bits, nbh, nbw, ws) -> (segs, seg_bits)}."""
    text = open(os.path.join(_build.CSRC, "concat.cu")).read()
    for header in ("bitjoin.cuh", "cp_async.cuh"):
        text = text.replace(f'#include "{header}"',
                            f'#include "{_build.CSRC}/{header}"')
    procs = {}
    for label, (name, value) in shapes.items():
        src = os.path.join(ROOT, "build", "tools", f"k8_{label}.cu")
        so = os.path.join(ROOT, "build", "tools", f"libk8_{label}.so")
        os.makedirs(os.path.dirname(src), exist_ok=True)
        old = f"constexpr int {name} = {K8_SHIPPED[name]};"
        if old not in text:
            raise RuntimeError(f"csrc/concat.cu has no {old}")
        with open(src, "w") as f:
            f.write(text.replace(old, f"constexpr int {name} = {value};"))
        procs[label] = (so, subprocess.Popen(
            _build._nvcc_command(src, so), stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE))
    built = {}
    P, I = ctypes.c_void_p, ctypes.c_int
    for label, (so, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"K8 {label}: nvcc failed: {err}")
        lib = ctypes.CDLL(so)
        lib.jt_merge_rows.argtypes = [P, P, I, I, I, I, I, P, P, P]

        def merge(words, bits, nbh, nbw, ws, lib=lib, label=label):
            cap, nb = words.shape
            nseg = nbh * -(-nbw // ws)
            segs = torch.empty((nseg, ws * (cap + 1)), dtype=torch.int32,
                               device=words.device)
            seg_bits = torch.empty((nseg,), dtype=torch.int32,
                                   device=words.device)
            err = lib.jt_merge_rows(
                words.data_ptr(), bits.data_ptr(), nb, cap, nbh, nbw, ws,
                segs.data_ptr(), seg_bits.data_ptr(),
                torch.cuda.current_stream(words.device).cuda_stream)
            if err:
                raise RuntimeError(f"K8 {label}: cudaError {err}")
            return segs, seg_bits

        built[label] = merge
    return built


def equal(a, b) -> bool:
    if isinstance(a, (tuple, list)):
        return all(equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--kernels", default="k1-k4,k5,k7,k8,k9,k10",
                    help="comma-separated groups: k1-k4, k5, k7, k8, k9, "
                         "k10")
    args = ap.parse_args()
    groups = set(args.kernels.split(","))
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
    obuild, otransform, opack, oconcat, omerge = load_other(
        os.path.abspath(args.parent))
    _build.build_all()
    obuild.build_all()
    warp_k4, warp_per_sm = load_warp_k4()
    warp_k10, warp_k10_per_sm = load_warp_k10()
    staged_k7, staged_k7_per_sm = load_staged_k7()
    staged_k5, staged_k5_per_sm, frame_zero, k5_ptxas = load_staged_k5()
    words_k5 = load_word_parallel_k5()
    k9_builds = (load_k9_threads((128, 256, 512, 1024)) if "k9" in groups
                 else {})
    (words_k8, words_k8_per_sm, fill_k8, count_fill_k8,
     k8_ptxas) = load_word_parallel_k8()
    k8_builds = load_k8_shapes() if "k8" in groups else {}
    say(phase="build", seconds=time.perf_counter() - t0)
    say(phase="blocks_per_sm", threads=128, caps=list(CAPS),
        encode_blocks=_build.query("pack", "encode_blocks_per_sm", ()),
        encode_blocks_warp=[warp_per_sm(c) for c in CAPS],
        pack_blocks=_build.query("pack", "pack_blocks_per_sm", ()),
        pack_blocks_staged=staged_k7_per_sm(),
        stream_concat_chunked={n: _build.query(
            "concat", "stream_concat_chunked_per_sm",
            (ctypes.c_int, ctypes.c_int), n, 0) for n in (1080, 4320)},
        k10_warp_per_segment={n: warp_k10_per_sm(n) for n in (1080, 4320)},
        merge_mcu={c: _build.query("merge", "merge_mcu_per_sm",
                                   (ctypes.c_int,), c) for c in CAPS},
        merge_mcu_zeros_first=staged_k5_per_sm(),
        merge_mcu_staged_ptxas=k5_ptxas,
        merge_rows={f"ws{ws}_cap{c}": _build.query(
            "concat", "merge_rows_per_sm", (ctypes.c_int, ctypes.c_int), ws,
            c) for ws, c in cs.K8_WIDTH_CAPS},
        merge_rows_word_parallel={f"ws{ws}_cap{c}": words_k8_per_sm(ws, c)
                                  for ws, c in cs.K8_WIDTH_CAPS},
        merge_rows_word_parallel_ptxas=k8_ptxas)
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

    def three(path, other, this, alt, alt_name, **kv):
        """other, this and another design in turns: other, this, alt,
        alt, this, other; all three outputs equal."""
        want = this()
        same = equal(other(), want) and equal(alt(), want)
        t = [cs.time_ms(f) for f in (other, this, alt, alt, this, other)]
        say(path=path, equal=bool(same), before_ms=[t[0], t[5]],
            after_ms=[t[1], t[4]], **{f"{alt_name}_ms": [t[2], t[3]]},
            **kv)
        if not same:
            raise SystemExit(f"{kv} {path}: outputs differ")

    def k7(path, quality, noise):
        st = tables.encoder_state(EncodeConfig(quality=quality), dev)
        lv = transform.transform(noise, st, False)
        values, lengths = device.symbolize_elements64(lv.T.contiguous())
        words_t, bits_t = treepack._fuse_subslots(values, lengths, 3)
        del values, lengths
        for cap in CAPS:
            three(f"{path}_cap{cap}",
                  lambda cap=cap: opack.pack_blocks(words_t, bits_t, cap),
                  lambda cap=cap: pack.pack_blocks(words_t, bits_t, cap),
                  lambda cap=cap: staged_k7(words_t, bits_t, cap), "staged",
                  kernel="K7")
        want = pack.pack_blocks(words_t, bits_t, 8)
        sweep = {}
        for group in (4, 8, 12):
            fn, per_sm, ptxas = load_k7_group(group)
            if not equal(fn(words_t, bits_t, 8), want):
                raise SystemExit(f"K7 group {group}: outputs differ")
            sweep[group] = {
                "blocks_per_sm": per_sm, "ptxas": ptxas,
                "ms": cs.time_ms(lambda fn=fn: fn(words_t, bits_t, 8))}
        sweep[6] = {"ms": cs.time_ms(lambda: pack.pack_blocks(
            words_t, bits_t, 8))}
        say(kernel="K7 elements a round trip", path=f"{path}_cap8",
            groups=sweep)
        bits = want[1]
        say(kernel="K7 overflow compare and reduce", path=path,
            ms=cs.time_ms(lambda: (bits > 8 * 32).any()))

    def k10(path, segs, seg_bits, out_words):
        three(path, lambda: oconcat.stream_concat_chunked(segs, seg_bits,
                                                           out_words),
              lambda: concat.stream_concat_chunked(segs, seg_bits,
                                                   out_words),
              lambda: warp_k10(segs, seg_bits, out_words), "warp",
              kernel="K10",
              segments=int(segs.shape[0]), segment_words=int(segs.shape[1]),
              stream_words=out_words)

    def k10_8k(color):
        h, w = cs.BIG_H, cs.BIG_W
        st = tables.encoder_state(
            EncodeConfig(subsampling="420") if color else EncodeConfig(), dev)
        if color:
            rgb = torch.from_numpy(cs.make_color_image(h, w)).to(dev)
            ly = transform.transform_rgb_y(rgb, st, False)
            lc = transform.transform_rgb_chroma(rgb, st, False, "420")
            nbh, nbw = h // 16, w // 16
            dcd = color_pipeline.color_dc_differences(ly, lc, nbh, nbw, "420")
            words, bits, _ = color_pipeline.mcu_streams(ly, lc, dcd, st, nbh,
                                                        nbw, "420", 8)
        else:
            lv = transform.transform(
                torch.from_numpy(cs.make_image(h, w)).to(dev), st, False)
            nbh, nbw = h // 8, w // 8
            words, bits = pack.encode_blocks(lv, dc_differences(lv[0]),
                                             st.huff, 8)
        segs, seg_bits = concat.merge_rows(words, bits, nbh, nbw)
        out_words = concat.stream_words(nbh * nbw, words.shape[0])
        path = "8k_420" if color else "8k_gray"
        k10(path, segs, seg_bits, out_words)
        k10_pad(path, segs, seg_bits, out_words)
        resident = concat._chunked_resident(dev, int(segs.shape[0]), False)
        want = concat.stream_concat_chunked(segs, seg_bits, out_words)
        sweep = {}
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        for blocks in sorted({sms, 2 * sms, 4 * sms, resident}):
            got = k10_blocks(segs, seg_bits, out_words, blocks)
            if not equal(got, want):
                raise SystemExit(f"K10 at {blocks} blocks: outputs differ")
            sweep[blocks] = cs.time_ms(
                lambda b=blocks: k10_blocks(segs, seg_bits, out_words, b))
        say(kernel="K10 thread blocks", path=path, resident=resident,
            ms=sweep)
        # its parts: the stream's zero-fill alone, and K10 on segments
        # with no bits (the scan, then zeros only)
        empty = torch.zeros_like(seg_bits)
        say(kernel="K10 parts", path=path, zero_fill_ms=cs.time_ms(
            lambda: torch.zeros((out_words,), dtype=torch.int32,
                                device=dev)),
            no_bits_ms=cs.time_ms(lambda: concat.stream_concat_chunked(
                segs, empty, out_words)))

    def k10_ladder():
        """The 3024 x 4032 4:2:0 Q100 noise ladder's chunked rungs."""
        h, w = cs.H, cs.W
        rgb = torch.from_numpy(np.random.default_rng(7).integers(
            0, 256, (h, w, 3), dtype=np.uint8)).to(dev)
        st = tables.encoder_state(EncodeConfig(
            quality=100, dct_dtype="int32", subsampling="420"), dev)
        ly = transform.transform_rgb_y(rgb, st, True)
        lc = transform.transform_rgb_chroma(rgb, st, True, "420")
        nbh, nbw = h // 16, w // 16
        dcd = color_pipeline.color_dc_differences(ly, lc, nbh, nbw, "420")
        for cap in (16, 53):
            words, bits, _ = color_pipeline.mcu_streams(ly, lc, dcd, st, nbh,
                                                        nbw, "420", cap)
            segs, seg_bits = concat.merge_rows(words, bits, nbh, nbw)
            k10(f"420_q100_noise_cap{cap}", segs, seg_bits,
                concat.stream_words(nbh * nbw, words.shape[0]))

    def turns(kernel, path, other, this, **kv):
        """other and this in turns (other, this, this, other), outputs
        equal."""
        same = equal(other(), this())
        t = [cs.time_ms(f) for f in (other, this, this, other)]
        say(kernel=kernel, path=path, equal=bool(same),
            before_ms=[t[0], t[3]], after_ms=[t[1], t[2]], **kv)
        if not same:
            raise SystemExit(f"{kernel} {path}: outputs differ")

    def k10_pad(path, segs, seg_bits, out_words):
        """K10 with the pad flag: the parent's K10 (no pad) against this
        tree's without and with the pad (the kernel alone: the pad bits
        differ), and the parent's K10 + apply_tail_padding against this
        K10 padding itself (the same stream)."""
        def plain_join():
            return oconcat.stream_concat_chunked(segs, seg_bits, out_words)

        def padded_join():
            return concat.stream_concat_chunked(segs, seg_bits, out_words,
                                                True)
        t = [cs.time_ms(f) for f in (plain_join, padded_join, padded_join,
                                     plain_join)]
        say(kernel="K10 kernel, pad flag", path=path,
            parent_no_pad_ms=[t[0], t[3]], this_pad_ms=[t[1], t[2]])
        turns("K10 + tail padding", path,
              lambda: oconcat.apply_tail_padding(*plain_join(), True),
              padded_join)

    def k9(path, segs, seg_bits, out_words):
        """K9 before / after: the parent's K9 then apply_tail_padding (the
        path's join) against this tree's K9 with the pad; the two without
        the pad; then this K9 over thread-block sizes and grids."""
        turns("K9 + tail padding", path,
              lambda: oconcat.apply_tail_padding(*oconcat.stream_concat(
                  segs, seg_bits, out_words), True),
              lambda: concat.stream_concat(segs, seg_bits, out_words, True),
              segments=int(segs.shape[0]), segment_words=int(segs.shape[1]),
              stream_words=out_words)
        turns("K9", path,
              lambda: oconcat.stream_concat(segs, seg_bits, out_words),
              lambda: concat.stream_concat(segs, seg_bits, out_words))
        want = concat.stream_concat(segs, seg_bits, out_words, True)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        nseg = int(segs.shape[0])
        sweep, resident = {}, {}
        for threads, (join, per_sm) in k9_builds.items():
            resident[threads] = per_sm(nseg, 0) * sms
            grids = {b for b in (sms, 2 * sms, 4 * sms, 8 * sms,
                                 resident[threads], -(-out_words // 1024),
                                 -(-out_words // 2048),
                                 -(-out_words // 4096),
                                 -(-out_words // 8192))
                     if b <= resident[threads]}
            for blocks in sorted(grids):
                if not equal(join(segs, seg_bits, out_words, blocks), want):
                    raise SystemExit(f"K9 {threads} x {blocks}: outputs "
                                     "differ")
                sweep[f"{threads}x{blocks}"] = cs.time_ms(
                    lambda j=join, b=blocks: j(segs, seg_bits, out_words, b))
        say(kernel="K9 launch shapes", path=path, ms=sweep,
            best=min(sweep, key=sweep.get),
            shipped="512x" + str(concat.stream_concat_blocks(
                out_words, concat._k9_blocks(dev, nseg, False))),
            resident=resident)
        say(kernel="K9 parts", path=path, zero_fill_ms=cs.time_ms(
            lambda: torch.zeros((out_words,), dtype=torch.int32,
                                device=dev)),
            no_bits_ms=cs.time_ms(lambda: concat.stream_concat(
                segs, torch.zeros_like(seg_bits), out_words, True)),
            parent_tail_padding_ms=cs.time_ms(
                lambda: oconcat.apply_tail_padding(want[0], want[1], True)))

    def k9_all():
        h, w = cs.H, cs.W
        st = tables.encoder_state(EncodeConfig(), dev)
        lv = transform.transform(
            torch.from_numpy(cs.make_image(h, w)).to(dev), st, False)
        words, bits = pack.encode_blocks(lv, dc_differences(lv[0]), st.huff,
                                         8)
        nbh, nbw = h // 8, w // 8
        segs, seg_bits = concat.merge_rows(words, bits, nbh, nbw)
        k9("gray", segs, seg_bits, concat.stream_words(nbh * nbw, 8))
        # the staged entropy path: one row of 190,512 blocks
        segs, seg_bits = concat.merge_rows(words, bits, 1, nbh * nbw)
        k9("gray_staged_one_row", segs, seg_bits,
           concat.stream_words(nbh * nbw, 8))
        # Q100 noise at rung 16, the last resident gray rung: its blocks
        # fill their 16 words
        assert pipeline.gray_concat_mode(h, w, 16) == "pallas-resident"
        st = tables.encoder_state(EncodeConfig(quality=100), dev)
        lv = transform.transform(torch.from_numpy(
            np.random.default_rng(7).integers(0, 256, (h, w),
                                              dtype=np.uint8)).to(dev),
            st, False)
        words, bits = pack.encode_blocks(lv, dc_differences(lv[0]), st.huff,
                                         16)
        segs, seg_bits = concat.merge_rows(words, bits, nbh, nbw)
        k9("gray_q100_noise_cap16", segs, seg_bits,
           concat.stream_words(nbh * nbw, 16))
        del lv, words, bits
        for quality, tag in ((50, "420"), (100, "420_q100_noise_cap8")):
            st = tables.encoder_state(EncodeConfig(
                subsampling="420", quality=quality), dev)
            img = (cs.make_color_image(h, w) if quality == 50 else
                   np.random.default_rng(7).integers(0, 256, (h, w, 3),
                                                     dtype=np.uint8))
            rgb = torch.from_numpy(img).to(dev)
            ly = transform.transform_rgb_y(rgb, st, False)
            lc = transform.transform_rgb_chroma(rgb, st, False, "420")
            nbh, nbw = h // 16, w // 16
            dcd = color_pipeline.color_dc_differences(ly, lc, nbh, nbw, "420")
            mw, mb, _ = color_pipeline.mcu_streams(ly, lc, dcd, st, nbh, nbw,
                                                   "420", 8)
            assert color_pipeline.color_concat_mode(h, w, "420", 8) == \
                "pallas-resident"
            segs, seg_bits = concat.merge_rows(mw, mb, nbh, nbw)
            k9(tag, segs, seg_bits, concat.stream_words(nbh * nbw,
                                                        mw.shape[0]))

    def k5(path, wy, by, wc, bc, nmch, nmcw, sweep=True):
        """K5 before / after beside the word-parallel and the zeros-first
        designs (turns: other, this, words, words, zeros, zeros, this,
        other), the frame's store pattern alone, and the word-parallel K5
        over its threads an MCU."""
        fns = {"other": lambda: omerge.merge_mcu(wy, by, wc, bc, nmch, nmcw,
                                                 "420"),
               "this": lambda: merge.merge_mcu(wy, by, wc, bc, nmch, nmcw,
                                               "420"),
               "word_parallel": lambda: words_k5(wy, by, wc, bc, nmch, nmcw),
               "zeros_first": lambda: staged_k5(wy, by, wc, bc, nmch,
                                                nmcw)}
        want = fns["this"]()
        same = all(equal(f(), want) for f in fns.values())
        order = ("other", "this", "word_parallel", "word_parallel",
                 "zeros_first", "zeros_first", "this", "other")
        t = [cs.time_ms(fns[k]) for k in order]
        say(kernel="K5", path=path, equal=bool(same), mcus=nmch * nmcw,
            cap=int(wy.shape[0]), before_ms=[t[0], t[7]],
            after_ms=[t[1], t[6]], word_parallel_ms=[t[2], t[3]],
            zeros_first_ms=[t[4], t[5]])
        if not same:
            raise SystemExit(f"K5 {path}: outputs differ")
        if not sweep:
            return
        frame = torch.empty_like(want[0])
        say(kernel="K5 frame stores alone", path=path,
            frame_bytes=frame.numel() * 4,
            torch_zeros_ms=cs.time_ms(lambda: torch.zeros_like(frame)),
            scalar_ms=cs.time_ms(lambda: frame_zero(frame, False)),
            vec4_ms=(cs.time_ms(lambda: frame_zero(frame, True))
                     if frame.shape[1] % 4 == 0 else None))
        ms = {}
        for groups in (1, 2, 3, 4, 6, 8, 12, 48):
            if not equal(words_k5(wy, by, wc, bc, nmch, nmcw, groups), want):
                raise SystemExit(f"K5 groups {groups}: outputs differ")
            ms[groups] = cs.time_ms(
                lambda g=groups: words_k5(wy, by, wc, bc, nmch, nmcw, g))
        say(kernel="K5 word-parallel, threads an MCU", path=path, ms=ms,
            best=min(ms, key=ms.get))

    def k5_streams_of(rgb, nmch, nmcw, seg_mcus=0, quality=50, cap=8):
        st = tables.encoder_state(EncodeConfig(subsampling="420",
                                               quality=quality), dev)
        ly = transform.transform_rgb_y(rgb, st, False)
        lc = transform.transform_rgb_chroma(rgb, st, False, "420")
        dy, dc = color_pipeline.color_dc_differences(ly, lc, nmch, nmcw,
                                                     "420", seg_mcus)
        wy, by = pack.encode_blocks(ly, dy, st.huff, cap)
        wc, bc = pack.encode_blocks(lc, dc, st.huff_chroma, cap)
        return wy, by, wc, bc

    def k5_all():
        for h, w, path in ((cs.H, cs.W, "420"), (cs.BIG_H, cs.BIG_W,
                                                 "8k_420")):
            rgb = torch.from_numpy(cs.make_color_image(h, w)).to(dev)
            k5(path, *k5_streams_of(rgb, h // 16, w // 16), h // 16, w // 16)
        n, bh, bw = cs.BATCH_N, cs.BATCH_H, cs.BATCH_W
        x = cs.batch_images_on_card(n, bh, bw, True, seed=42)
        streams = k5_streams_of(x.reshape(n * bh, bw, 3), n * bh // 16,
                                bw // 16, (bh // 16) * (bw // 16))
        del x
        k5("batch_420", *streams, n * bh // 16, bw // 16)
        del streams
        # the Q100 noise ladder's rungs 16 and 53: blocks past 8 words
        h, w = cs.H, cs.W
        noise = torch.from_numpy(np.random.default_rng(7).integers(
            0, 256, (h, w, 3), dtype=np.uint8)).to(dev)
        for cap in (16, 53):
            k5(f"420_q100_noise_cap{cap}",
               *k5_streams_of(noise, h // 16, w // 16, quality=100, cap=cap),
               h // 16, w // 16, sweep=False)

    def k8(path, words, bits, nbh, nbw, ws=128, sweep=False):
        """K8 before / after beside the word-parallel design (turns: other,
        this, words, words, this, other), outputs equal; the fill floor
        of its segs buffer (torch.zeros and 16-byte stores alone) and its
        byte bound; with sweep, this K8 built with other constants."""
        cap = int(words.shape[0])
        fns = {"other": lambda: oconcat.merge_rows(words, bits, nbh, nbw,
                                                   ws),
               "this": lambda: concat.merge_rows(words, bits, nbh, nbw, ws),
               "words": lambda: words_k8(words, bits, nbh, nbw, ws)}
        want = fns["this"]()
        same = all(equal(f(), want) for f in fns.values())
        order = ("other", "this", "words", "words", "this", "other")
        t = [cs.time_ms(fns[k]) for k in order]
        segs, scratch = want[0], torch.empty_like(want[0])
        scratch_bits = torch.empty_like(want[1])
        valid = int(((bits.long().clamp(max=cap * 32) + 31) // 32).sum())
        nbytes = (valid * 4 + bits.numel() * 4 + segs.numel() * 4
                  + segs.shape[0] * 4)
        say(kernel="K8", path=path, equal=bool(same), ws=ws, cap=cap,
            segments=int(segs.shape[0]), segment_words=int(segs.shape[1]),
            segs_bytes=segs.numel() * 4, before_ms=[t[0], t[5]],
            after_ms=[t[1], t[4]], word_parallel_ms=[t[2], t[3]],
            bound_ms=nbytes / cs.HBM_BYTES_PER_S * 1e3,
            fill_torch_zeros_ms=cs.time_ms(lambda: torch.zeros_like(segs)),
            fill_store_only_ms=cs.time_ms(lambda: fill_k8(scratch)),
            fill_after_counts_ms=cs.time_ms(lambda: count_fill_k8(
                bits, nbh, nbw, ws, scratch, scratch_bits)))
        del scratch, scratch_bits
        if not same:
            raise SystemExit(f"K8 {path}: outputs differ")
        if not sweep:
            return
        ms = {}
        for label, merge_at in k8_builds.items():
            if not equal(merge_at(words, bits, nbh, nbw, ws), want):
                raise SystemExit(f"K8 {path} {label}: outputs differ")
            ms[label] = cs.time_ms(
                lambda m=merge_at: m(words, bits, nbh, nbw, ws))
        ms["shipped"] = cs.time_ms(fns["this"])
        say(kernel="K8 constants", path=path, ms=ms,
            best=min(ms, key=ms.get), shipped=K8_SHIPPED)

    def mcu_stack(rgb, nmch, nmcw, seg_mcus=0, quality=50, cap=8,
                  int_mode=False):
        st = tables.encoder_state(EncodeConfig(subsampling="420",
                                               quality=quality), dev)
        ly = transform.transform_rgb_y(rgb, st, int_mode)
        lc = transform.transform_rgb_chroma(rgb, st, int_mode, "420")
        dcd = color_pipeline.color_dc_differences(ly, lc, nmch, nmcw, "420",
                                                  seg_mcus)
        mw, mb, _ = color_pipeline.mcu_streams(ly, lc, dcd, st, nmch, nmcw,
                                               "420", cap)
        return mw, mb

    def k8_all():
        st = tables.encoder_state(EncodeConfig(), dev)
        for h, w, tag in ((cs.H, cs.W, ""), (cs.BIG_H, cs.BIG_W, "8k_")):
            lv = transform.transform(
                torch.from_numpy(cs.make_image(h, w)).to(dev), st, False)
            words, bits = pack.encode_blocks(lv, dc_differences(lv[0]),
                                             st.huff, 8)
            nbh, nbw = h // 8, w // 8
            k8(f"{tag}gray", words, bits, nbh, nbw, sweep=True)
            if not tag:  # the staged entropy path: one row of blocks
                k8("gray_staged_one_row", words, bits, 1, nbh * nbw)
            rgb = torch.from_numpy(cs.make_color_image(h, w)).to(dev)
            k8(f"{tag}420", *mcu_stack(rgb, h // 16, w // 16), h // 16,
               w // 16, sweep=not tag)
            del lv, words, bits, rgb
        n, bh, bw = cs.BATCH_N, cs.BATCH_H, cs.BATCH_W
        x = cs.batch_images_on_card(n, bh, bw, False, seed=42)
        lv = transform.transform(x.reshape(n * bh, bw), st, False)
        del x
        nbh, nbw = bh // 8, bw // 8
        words, bits = pack.encode_blocks(
            lv, dc_differences(lv[0], nbh * nbw), st.huff, 8)
        del lv
        k8("batch_gray", words, bits, n * nbh, nbw, batch.segment_width(nbw),
           sweep=True)
        del words, bits
        x = cs.batch_images_on_card(n, bh, bw, True, seed=42)
        nbh, nbw = bh // 16, bw // 16
        streams = mcu_stack(x.reshape(n * bh, bw, 3), n * nbh, nbw,
                            nbh * nbw)
        del x
        k8("batch_420", *streams, n * nbh, nbw, batch.segment_width(nbw),
           sweep=True)
        del streams
        # the K6 route's 16 x 3024 x 4032 4:2:0 stack (K6's streams equal
        # K5's, chip_smoke.py batch_k6)
        n, h, w = cs.K6_N, cs.H, cs.W
        x = cs.batch_images_on_card(n, h, w, True, seed=42)
        nmch, nmcw = h // 16, w // 16
        streams = mcu_stack(x.reshape(n * h, w, 3), n * nmch, nmcw,
                            nmch * nmcw)
        del x
        k8("batch_k6_route", *streams, n * nmch, nmcw,
           batch.segment_width(nmcw))
        del streams
        torch.cuda.empty_cache()
        # the Q100 noise ladder's rungs 16 and 53: 96- and 318-word MCUs
        noise = torch.from_numpy(np.random.default_rng(7).integers(
            0, 256, (h, w, 3), dtype=np.uint8)).to(dev)
        for cap in (16, 53):
            k8(f"420_q100_noise_cap{cap}",
               *mcu_stack(noise, nmch, nmcw, quality=100, cap=cap,
                          int_mode=True), nmch, nmcw, sweep=cap == 53)

    if "k8" in groups:
        k8_all()
    if "k5" in groups:
        k5_all()
    if "k9" in groups:
        k9_all()
    if "k7" in groups:
        h, w = cs.H, cs.W
        k7("gray", 50, torch.from_numpy(cs.make_image(h, w)).to(dev))
        k7("gray_q100_noise", 100, torch.from_numpy(
            np.random.default_rng(7).integers(0, 256, (h, w),
                                              dtype=np.uint8)).to(dev))
    if "k10" in groups:
        k10_8k(False)
        k10_8k(True)
        k10_ladder()
    if "k1-k4" not in groups:
        say(phase="done", seconds=time.perf_counter() - t0)
        return 0

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
