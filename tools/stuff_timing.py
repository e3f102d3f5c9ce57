"""Host timing of the native stuffer (`jt_words_to_stuffed`, behind
jpegtpu_torch.native.words_to_stuffed) on the scan of one frame of
`video_1080p_420` and of one photo of `photo_420_12mp`, beside the same
source built without SSE2 (its portable 8-byte path alone) and beside
another checkout's bitpack.cpp, in one process.

    python3 tools/stuff_timing.py [--parent DIR] [--seed N] [--reps R]

Each scan is the benchmark reference encoder's (benchmark/reference/
encoder.py) for one image of the configuration (benchmark/content.py,
made on the CPU from the seed), its raw entropy bytes before stuffing
packed as the card hands them back: MSB-first in host-order uint32
words. On an x86-64 host this tree's bitpack.cpp is also built with
`-mno-sse2` (`swar`); DIR's jpegtpu_torch/native/bitpack.cpp (`other`)
with the same g++ command as the package's (its three-argument
jt_words_to_stuffed ignores the null tally passed to it); both into
build/tools/. The libraries run in turns (other, this, swar, swar, this,
other), each output held to the numpy twin (entropy.host.stuff_bytes),
and this tree's builds to the same chunk tally. One JSON line a scan and
library: raw scan
bytes over the median time of the bare C call into a reused buffer
(`c_gb_s`), and of the call as the wrapper makes it, output allocated
and copied into a bytes object (`wrapper_gb_s`); a last line names the
host's CPU. Needs no card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import platform
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmark import content, manifest  # noqa: E402
from benchmark.reference import encoder  # noqa: E402
from jpegtpu_torch import native  # noqa: E402
from jpegtpu_torch.entropy import host  # noqa: E402

CONFIGS = ("video_1080p_420", "photo_420_12mp")


def scan_words(config: str, seed: int):
    """(words uint32, total bits, raw bytes) of the reference scan of one
    image of `config`."""
    cfg = manifest.Bench().config(config)
    image = content.make_pool(cfg["sizes"], 1, seed, "cpu")[0]
    raw = np.packbits(encoder.encode(image, cfg["encode"]).bits)
    padded = np.zeros(-(-raw.size // 4) * 4, np.uint8)
    padded[:raw.size] = raw
    return padded.view(">u4").astype(np.uint32), 8 * raw.size, raw


def load_lib(path: str):
    lib = ctypes.CDLL(path)
    lib.jt_words_to_stuffed.restype = ctypes.c_size_t
    lib.jt_words_to_stuffed.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
    return lib


def build(src: str, name: str, flags=()) -> str:
    out_dir = os.path.join(ROOT, "build", "tools")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, f"libjt_bitpack_{name}.so")
    subprocess.run(["g++", "-O3", "-shared", "-fPIC", *flags, "-o", so, src],
                   check=True)
    return so


def tally(lib, words, total_bits) -> list:
    counts = np.zeros(2, np.int64)
    out = np.empty(total_bits // 4 + 4, np.uint8)
    lib.jt_words_to_stuffed(words.ctypes.data, total_bits, out.ctypes.data,
                            counts.ctypes.data)
    return counts.tolist()


def median_ns(fn, reps: int) -> float:
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter_ns()
        fn()
        times.append(time.perf_counter_ns() - t0)
    return statistics.median(times)


def time_lib(lib, words, total_bits, want: bytes, reps: int) -> dict:
    nbytes = total_bits // 8
    buf = np.empty(2 * nbytes + 4, np.uint8)

    def bare():
        return lib.jt_words_to_stuffed(words.ctypes.data, total_bits,
                                       buf.ctypes.data, None)

    def wrapper():
        out = np.empty(2 * nbytes + 4, np.uint8)
        n = lib.jt_words_to_stuffed(words.ctypes.data, total_bits,
                                    out.ctypes.data, None)
        return out[:n].tobytes()

    if wrapper() != want or buf[:bare()].tobytes() != want:
        raise SystemExit("stuffed bytes differ from the numpy twin")
    c_ns, w_ns = median_ns(bare, reps), median_ns(wrapper, reps)
    return {"c_us": c_ns / 1e3, "c_gb_s": nbytes / c_ns,
            "wrapper_us": w_ns / 1e3, "wrapper_gb_s": nbytes / w_ns}


def cpu_name() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or platform.machine()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="another checkout's root")
    ap.add_argument("--seed", type=int, default=3180000307)
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args()
    if not native.available():
        raise SystemExit("the native runtime did not build")
    libs = {"this": native._load()}
    if platform.machine() in ("x86_64", "AMD64"):
        libs["swar"] = load_lib(build(native._SRC, "swar", ["-mno-sse2"]))
    if args.parent:
        libs["other"] = load_lib(build(os.path.join(
            args.parent, "jpegtpu_torch", "native", "bitpack.cpp"), "other"))
    order = [n for n in ("other", "this", "swar") if n in libs]
    turns = order + order[::-1]
    for config in CONFIGS:
        words, total_bits, raw = scan_words(config, args.seed)
        want = host.stuff_bytes(raw)
        counts = np.zeros(2, np.int64)
        if native.words_to_stuffed(words, total_bits, counts) != want:
            raise SystemExit("stuffed bytes differ from the numpy twin")
        if "swar" in libs and tally(libs["swar"], words, total_bits) != (
                counts.tolist()):
            raise SystemExit("the two builds count other chunks")
        runs = {name: [] for name in libs}
        for name in turns:
            runs[name].append(time_lib(libs[name], words, total_bits, want,
                                       args.reps))
        for name, rows in runs.items():
            print(json.dumps({
                "scan": config, "lib": name, "raw_bytes": int(raw.size),
                "ff_bytes": int((raw == 0xFF).sum()),
                "chunks": int(counts[0]), "chunks_slow": int(counts[1]),
                "reps": args.reps, "turns": rows}), flush=True)
    print(json.dumps({"host_cpu": cpu_name(), "cores": os.cpu_count()}))


if __name__ == "__main__":
    main()
